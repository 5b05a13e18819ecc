"""The port's halo2 prover against the JAX package, on CPU: SimpleLookupCircuit at k = 5, the log-derivative lookup (the reference's log_derivative_halo2: multiplicities and a running sum).

The fixture case ``lookup_log_derivative``: the port's pinned VK, ``transcript_repr``
and proof bytes from ``keygen`` and ``TorchBackend`` on the
CPU equal the JAX ``HostBackend``'s, and the port's verifier accepts the
proof and refuses it with a byte flipped (see ``test_torch_halo2.py``)."""
import torch

from test_torch_halo2 import check_case, fixture, instances, int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.zk.plonk import halo2

torch.set_num_threads(1)


def test_lookup_log_derivative_vs_jax():
    pk, proof = check_case("lookup_log_derivative")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    insts = instances(fixture()["cases"]["lookup_log_derivative"])
    assert halo2.Halo2Verifier(pk).verify(bytes(bad), insts) is False
