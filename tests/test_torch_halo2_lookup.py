"""The port's halo2 prover against the JAX package, on CPU: SimpleLookupCircuit at k = 5, the halo2 lookup (permuted input and table columns).

The fixture case ``lookup_halo2``: the port's pinned VK, ``transcript_repr``
and proof bytes from ``keygen`` and ``TorchBackend`` on the
CPU equal the JAX ``HostBackend``'s, and the port's verifier accepts the
proof and refuses it with a byte flipped (see ``test_torch_halo2.py``)."""
import torch

from test_torch_halo2 import check_case, fixture, instances, int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.zk.plonk import halo2

torch.set_num_threads(1)


def test_lookup_halo2_vs_jax():
    pk, proof = check_case("lookup_halo2")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    insts = instances(fixture()["cases"]["lookup_halo2"])
    assert halo2.Halo2Verifier(pk).verify(bytes(bad), insts) is False
