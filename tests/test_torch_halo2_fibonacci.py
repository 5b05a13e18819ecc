"""The port's halo2 prover against the JAX package, on CPU: Fibonacci1Circuit at k = 4 (a gate over rotations and copy constraints).

The fixture case ``fibonacci1``: the port's pinned VK, ``transcript_repr``
and proof bytes from ``keygen`` and ``TorchBackend`` on the
CPU equal the JAX ``HostBackend``'s, and the port's verifier accepts the
proof and refuses it with a byte flipped (see ``test_torch_halo2.py``)."""
import torch

from test_torch_halo2 import check_case, fixture, instances, int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.zk.plonk import halo2

torch.set_num_threads(1)


def test_fibonacci1_vs_jax():
    pk, proof = check_case("fibonacci1")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    insts = instances(fixture()["cases"]["fibonacci1"])
    assert halo2.Halo2Verifier(pk).verify(bytes(bad), insts) is False
