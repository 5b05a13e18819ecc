"""The port's halo2 prover against the JAX package, on CPU: ShuffleCircuit at k = 4 (two phases of advice, challenges, a shuffle argument) on seeded tables.

The fixture case ``shuffle``: the port's pinned VK, ``transcript_repr``
and proof bytes from ``keygen`` and ``TorchBackend`` on the
CPU equal the JAX ``HostBackend``'s, and the port's verifier accepts the
proof and refuses it with a byte flipped (see ``test_torch_halo2.py``)."""
import torch

from test_torch_halo2 import check_case, fixture, instances, int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.zk.plonk import halo2

torch.set_num_threads(1)


def test_shuffle_vs_jax():
    pk, proof = check_case("shuffle")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    insts = instances(fixture()["cases"]["shuffle"])
    assert halo2.Halo2Verifier(pk).verify(bytes(bad), insts) is False
