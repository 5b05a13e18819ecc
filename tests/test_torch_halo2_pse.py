"""The port's halo2 prover with the PSE vendor (``vendor="pse"``: the
quotient's coset at zeta^2, ``halo2.halo2_zeta`` and ``TorchBackend``'s
coset) on CPU, against the JAX package's recorded Scroll proofs.

h(X) = C(X) / (X^n - 1) is a polynomial identity, so evaluating the
quotient on the PSE coset instead of the Scroll one gives the same h and
the same proof bytes on the same circuit and randomness: the pin of the
JAX ``tests/test_halo2_pse.py::test_pse_matches_scroll_proof_bytes``.  For
the fixture's SHPlonk and GWC cases of ``SimpleCircuit`` at k = 4
(``tests/fixtures/torch_halo2_jax.json``, the JAX HostBackend's Scroll
proofs) the port's PSE key proves on ``TorchBackend`` to the recorded
bytes, its verifier accepts the proof, and refuses it with a byte flipped.
One case a file, as the other halo2 files (a proof takes 20-30 s on one
core): SHPlonk here, GWC in ``test_torch_halo2_pse_gwc.py``.
"""
import torch

from test_torch_halo2 import fixture, instances, int_field_ops, maker  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.zk.plonk import circuits, halo2
from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

torch.set_num_threads(1)


def check_pse_case(name: str):
    case = fixture()["cases"][name]
    cs_ = maker().build(circuits, case)
    pk = halo2.keygen(cs_[0], case["k"], device="cpu", vendor="pse", **case["keygen"])
    assert pk.vendor == "pse" and pk.pcs == case["keygen"].get("pcs", "shplonk")
    assert halo2.halo2_zeta("pse") == halo2.halo2_zeta() ** 2 % halo2.FR
    proof = halo2.Halo2Prover(pk, backend=TorchBackend(pk, "cpu")).create_proof(
        cs_, instances(case)).proof
    assert proof.hex() == case["proof"]
    ver = halo2.Halo2Verifier(pk)
    assert ver.verify(proof, instances(case)) is True
    for i in (len(proof) // 3, len(proof) - 1):
        bad = bytearray(proof)
        bad[i] ^= 1
        assert ver.verify(bytes(bad), instances(case)) is False


def test_pse_shplonk_equals_scroll_bytes_and_verifies():
    check_pse_case("simple_shplonk")
