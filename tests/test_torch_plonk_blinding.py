"""The port's PLONK prover against the JAX package's with four blinding
rows (``tests/test_plonk_blinding.py``'s circuit at n = 16; the fixture's
``blinding`` case), byte for byte with the JAX prover's draws replayed,
fresh draws give another proof that verifies, and a bad witness on an
active row is refused; on CPU (see ``test_torch_plonk.py``)."""
import torch

from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from test_torch_plonk import check_case, fixture, maker
from tachyon_tpu_torch.zk.plonk import prover as plonk

torch.set_num_threads(1)


def test_blinding_vs_jax():
    case, params, pk, proof = check_case("blinding")
    cs = pk.cs
    assert cs.blinding_factors == 4 and cs.usable_rows(pk.n) == 11
    assert len(fixture()["cases"]["blinding"]["draws"]) > 0
    other = plonk.PlonkProver(params, pk, rng=maker().SeededRandbelow(99)).prove(
        case["advice"], case["instance"])
    assert other != proof
    ver = plonk.PlonkVerifier(params, pk)
    assert ver.verify(other, case["instance"]) is True
    advice = [list(c) for c in case["advice"]]
    advice[2][1] = 31  # a * b != c on an active row
    bad = plonk.PlonkProver(params, pk, rng=maker().SeededRandbelow(5)).prove(
        advice, case["instance"])
    assert ver.verify(bad, case["instance"]) is False
