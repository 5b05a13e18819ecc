"""The port's sparse polynomials (``math/sparse.py``) against the JAX package.

``tests/fixtures/torch_math_jax.json`` holds ``tachyon_tpu.math.sparse``'s
outputs on the inputs of ``scripts/make_torch_math_fixture.py``'s
``sparse_inputs`` (a BabyBear univariate of 12 terms up to degree 2^40 + 3
at 4 points; +, - and * of two with shared and cancelling degrees;
``to_dense``; a multivariate; a LinearCombination of three Goldilocks MLEs
of 5 variables): the JAX ladders compile for seconds each on a CPU.  Every
port result must equal them word for word, and the degrees and term
dicts exactly.  The slow test re-records the group from the JAX package.
"""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu.fields import presets as jax_presets
from tachyon_tpu.math.field import PrimeField as JaxField
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.math import mle
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.math.sparse import LinearCombination, SparseMultivariate, SparseUnivariate

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_math_jax.json"


@lru_cache(maxsize=None)
def maker():
    path = ROOT / "scripts" / "make_torch_math_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_math_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())["sparse"]


def jax_words(d: dict) -> torch.Tensor:
    """A recorded JAX limb array -> the port's words."""
    return limbs.from_jax_limbs(maker().unhexed(d))


F = PrimeField(presets.BABY_BEAR, "cpu")
G = PrimeField(presets.GOLDILOCKS, "cpu")


def enc1(f, v):
    return f.encode(np.array([v % f.p], dtype=object))[:, 0]


def test_univariate_coefficients_and_evaluate():
    x, fx = maker().sparse_inputs(), fixture()
    sp = SparseUnivariate.from_dict(F, x["uni"])
    assert torch.equal(sp.coeffs, jax_words(fx["uni_coeffs"]))
    # the JAX encode gives the same words without the ladder
    jf = JaxField(jax_presets.BABY_BEAR)
    degs = sorted(x["uni"])
    assert torch.equal(sp.coeffs, limbs.from_jax_limbs(np.asarray(
        jf.encode(np.array([x["uni"][d] for d in degs], dtype=object)))))
    for z, want in zip(x["points"], fx["uni_eval"]):
        assert torch.equal(sp.evaluate(enc1(F, z)), jax_words(want))
        assert int(F.decode(sp.evaluate(enc1(F, z)))) == \
            sum(c * pow(z, d, F.p) for d, c in x["uni"].items()) % F.p
    # a batch of points at once: each lane is the single point's value
    zs = F.encode(np.array(x["points"], dtype=object))
    batch = sp.evaluate(zs)
    for i, want in enumerate(fx["uni_eval"]):
        assert torch.equal(batch[:, i], jax_words(want))


def test_univariate_merge_mul_dense():
    x, fx = maker().sparse_inputs(), fixture()
    a = SparseUnivariate.from_dict(F, x["ta"])
    b = SparseUnivariate.from_dict(F, x["tb"])
    for name, r in (("add", a + b), ("sub", a - b), ("mul", a * b)):
        assert r.degrees == fx[name]["degrees"], name
        assert torch.equal(r.coeffs, jax_words(fx[name]["coeffs"])), name
        assert {str(d): c for d, c in r.to_dict().items()} == fx[name]["dict"], name
    assert torch.equal(a.to_dense(48), jax_words(fx["dense"]))


def test_multivariate_evaluate():
    x, fx = maker().sparse_inputs(), fixture()
    m = SparseMultivariate.from_terms(F, x["multi"])
    got = m.evaluate([enc1(F, v) for v in x["multi_point"]])
    assert torch.equal(got, jax_words(fx["multi_eval"]))


def test_linear_combination_combine_and_evaluate():
    x, fx = maker().sparse_inputs(), fixture()
    lc = LinearCombination(G, maker().LC_VARS)
    tables = [G.encode(np.array(t, dtype=object)) for t in x["tables"]]
    for t in tables:
        lc.add_mle(t)
    for c, idx in x["lc_terms"]:
        lc.add_term(c, idx)
    pt = [enc1(G, v) for v in x["lc_point"]]
    assert torch.equal(lc.combine(), jax_words(fx["lc_combine"]))
    assert torch.equal(lc.evaluate(pt), jax_words(fx["lc_evaluate"]))
    # the claim is the sum of the combined table; the evaluation is the
    # terms of the MLEs' values at the point
    combined = G.zeros((1 << lc.nv,))
    vals = [int(G.decode(mle.evaluate(G, t, pt))) for t in tables]
    want = 0
    for c, idx in x["lc_terms"]:
        prod = G.full((1 << lc.nv,), c)
        term = c
        for i in idx:
            prod = G.mul(prod, tables[i])
            term = term * vals[i] % G.p
        combined = G.add(combined, prod)
        want = (want + term) % G.p
    assert torch.equal(lc.combine(), G.sum(combined))
    assert int(G.decode(lc.evaluate(pt))) == want
    with pytest.raises(ValueError, match="variables"):
        lc.add_mle(G.zeros((8,)))


@pytest.mark.slow
def test_fixture_recomputed_from_jax():
    """The JAX package, run again, gives the committed group (about a minute)."""
    assert maker().record(("sparse",))["sparse"] == fixture()
