"""The port's MLE (``math/mle.py``) and sumcheck (``crypto/sumcheck.py``)
against the JAX package on CPU.

Three tables of 2^4 entries from fixed numpy seeds, over BabyBear and over
Goldilocks, with the SHA-256 sampler of ``tests/test_sumcheck_mle.py``: the
proof (every round's evaluations and the claimed sum), the challenges, the
MLE values at them and ``fix_first_variable`` equal the JAX package's,
recorded in ``tests/fixtures/torch_goldilocks_jax.json`` by
``scripts/make_torch_goldilocks_fixture.py`` (the JAX prover runs op by op;
the slow test recomputes the part).  The comparison is of canonical ints,
which is word for word.  The claimed sum is also a host sum, the proof
verifies, and a claim + 1 or a wrong final value is refused.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu_torch.crypto import sumcheck
from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math import mle
from tachyon_tpu_torch.math.field import PrimeField

torch.set_num_threads(1)
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "make_torch_goldilocks_fixture.py"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_goldilocks_jax.json"


def fixture_script():
    spec = importlib.util.spec_from_file_location("make_torch_goldilocks_fixture", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())["sumcheck"]


@pytest.mark.parametrize("name", ["baby_bear", "goldilocks"])
def test_sumcheck_vs_jax(name, fx):
    mod = fixture_script()
    F = PrimeField(getattr(presets, name.upper()), "cpu")
    p = F.p
    vals = mod.sumcheck_tables(p)
    tabs = [F.encode(v) for v in vals]
    proof, chals = sumcheck.prove(F, tabs, mod.sha_sampler(p))
    want = fx[name]
    assert [list(r) for r in proof.round_evals] == want["round_evals"]
    assert proof.claimed_sum == want["claimed_sum"] == sum(
        a * b * c for a, b, c in zip(*vals)) % p
    assert chals == want["challenges"]
    pts = [F.full((), c) for c in chals]
    finals = [int(F.decode(mle.evaluate(F, t, pts))) for t in tabs]
    assert finals == want["final_evals"]
    assert sumcheck.verify(F, proof, finals, mod.sha_sampler(p))
    bad = sumcheck.SumcheckProof(proof.round_evals, (proof.claimed_sum + 1) % p)
    assert not sumcheck.verify(F, bad, finals, mod.sha_sampler(p))
    assert not sumcheck.verify(F, proof, [finals[0] + 1] + finals[1:], mod.sha_sampler(p))
    fixed = mle.fix_first_variable(F, tabs[0], F.full((), chals[0]))
    assert [int(v) for v in F.decode(fixed)] == want["fix_first"]


@pytest.mark.parametrize("name", ["baby_bear", "goldilocks"])
def test_mle_evaluate_at_boolean_points(name):
    """At a boolean point the MLE is the table's entry (the first variable
    the index's low bit); at r the first fix is lo + r (hi - lo)."""
    F = PrimeField(getattr(presets, name.upper()), "cpu")
    p = F.p
    vals = fixture_script().rand_ints(p, 8, 171)
    t = F.encode(vals)
    assert mle.num_vars(t) == 3
    for idx in (0, 3, 5, 7):
        point = [F.full((), (idx >> b) & 1) for b in range(3)]
        assert int(F.decode(mle.evaluate(F, t, point))) == vals[idx]
    r = 123456789
    got = [int(v) for v in F.decode(mle.fix_first_variable(F, t, F.full((), r)))]
    assert got == [(vals[2 * i] + r * (vals[2 * i + 1] - vals[2 * i])) % p for i in range(4)]
    with pytest.raises(ValueError):
        mle.num_vars(F.encode(vals[:6]))


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed sumcheck part (minutes)."""
    assert fixture_script().record("sumcheck") == fx
