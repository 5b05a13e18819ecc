"""GLV (``tachyon_tpu_torch/math/glv.py``) against the JAX package on CPU.

The constants (beta, lambda and the short basis) and 50 decompositions,
0, 1 and r - 1 among them, must equal the JAX ``GLV``'s as ints, for
bn254_g1 and secp256k1.  ``msm_glv`` at n = 40 (80 half-scalar points:
the naive path) must give the JAX ``msm_glv``'s affine point, recorded in
``tests/fixtures/torch_glv_jax.json`` by ``scripts/make_torch_glv_fixture.py``
(the JAX ladder scan compiles for about two minutes on a CPU; the slow
test re-records it), and the host's point; at n = 129 (258 points: the
windowed path) the host's point.  Every comparison is exact.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import glv as jglv
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, glv, host_ec
from tachyon_tpu_torch.math.ec import AffinePoint

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "make_torch_glv_fixture.py"


def maker():
    spec = importlib.util.spec_from_file_location("make_torch_glv_fixture", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return json.loads(maker().FIXTURE.read_text())


@pytest.mark.parametrize("name", ["bn254_g1", "secp256k1"])
def test_constants_and_decompositions_vs_jax(name):
    jg = jglv.GLV(getattr(jcurves, name)())
    tg = glv.GLV(getattr(curves, name)("cpu"))
    assert (tg.beta, tg.lam, tg.v1, tg.v2, tg.r) == (jg.beta, jg.lam, jg.v1, jg.v2, jg.r)
    r = tg.r
    rng = np.random.default_rng(63)
    ks = [0, 1, r - 1] + [int.from_bytes(rng.bytes(40), "little") % r for _ in range(47)]
    want = [jg.decompose(k) for k in ks]
    assert [tg.decompose(k) for k in ks] == want
    k1, k2 = tg.decompose_all(ks)
    assert list(zip(k1.tolist(), k2.tolist())) == want
    half = (tg.curve.SF.spec.bits + 1) // 2 + 2
    assert all(abs(a) >> half == 0 and abs(b) >> half == 0 for a, b in want)


def secp_points(ks):
    """The points [k] G of secp256k1 as the port's CPU inputs and host ints."""
    tc = curves.secp256k1("cpu")
    G, P = (int(tc.gen_x), int(tc.gen_y)), tc.F.p
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in ks]
    return tc, pts, AffinePoint(tc.F.encode([p[0] for p in pts]), tc.F.encode([p[1] for p in pts]),
                                torch.zeros(len(pts), dtype=torch.bool))


def affine(tc, p):
    aff = tc.to_affine(p)
    return None if bool(aff.inf) else (int(tc.F.decode(aff.x)), int(tc.F.decode(aff.y)))


def test_msm_glv_vs_jax(fx):
    """n = 40 on the fixture's inputs: the JAX msm_glv's point and the host's."""
    g = fx["glv"]
    tc, pts, points = secp_points(g["point_ks"])
    scalars = [int(s, 16) for s in g["scalars"]]
    got = affine(tc, glv.msm_glv(tc, points, scalars))
    assert got == tuple(int(v, 16) for v in g["point"])
    assert got == host_ec.msm(pts, scalars, 0, tc.F.p)


def test_msm_glv_windowed_vs_host():
    """n = 129: 258 points of 130-bit half scalars on the windowed path,
    some negated; equal to the host's MSM of the full scalars."""
    rng = np.random.default_rng(64)
    tc, pts, points = secp_points(rng.integers(1, 1 << 30, 129))
    r = tc.SF.p
    scalars = [r - 1] + [int.from_bytes(rng.bytes(40), "little") % r for _ in range(128)]
    allp, words, half_bits = glv.glv_inputs(tc, points, scalars)
    assert half_bits == 130 and tuple(words.shape) == (5, 258) and allp.x.shape == (8, 258)
    k1, k2 = glv.GLV(tc).decompose_all(scalars)
    assert limbs.words_to_ints(words.numpy().view(np.uint32)) == \
        [abs(int(v)) for v in np.concatenate([k1, k2])]
    assert affine(tc, glv.msm_glv(tc, points, scalars)) == host_ec.msm(pts, scalars, 0, tc.F.p)


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed fixture (minutes)."""
    assert maker().record() == fx
