"""The port's BN254 G2 (generic point ops over Fq2, no point kernel) on CPU.

The generic complete dbl / add / mixed add (``SWCurve._dbl/_add/
_madd_xyzz_generic``) are held against the JAX package's
``_dbl/_add/_madd_xyzz_jnp`` on ``bn254_g2``, with P = Q, P = -Q and
infinity lanes: the JAX G2 ops take over a minute eagerly on a CPU, so
``scripts/make_torch_groth16_fixture.py`` records their outputs in
``tests/fixtures/torch_groth16_jax.json`` (its slow test in
``test_torch_groth16.py`` recomputes them).  ``to_affine``, ``scalar_mul``
and the G2 MSM (the naive path, and the sweep path at an n that is not a
multiple of the 512 lanes) are held against exact host ints.  Every
comparison is exact (canonical values, so equal ints are equal words).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ, SWCurve
from tachyon_tpu_torch.math.msm import MSM_NAIVE_THRESHOLD, msm

torch.set_num_threads(1)

P, R = pairing.P, pairing.R
f2 = pairing
REPO = Path(__file__).resolve().parent.parent


def maker():
    """scripts/make_torch_groth16_fixture.py as a module (its JAX imports
    are inside its recorders)."""
    path = REPO / "scripts" / "make_torch_groth16_fixture.py"
    mod_spec = importlib.util.spec_from_file_location("make_torch_groth16_fixture", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def g2():
    return curves.bn254_g2("cpu")


def gen(g2):
    return (tuple(g2.gen_x), tuple(g2.gen_y))


def multiples(g2, ks):
    return [host_ec.g2_mul(gen(g2), int(k)) for k in ks]


def coords(F, vals):
    """A list of Fq2 int pairs -> port coordinates (2, 8, n)."""
    return F.encode([np.array([v[d] for v in vals], dtype=object) for d in range(2)])


def encode_xyzz(F, lanes):
    return PointXYZZ(*(coords(F, [ln[k] for ln in lanes]) for k in range(4)))


def encode_affine(F, pts):
    zero = (0, 0)
    return AffinePoint(coords(F, [zero if p is None else p[0] for p in pts]),
                       coords(F, [zero if p is None else p[1] for p in pts]),
                       torch.tensor([p is None for p in pts]))


def lane_ints(F, pt):
    """XYZZ coordinates -> [coordinate][lane] hex pairs, the fixture's form."""
    return [[[hex(int(v)) for v in c] for c in zip(*F.decode(t))] for t in pt]


def host_affine(g2, aff):
    xs, ys = g2.F.decode(aff.x), g2.F.decode(aff.y)
    return [None if bool(aff.inf[k]) else ((int(xs[0][k]), int(xs[1][k])),
                                           (int(ys[0][k]), int(ys[1][k])))
            for k in range(aff.inf.shape[0])]


def test_kernel_gate(g2):
    """G2 takes the generic methods, G1 the kernels (the JAX _pallas_ok);
    a = [0, 0] is zero, a != 0 raises."""
    assert g2._kernel_ok is False
    assert curves.bn254_g1("cpu")._kernel_ok is True
    with pytest.raises(NotImplementedError):
        SWCurve("a1", g2.F, [1, 0], g2.b_int, g2.gen_x, g2.gen_y, g2.SF)


def test_generic_group_law_vs_jax(g2):
    """dbl, add and madd on the recorded lanes equal the JAX package's."""
    fx = json.loads((REPO / "tests" / "fixtures" / "torch_groth16_jax.json").read_text())
    want = fx["g2_group_law"]
    ps, qs, qa = maker().g2_lanes()
    p, q = encode_xyzz(g2.F, ps), encode_xyzz(g2.F, qs)
    assert lane_ints(g2.F, g2.dbl_xyzz(p)) == want["dbl"]
    added = g2.add_xyzz(p, q)
    assert lane_ints(g2.F, added) == want["add"]
    assert lane_ints(g2.F, g2.madd_xyzz(p, encode_affine(g2.F, qa))) == want["madd"]
    # P + (-P) and inf + inf are infinity (zz = 0)
    assert g2.F.is_zero(added.zz).tolist() == [False, False, True, False, False, True] * 2


def test_to_affine_on_curve(g2):
    ps, _, _ = maker().g2_lanes()
    aff = g2.to_affine(encode_xyzz(g2.F, ps))
    want = []
    for x, y, zz, zzz in ps:
        want.append(None if zz == (0, 0) else
                    (f2.f2_mul(x, f2.f2_inv(zz)), f2.f2_mul(y, f2.f2_inv(zzz))))
    assert host_affine(g2, aff) == want
    assert bool(g2.is_on_curve(aff).all())
    assert bool(g2.is_on_curve(g2.generator((3,))).all())
    bad = AffinePoint(aff.x, g2.F.add(aff.y, g2.F.ones((12,))), aff.inf)
    assert g2.is_on_curve(bad).tolist() == [p is None for p in want]
    assert tuple(g2.infinity_xyzz((5,)).zz.shape) == (2, 8, 5)
    assert bool(g2.infinity_affine((2,)).inf.all())


def test_scalar_mul_vs_host(g2):
    """scalar_mul over Fq2 lanes: scalars 0, 1, r - 1 and random, P at
    infinity on one lane."""
    rng = np.random.default_rng(13)
    pts = multiples(g2, rng.integers(1, 1 << 30, 5)) + [None]
    ks = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range(3)]
    ta = encode_affine(g2.F, pts)
    got = host_affine(g2, g2.to_affine(g2.scalar_mul(ta, limbs.from_ints(ks, 8))))
    assert got == [None if p is None else host_ec.g2_mul(p, k) for p, k in zip(pts, ks)]


def tiled_msm(g2, n, bits, rng):
    """n points [k_(i mod 8)] G2 (every 17th at infinity) and n scalars
    below 2^bits; the host sum is one g2_mul of sum_i k s_i."""
    ks = [int(k) for k in rng.integers(1, 1 << 30, 8)]
    base = multiples(g2, ks)
    pts = [None if i % 17 == 5 else base[i % 8] for i in range(n)]
    sc = [int.from_bytes(rng.bytes(40), "little") % (1 << bits) % R for _ in range(n)]
    sc[1] = sc[2]  # a repeated scalar
    want = host_ec.g2_mul(gen(g2), sum(ks[i % 8] * s for i, s in enumerate(sc)
                                       if pts[i] is not None) % R)
    return encode_affine(g2.F, pts), limbs.from_ints(sc, 8), want


def msm_point(g2, acc):
    aff = g2.to_affine(PointXYZZ(*(t[..., None] for t in acc)))
    return host_affine(g2, aff)[0]


def test_msm_naive_vs_host(g2):
    rng = np.random.default_rng(14)
    pts, sc, want = tiled_msm(g2, 7, 254, rng)
    assert msm_point(g2, msm(g2, pts, sc)) == want


def test_msm_sweep_path_vs_host(g2):
    """n = 200 > MSM_NAIVE_THRESHOLD, 256 lanes (the generic path's power
    of two at or above n) of which 56 are pad lanes at infinity; 128-bit
    scalars over 13 windows of c = 10."""
    n = 200
    assert n > MSM_NAIVE_THRESHOLD and n % 512
    rng = np.random.default_rng(15)
    pts, sc, want = tiled_msm(g2, n, 128, rng)
    assert msm_point(g2, msm(g2, pts, sc, total_bits=128)) == want
