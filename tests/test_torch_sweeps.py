"""K5's segmented schedule, on CPU (BN254 G1, and BLS12-381 G1 for the
kernel's W = 12 instantiation).

On the card K5 cuts each lane's R rows into S segments and runs three
launches (segment totals from the blind D, carries with the complete add,
every row emitted from its segment's carry).  Its plain twin
``suffix_sweep_segmented_plain`` must give, for any S, the points of the
JAX package's ``suffix_sweep_jnp`` in every row and its words in the top
segment.  The lanes hold the cases the carries must take: a segment whose
rows are all at infinity (T = D), the top segment at infinity (the carry
doubles D), equal segment sums (the carry doubles), a ragged top segment.
The blind D is the JAX package's, which the port's draws must equal.
Also here: the point-equality and row-tiling helpers of ``chip_smoke.py`` and K5's segment
count.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import msm as jmsm
from tachyon_tpu.ops import pallas_msm
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import msm as tmsm
from tachyon_tpu_torch.ops import cuda_msm

torch.set_num_threads(1)

C = 4


def rows_to_port(t):
    """(R, L, C) JAX limbs -> (R, W, C) port words."""
    return limbs.from_jax_limbs(t.transpose(1, 0, 2)).permute(1, 0, 2).contiguous()


@functools.lru_cache(maxsize=None)
def sweep_case(R, curve: str = "bn254_g1"):
    """Sweep inputs of R rows x 4 lanes of the JAX package's ``curve`` as
    JAX limbs.  Lane 0: random points and flags; lane 1: one point on every
    row (segments of equal length have equal sums); lanes 2 and 3 are set
    at infinity per S by ``flags``."""
    jc = getattr(jcurves, curve)()
    P, G, F = jc.F.p, (jc.gen_x, jc.gen_y), jc.F
    rng = np.random.default_rng(40 + R)
    pool = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, R * C)]
    for r in range(R):
        pool[r * C + 1] = pool[1]
    x = F.encode(np.array([p[0] for p in pool], dtype=object)).reshape(F.L, R, C)
    y = F.encode(np.array([p[1] for p in pool], dtype=object)).reshape(F.L, R, C)
    x, y = np.ascontiguousarray(x.transpose(1, 0, 2)), np.ascontiguousarray(y.transpose(1, 0, 2))
    inf = (rng.random((R, 1, C)) < 0.25).astype(np.uint32)
    inf[:, 0, 1] = 0
    (d1, _), _ = jmsm._blind_points(jc)
    d = tuple(np.broadcast_to(np.asarray(t)[:, None], (F.L, C)).copy() for t in d1)
    return x, y, inf, d


def flags(inf, R, S):
    """Lane 2: segment 1 all at infinity; lane 3: the top segment."""
    L = -(-R // S)
    inf = inf.copy()
    inf[:, 0, 2:] = 0
    inf[L:2 * L, 0, 2] = 1
    inf[(S - 1) * L:, 0, 3] = 1
    return inf


@pytest.mark.parametrize("curve,R,S", [
    ("bn254_g1", 12, 1), ("bn254_g1", 12, 3), ("bn254_g1", 12, 4), ("bn254_g1", 13, 3),
    ("bn254_g1", 13, 4), ("bls12_381_g1", 5, 3)])
def test_segmented_sweep_equals_jax_as_points(curve, R, S):
    x, y, inf0, d = sweep_case(R, curve)
    inf = flags(inf0, R, S)
    want = pallas_msm.suffix_sweep_jnp(getattr(jcurves, curve)(), jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(inf), tuple(jnp.asarray(t) for t in d))
    want = tuple(rows_to_port(np.asarray(t)) for t in want)
    f = getattr(curves, curve)("cpu").F.spec
    tx, ty = rows_to_port(x), rows_to_port(y)
    tinf = torch.from_numpy(inf.astype(np.int32))
    td = tuple(limbs.from_jax_limbs(t) for t in d)
    got = cuda_msm.suffix_sweep_segmented_plain(f, tx, ty, tinf, td, S)
    seq = cuda_msm.suffix_sweep_plain(f, tx, ty, tinf, td)
    for w, s in zip(want, seq):
        assert torch.equal(w, s)
    same = chip_smoke.same_points(f, tuple(t.permute(1, 0, 2) for t in got),
                                  tuple(t.permute(1, 0, 2) for t in want))
    assert bool(same.all())
    top = (S - 1) * -(-R // S)
    for g, w in zip(got, want):
        assert torch.equal(g[top:], w[top:])
    # below the top segment the words move (same points, other scalings)
    moved = any(not torch.equal(g[:top], w[:top]) for g, w in zip(got, want))
    assert moved == (S > 1)


@pytest.mark.parametrize("curve", ["bn254_g1", "bls12_381_g1"])
def test_blind_points_equal_jax(curve):
    """The MSM's blinds D1, D2 and their negations, as the port draws them,
    are the JAX package's words (the sweeps' raw words compare)."""
    jb = jmsm._blind_points(getattr(jcurves, curve)())
    tb = tmsm._blind_points(getattr(curves, curve)("cpu"))
    for (jd, jnd), (td, tnd) in zip(jb, tb):
        for j, t in zip((*jd, *jnd), (*td, *tnd)):
            np.testing.assert_array_equal(limbs.to_jax_limbs(t), np.asarray(j))


def test_same_points_rejects_tampering_and_infinity():
    tc = curves.bn254_g1("cpu")
    f = tc.F.spec
    g = tc.to_xyzz(tc.generator((3,)))
    lam = tc.F.encode([5, 7, 11])
    l2 = tc.F.mul(lam, lam)
    l3 = tc.F.mul(l2, lam)
    h = (tc.F.mul(g.x, l2), tc.F.mul(g.y, l3), l2, l3)  # the same points, rescaled
    assert chip_smoke.same_points(f, tuple(g), h).tolist() == [True] * 3
    bad = (h[0].clone(), h[1], h[2], h[3])
    bad[0][0, 1] ^= 1
    assert chip_smoke.same_points(f, tuple(g), bad).tolist() == [True, False, True]
    inf = tuple(torch.where(torch.arange(3) == 2, 0, t) for t in h)
    assert chip_smoke.same_points(f, tuple(g), inf).tolist() == [True, True, False]
    assert chip_smoke.same_points(f, inf, inf).tolist() == [True] * 3


@pytest.mark.parametrize("R,C,sms,S", [
    (1024, 4096, 132, 8), (256, 4096, 132, 8), (64, 4096, 132, 4), (64, 512, 132, 4),
    (32, 512, 132, 1), (16, 4096, 132, 1), (1024, 8192, 16, 1), (100, 4096, 132, 5)])
def test_segment_count(R, C, sms, S):
    """S ~ sqrt(R) / 2, with S x C threads at most two blocks of 128 per
    SM, one segment where that gives fewer than 4, and no segment empty."""
    got = cuda_msm.segments(R, C, sms, 128)
    assert got == S
    L = -(-R // got)
    assert (got - 1) * L < R <= got * L


def test_row_tiled_shifts_rows_and_keeps_fixed_lanes():
    """chip_smoke's K5 rows: row r of lane c holds base point (c + r) % 256,
    so a coordinate read from another row or lane shows; lanes below
    ``fixed`` hold one point on every row."""
    bx = torch.arange(2 * 256, dtype=torch.int32).reshape(2, 256)
    by = bx + 1000
    x, y = chip_smoke.row_tiled(bx, by, 5, 300, fixed=4)
    assert x.shape == y.shape == (5, 2, 300)
    r = torch.arange(5)[:, None]
    c = torch.arange(300)[None, :]
    want = torch.where(c < 4, c, (c + r) % 256)
    assert torch.equal(x[:, 0], want.to(torch.int32))
    assert torch.equal(y[:, 1], want.to(torch.int32) + 256 + 1000)
    assert not torch.equal(x[0, :, 4:], x[1, :, 4:])
