"""K6's segmented schedule, on CPU (BN254 G1, and BLS12-381 G1 for the
kernel's W = 12 instantiation).

On the card K6 cuts each lane's R rows into S segments: phase 1 sums a
segment from the blind D, T[s] = D + partial; phase 2 adds a lane's
partials, (T[a] + T[b]) + (-D), in a tree (or, with one thread per lane, a
chain) of complete adds.  Its plain twin ``reduce_sweep_segmented_plain``
must give the point of the JAX package's ``reduce_sweep_jnp`` for any S,
and its words at S = 1.  The lanes hold the cases the complete add must
take: a segment whose rows are all at infinity (T = D) and two segments
with equal sums (the combine doubles).  Also here: K6's segment count.
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
from tachyon_tpu_torch.ops import cuda_msm

torch.set_num_threads(1)

C = 4


def rows_to_port(t):
    """(R, L, C) JAX limbs -> (R, W, C) port words."""
    return limbs.from_jax_limbs(t.transpose(1, 0, 2)).permute(1, 0, 2).contiguous()


@functools.lru_cache(maxsize=None)
def pool(R, curve: str = "bn254_g1"):
    """R x C random XYZZ points of the JAX package's ``curve`` as ints,
    lifted by random lambdas (zz != 1)."""
    jc = getattr(jcurves, curve)()
    P, G = jc.F.p, (jc.gen_x, jc.gen_y)
    rng = np.random.default_rng(50 + R)
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, R * C)]
    lam = [int(v) for v in rng.integers(2, 1 << 62, R * C)]
    return [(x * l * l % P, y * l * l * l % P, l * l % P, l * l * l % P)
            for (x, y), l in zip(pts, lam)], rng.random((R, C)) < 0.25


def case(R, S, curve: str = "bn254_g1"):
    """Rows (R, L, C) x 4 as JAX limbs for S segments of ceil(R / S).
    Lanes 0 and 3: random points with infinity holes; lane 1: segment 1 at
    infinity (or, at S = 1, every row); lane 2: its first two segments hold
    the same rows, so their sums are equal."""
    pts, holes = pool(R, curve)
    jc = getattr(jcurves, curve)()
    L = -(-R // S)
    grid = [[pts[r * C + c] for c in range(C)] for r in range(R)]
    live = ~holes
    live[:, 2] = True
    for r in range(R):
        if S == 1 or L <= r < 2 * L:
            live[r, 1] = False
        if S > 1 and L <= r < 2 * L:
            grid[r][2] = grid[r - L][2]
    F = jc.F
    coords = []
    for k in range(4):
        v = np.array([[grid[r][c][k] if live[r, c] else 0 for c in range(C)] for r in range(R)],
                     dtype=object)
        coords.append(np.ascontiguousarray(F.encode(v.reshape(-1)).reshape(F.L, R, C)
                                           .transpose(1, 0, 2)))
    (_, _), (d2, _) = jmsm._blind_points(jc)
    d = tuple(np.broadcast_to(np.asarray(t)[:, None], (F.L, C)).copy() for t in d2)
    return coords, d


@pytest.mark.parametrize("curve,R,S,F", [
    ("bn254_g1", 12, 1, 1), ("bn254_g1", 12, 3, 2), ("bn254_g1", 12, 4, 2),
    ("bn254_g1", 12, 4, 1), ("bn254_g1", 13, 4, 2), ("bn254_g1", 2, 2, 1),
    ("bls12_381_g1", 5, 3, 2), ("bls12_381_g1", 5, 3, 1)])
def test_segmented_reduce_equals_jax(curve, R, S, F):
    """F threads per lane in the combine: the tree (pairs first), or 1, the
    chain."""
    rows, d = case(R, S, curve)
    want = pallas_msm.reduce_sweep_jnp(getattr(jcurves, curve)(),
                                       tuple(jnp.asarray(t) for t in rows),
                                       tuple(jnp.asarray(t) for t in d))
    want = tuple(limbs.from_jax_limbs(np.asarray(t)) for t in want)
    f = getattr(curves, curve)("cpu").F.spec
    trows = tuple(rows_to_port(t) for t in rows)
    td = tuple(limbs.from_jax_limbs(t) for t in d)
    seq = cuda_msm.reduce_sweep_plain(f, trows, td)
    for w, s in zip(want, seq):
        assert torch.equal(w, s)
    got = cuda_msm.reduce_sweep_segmented_plain(f, trows, td, S, F)
    assert bool(chip_smoke.same_points(f, got, want).all())
    # the words move for S > 1 (same points, other scalings)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) == (S == 1)


@pytest.mark.parametrize("R,C_,sms,S", [
    (256, 512, 132, 32), (64, 512, 132, 8), (16, 512, 132, 2), (2, 512, 132, 1),
    (15, 512, 132, 1), (100, 512, 132, 12), (1024, 512, 132, 64), (256, 4096, 132, 8),
    (256, 512, 8, 4)])
def test_reduce_segment_count(R, C_, sms, S):
    """S = R / 8, with S x C threads at most two blocks of 128 per SM, one
    segment below R = 16, and no segment empty."""
    got = cuda_msm.reduce_segments(R, C_, sms, 128)
    assert got == S
    L = -(-R // got)
    assert (got - 1) * L < R <= got * L


def test_combine_fan():
    """Pairs first, then a tree: ceil(S / 2) rounded up to a power of two,
    at most the combine's block."""
    assert [cuda_msm.combine_fan(S, 64) for S in (1, 2, 3, 4, 5, 8, 9, 32, 64, 300)] == \
        [1, 1, 2, 2, 4, 4, 8, 16, 32, 64]
    assert [cuda_msm.combine_fan(S, 16) for S in (9, 32, 64)] == [8, 16, 16]
