"""The MSM window's bucket kernel and the biased lane scan and fold, on CPU
(BN254 G1, and BLS12-381 G1 for the kernels' W = 12 instantiations).

On the card the T-gather add at the bucket starts is one launch
(``cuda_msm.bucket_add``), and the blind adds around the lane scan and
fold run inside those kernels (a bias point).  Their plain twins must equal
the JAX package's composition word for word: ``tachyon_tpu/math/msm.py``'s
takes, ``SWCurve._add_xyzz_jnp``, where, pad and reshape for the buckets,
and ``_suffix_scan_lanes`` / ``_fold_reduce_lanes`` between two complete
adds of the broadcast blind.  Each test takes the curve by name, with its
limb count L, its word count W and the JAX package's real blind points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lane_scan import lanes, to_port
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import msm as jmsm
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.ops import cuda_ec, cuda_msm

torch.set_num_threads(1)

R, C, B, C2 = 4, 8, 32, 8
CURVES = ["bn254_g1", "bls12_381_g1"]


def lift(pts, rng, jc):
    """Affine ints (None = infinity) -> JAX limbs (L, n) x 4 of the JAX curve
    jc, XYZZ with a random lambda a point (zz != 1)."""
    P = jc.F.p
    lam = [int(v) for v in rng.integers(2, 1 << 62, len(pts))]
    rows = [(0, 0, 0, 0) if p is None else
            (p[0] * l * l % P, p[1] * l ** 3 % P, l * l % P, l ** 3 % P)
            for p, l in zip(pts, lam)]
    return tuple(jc.F.encode(np.array([r[k] for r in rows], dtype=object)) for k in range(4))


def bucket_inputs(curve: str = "bn254_g1"):
    """T at R x C (JAX limbs (L, R, C) x 4), W'' at C lanes, and pos, the
    searchsorted bucket starts of R C sorted digits below B - 8 (so the top
    buckets' digits are absent: pos = R C).  Four lanes read by a bucket
    hit the add's cases at their first bucket: W'' = T there (P = Q, a
    double), W'' = -T (P = -Q, infinity), W'' at infinity, T at infinity."""
    jc = getattr(jcurves, curve)()
    P, G = jc.F.p, (jc.gen_x, jc.gen_y)
    rng = np.random.default_rng(71)
    digits = np.sort(rng.integers(0, B - 8, R * C))
    pos = np.searchsorted(digits, np.arange(1, B)).astype(np.int32)
    T = [[host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, C)]
         for _ in range(R)]
    wpp = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, C)]
    first = {}
    for k in pos[pos < R * C]:
        first.setdefault(int(k) // R, int(k) % R)
    assert len(first) >= 4
    c0, c1, c2, c3 = sorted(first)[:4]
    wpp[c0] = T[first[c0]][c0]
    x, y = T[first[c1]][c1]
    wpp[c1] = (x, P - y)
    wpp[c2] = None
    T[first[c3]][c3] = None
    tj = tuple(t.reshape(jc.F.L, R, C) for t in lift([p for row in T for p in row], rng, jc))
    return tj, lift(wpp, rng, jc), pos, (c0, c1)


def rows_to_port(t):
    """(L, R, C) JAX limbs -> (R, W, C) port words."""
    return limbs.from_jax_limbs(t).permute(1, 0, 2).contiguous()


@pytest.mark.parametrize("curve", CURVES)
def test_bucket_add_plain_vs_jax(curve):
    tj, wj, pos, (c_dbl, c_inf) = bucket_inputs(curve)
    jcurve = getattr(jcurves, curve)()
    L = jcurve.F.L
    n_pad = R * C
    # tachyon_tpu/math/msm.py:348-361
    with jax.disable_jit():  # op by op: a fraction of the add's XLA:CPU compile
        p = jnp.asarray(pos)
        valid = p < n_pad
        posc = jnp.where(valid, p, 0)
        flat = (posc % R) * C + (posc // R)
        tg = [jnp.take(jnp.asarray(t).reshape(L, n_pad), flat, axis=-1) for t in tj]
        wg = [jnp.take(jnp.asarray(t), posc // R, axis=-1) for t in wj]
        tv = jcurve._add_xyzz_jnp(JPointXYZZ(*tg), JPointXYZZ(*wg))
        want = [np.asarray(jnp.pad(jnp.where(valid, t, 0), [(0, 0), (0, 1)])
                           .reshape(L, B // C2, C2)) for t in tv]
    f = getattr(curves, curve)("cpu").F.spec
    W = limbs.word_count(f)
    args = (f, tuple(rows_to_port(t) for t in tj), to_port(wj), torch.from_numpy(pos), C2)
    got = cuda_msm.bucket_add_plain(*args)
    for w, g in zip(want, got):
        assert tuple(g.shape) == (B // C2, W, C2) and g.is_contiguous()
        np.testing.assert_array_equal(limbs.to_jax_limbs(g.permute(1, 0, 2)), w)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_msm.bucket_add(*args)))
    # the cases: absent digits and the pad bucket are infinity, P = -Q
    # cancels, P = Q doubles (a finite point)
    zz = got[2].permute(1, 0, 2).reshape(W, B)
    absent = np.append(pos >= n_pad, True)
    assert absent.sum() >= 9 and bool((zz[:, torch.from_numpy(absent)] == 0).all())
    j_inf = int(np.argmax(pos // R == c_inf))
    j_dbl = int(np.argmax(pos // R == c_dbl))
    assert bool((zz[:, j_inf] == 0).all()) and bool((zz[:, j_dbl] != 0).any())


def bias_jax(curve: str = "bn254_g1"):
    """-D1 of the JAX package's blind points, as JAX limbs and port words."""
    (_, nd), _ = jmsm._blind_points(getattr(jcurves, curve)())
    return nd, tuple(limbs.from_jax_limbs(np.asarray(t)) for t in nd)


@pytest.mark.parametrize("curve", CURVES)
def test_biased_lane_scan_vs_jax(curve):
    n = 8
    j = lanes(n, curve)
    nd, bias = bias_jax(curve)
    jcurve = getattr(jcurves, curve)()
    with jax.disable_jit():
        u = jcurve._add_xyzz_jnp(JPointXYZZ(*(jnp.asarray(t) for t in j)), jmsm._bcast(nd, (n,)))
        wk = jmsm._suffix_scan_lanes(jcurve, u)
        want = jcurve._add_xyzz_jnp(wk, jmsm._bcast(nd, (n,)))
    f = getattr(curves, curve)("cpu").F.spec
    got = cuda_ec.lane_suffix_scan(f, to_port(j), bias)
    for w, g in zip(to_port(want), got):
        assert torch.equal(w, g)
    # equal to the unbiased scan between two biased adds
    u_port = cuda_ec.add_bias_plain(f, to_port(j), bias)
    again = cuda_ec.add_bias_plain(f, cuda_ec.lane_suffix_scan(f, u_port), bias)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("n", [1, 16])
def test_biased_lane_fold_vs_jax(n, curve):
    j = tuple(t[:, :n] for t in lanes(max(n, 8), curve))
    nd, bias = bias_jax(curve)
    jcurve = getattr(jcurves, curve)()
    with jax.disable_jit():
        red = jcurve._add_xyzz_jnp(JPointXYZZ(*(jnp.asarray(t) for t in j)), jmsm._bcast(nd, (n,)))
        want = jmsm._fold_reduce_lanes(jcurve, red)
    f = getattr(curves, curve)("cpu").F.spec
    out = tuple(torch.zeros((limbs.word_count(f), 3), dtype=torch.int32)[:, 1] for _ in range(4))
    got = cuda_ec.lane_fold(f, to_port(j), out, bias)
    for w, g, o in zip(want, got, out):
        np.testing.assert_array_equal(limbs.to_jax_limbs(g), np.asarray(w))
        assert g is o


def test_cpu_wrappers_launch_no_kernel():
    wrappers = (cuda_msm.bucket_add, cuda_ec.lane_suffix_scan, cuda_ec.lane_fold,
                cuda_ec.add_xyzz)
    for w in wrappers:
        w.launches = 0
    tj, wj, pos, _ = bucket_inputs()
    f = curves.bn254_g1("cpu").F.spec
    _, bias = bias_jax()
    rows = cuda_msm.bucket_add(f, tuple(rows_to_port(t) for t in tj), to_port(wj),
                               torch.from_numpy(pos), C2)
    cuda_ec.lane_suffix_scan(f, to_port(wj), bias)
    cuda_ec.lane_fold(f, tuple(t[0] for t in rows), None, bias)
    assert [w.launches for w in wrappers] == [0] * len(wrappers)
