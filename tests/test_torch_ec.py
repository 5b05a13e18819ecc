"""The port's XYZZ point layer against the JAX package on CPU (BN254 G1).

The same XYZZ lanes, made with numpy from a fixed seed, go through
``SWCurve._add_xyzz_jnp`` / ``_dbl_xyzz_jnp`` / ``to_affine`` of the JAX
package and through the port; the words must agree bit for bit.
"""
import numpy as np
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math.ec import PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec

torch.set_num_threads(1)

P = jcurves.bn254_g1().F.p
G = (1, 2)


def xyzz_ints(pt, lam):
    """Affine point (or None) -> XYZZ ints (x l^2, y l^3, l^2, l^3)."""
    if pt is None:
        return (0, 0, 0, 0)
    x, y = pt
    l2, l3 = lam * lam % P, lam * lam * lam % P
    return (x * l2 % P, y * l3 % P, l2, l3)


def special_lanes(rng):
    """(P, Q) lane lists: generic, P = Q, P = -Q, P = inf, Q = inf, both inf,
    each case twice with different projective scalings."""
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 12)]

    def lam():
        return int(rng.integers(2, 1 << 62))

    ps, qs = [], []
    for i in range(2):
        a, b = pts[2 * i], pts[2 * i + 1]
        neg = (a[0], (-a[1]) % P)
        for pa, qa in ((a, b), (a, a), (a, neg), (None, b), (a, None), (None, None)):
            ps.append(xyzz_ints(pa, lam()))
            qs.append(xyzz_ints(qa, lam()))
    return ps, qs


def encode_lanes(lanes):
    """list of 4-tuples of ints -> (JAX coords, port PointXYZZ)."""
    F = jcurves.bn254_g1().F
    j = tuple(F.encode(np.array([ln[k] for ln in lanes], dtype=object)) for k in range(4))
    return JPointXYZZ(*j), limbs.xyzz_from_jax(tuple(np.asarray(t) for t in j))


def assert_same_point(jp, tp):
    for jt, tt in zip(jp, tp):
        np.testing.assert_array_equal(limbs.to_jax_limbs(tt), np.asarray(jt))


def test_add_xyzz_vs_jax():
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1()
    ps, qs = special_lanes(np.random.default_rng(21))
    jp, tp = encode_lanes(ps)
    jq, tq = encode_lanes(qs)
    want = jc._add_xyzz_jnp(jp, jq)
    got = tc._add_xyzz_plain(tp, tq)
    assert_same_point(want, got)
    # the public op (K2's wrapper) takes the plain twin for CPU tensors
    assert_same_point(want, tc.add_xyzz(tp, tq))
    # P = -Q lanes give infinity
    assert [bool(v) for v in (got.zz == 0).all(0)[2::6]] == [True, True]


def test_dbl_xyzz_vs_jax():
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1()
    ps, _ = special_lanes(np.random.default_rng(22))
    jp, tp = encode_lanes(ps)
    want = jc._dbl_xyzz_jnp(jp)
    assert_same_point(want, tc._dbl_xyzz_plain(tp))
    assert_same_point(want, tc.dbl_xyzz(tp))


def test_to_affine_vs_jax():
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1()
    ps, qs = special_lanes(np.random.default_rng(23))
    jp, tp = encode_lanes(ps + qs)
    want = jc.to_affine(jp)
    got = tc.to_affine(tp)
    np.testing.assert_array_equal(limbs.to_jax_limbs(got.x), np.asarray(want.x))
    np.testing.assert_array_equal(limbs.to_jax_limbs(got.y), np.asarray(want.y))
    np.testing.assert_array_equal(got.inf.numpy(), np.asarray(want.inf))
    assert bool(tc.is_on_curve(got).all())


def test_group_law_vs_host():
    """Port point ops agree with exact host arithmetic; helpers of SWCurve."""
    tc = curves.bn254_g1()
    F = tc.F
    rng = np.random.default_rng(24)
    a, b = (host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 2))
    _, tp = encode_lanes([xyzz_ints(a, 5), xyzz_ints(b, 7)])
    s = tc.to_affine(tc.add_xyzz(PointXYZZ(*(t[:, :1] for t in tp)),
                                 PointXYZZ(*(t[:, 1:] for t in tp))))
    assert (int(F.decode(s.x)[0]), int(F.decode(s.y)[0])) == host_ec.affine_add(a, b, 0, P)
    d = tc.to_affine(tc.dbl_xyzz(tp))
    assert (int(F.decode(d.x)[1]), int(F.decode(d.y)[1])) == host_ec.affine_add(b, b, 0, P)
    g = tc.generator((3,))
    assert bool(tc.is_on_curve(g).all())
    gx = tc.to_xyzz(g)
    assert bool(tc.eq_affine(tc.to_affine(gx), g).all())
    ng = tc.neg_affine(g)
    inf = tc.to_affine(tc.add_xyzz(gx, tc.to_xyzz(ng)))
    assert bool(inf.inf.all())
    assert bool(tc.eq_affine(inf, tc.infinity_affine((3,))).all())
    assert bool(tc.to_affine(tc.infinity_xyzz(2)).inf.all())
    assert bool(tc.to_affine(tc.neg_xyzz(gx)).y.eq(ng.y).all())


def test_point_wrappers_on_cpu_take_the_plain_path():
    tc = curves.bn254_g1()
    g = tc.to_xyzz(tc.generator((4,)))
    before = (cuda_ec.add_xyzz.launches, cuda_ec.dbl_xyzz.launches)
    out = cuda_ec.add_xyzz(tc.F.spec, tuple(g), tuple(g))
    assert torch.equal(out[0], cuda_ec.dbl_xyzz(tc.F.spec, tuple(g))[0])
    assert (cuda_ec.add_xyzz.launches, cuda_ec.dbl_xyzz.launches) == before
