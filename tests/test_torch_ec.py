"""The port's XYZZ point layer against the JAX package on CPU (BN254 G1).

The same XYZZ lanes, made with numpy from a fixed seed, go through
``SWCurve._add_xyzz_jnp`` / ``_dbl_xyzz_jnp`` / ``_madd_xyzz_jnp`` /
``to_affine`` of the JAX package, run eagerly, and through the port; the
words must agree bit for bit.  ``scalar_mul`` and ``random_affine`` are held
against exact host ints and against the JAX package's scalar draws.
"""
import numpy as np
import pytest
import torch

from tachyon_tpu.fields.spec import int_to_limbs
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math.ec import AffinePoint as JAffinePoint
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec

torch.set_num_threads(1)

P = jcurves.bn254_g1().F.p
R = jcurves.bn254_g1().SF.p
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
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1("cpu")
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
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1("cpu")
    ps, _ = special_lanes(np.random.default_rng(22))
    jp, tp = encode_lanes(ps)
    want = jc._dbl_xyzz_jnp(jp)
    assert_same_point(want, tc._dbl_xyzz_plain(tp))
    assert_same_point(want, tc.dbl_xyzz(tp))


def test_to_affine_vs_jax():
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1("cpu")
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
    tc = curves.bn254_g1("cpu")
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
    tc = curves.bn254_g1("cpu")
    g = tc.to_xyzz(tc.generator((4,)))
    wrappers = (cuda_ec.add_xyzz, cuda_ec.dbl_xyzz, cuda_ec.madd_xyzz)
    before = [w.launches for w in wrappers]
    out = cuda_ec.add_xyzz(tc.F.spec, tuple(g), tuple(g))
    assert torch.equal(out[0], cuda_ec.dbl_xyzz(tc.F.spec, tuple(g))[0])
    a = tc.generator((4,))
    out = cuda_ec.madd_xyzz(tc.F.spec, tuple(g), a.x, a.y, a.inf)
    assert torch.equal(out[1], cuda_ec.dbl_xyzz(tc.F.spec, tuple(g))[1])
    assert [w.launches for w in wrappers] == before


def madd_lanes(rng, with_dbl):
    """(P as XYZZ ints, Q affine ints, q_inf) lanes: generic, P = -Q,
    P = inf, Q = inf (its coordinates left non-zero), both inf, and with
    with_dbl also P = Q; P has random projective scalings."""
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 8)]

    def lam():
        return int(rng.integers(2, 1 << 62))

    ps, qs, qinf = [], [], []
    for i in range(2):
        a, b = pts[2 * i], pts[2 * i + 1]
        neg = (a[0], (-a[1]) % P)
        cases = [(a, b, False), (a, neg, False), (None, b, False), (a, b, True),
                 (None, b, True), (b, a, False)]
        if with_dbl:
            cases.append((a, a, False))
        for pa, qa, qi in cases:
            ps.append(xyzz_ints(pa, lam()))
            qs.append(qa)
            qinf.append(qi)
    return ps, qs, np.array(qinf)


@pytest.mark.parametrize("with_dbl", [True, False], ids=["with_double", "no_double"])
def test_madd_xyzz_vs_jax(with_dbl):
    """K4's twin and the public mixed add against the JAX twin, run eagerly;
    without P = Q lanes the twin skips its double and must still agree."""
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1("cpu")
    ps, qs, qinf = madd_lanes(np.random.default_rng(25), with_dbl)
    jp, tp = encode_lanes(ps)
    F = jcurves.bn254_g1().F
    jx = F.encode(np.array([q[0] for q in qs], dtype=object))
    jy = F.encode(np.array([q[1] for q in qs], dtype=object))
    want = jc._madd_xyzz_jnp(jp, JAffinePoint(jx, jy, qinf))
    tq = AffinePoint(limbs.from_jax_limbs(jx), limbs.from_jax_limbs(jy), torch.from_numpy(qinf))
    assert_same_point(want, cuda_ec.madd_xyzz_plain(tc.F.spec, tuple(tp), tq.x, tq.y, tq.inf))
    got = tc.madd_xyzz(tp, tq)
    assert_same_point(want, got)
    # P = -Q and inf + inf lanes are infinity; inf + Q lifts Q with zz = mont(1)
    zz = [int(v) for v in tc.F.decode(got.zz)]
    step = len(qs) // 2
    for i in (0, step):
        assert zz[i + 1] == 0 and zz[i + 4] == 0 and zz[i + 2] == 1


def test_scalar_mul_vs_host():
    """[s]P on lanes with s = 0, 1, r - 1, random 254-bit scalars, and a
    point at infinity, against exact host ints."""
    tc = curves.bn254_g1("cpu")
    rng = np.random.default_rng(26)
    base = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 6)]
    ks = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range(3)]
    inf = torch.tensor([False] * 5 + [True])
    pts = AffinePoint(tc.F.encode([b[0] for b in base]), tc.F.encode([b[1] for b in base]), inf)
    sw = limbs.from_ints(ks, 8)
    aff = tc.to_affine(tc.scalar_mul(pts, sw))
    got = [None if bool(aff.inf[i]) else (int(tc.F.decode(aff.x[:, i])),
                                            int(tc.F.decode(aff.y[:, i]))) for i in range(6)]
    want = [host_ec.scalar_mul(b, k, 0, P) for b, k in zip(base, ks)]
    want[5] = None
    assert got == want


def test_random_affine_vs_jax_scalars(monkeypatch):
    """The port draws the JAX package's scalars from the same numpy seed
    (the JAX ``scalar_mul`` is stubbed to record its limbs: its scan takes
    minutes to compile on a CPU), and its points are those multiples of G."""
    jc, tc = jcurves.bn254_g1(), curves.bn254_g1("cpu")
    seen = {}

    def record(g, sl):
        seen["limbs"] = np.asarray(sl)
        return g

    # the JAX curve is a cached instance: monkeypatch restores it afterwards
    monkeypatch.setattr(jc, "scalar_mul", record)
    monkeypatch.setattr(jc, "to_affine", lambda pts: pts)
    _, jscalars = jc.random_affine(4, np.random.default_rng(27))
    aff, scalars = tc.random_affine(4, np.random.default_rng(27))
    assert list(scalars) == list(jscalars)
    np.testing.assert_array_equal(
        seen["limbs"], np.stack([int_to_limbs(int(s), 16) for s in scalars], axis=-1))
    got = [(int(tc.F.decode(aff.x[:, i])), int(tc.F.decode(aff.y[:, i]))) for i in range(4)]
    assert got == [host_ec.scalar_mul(G, int(s), 0, P) for s in scalars]
    assert not bool(aff.inf.any())
