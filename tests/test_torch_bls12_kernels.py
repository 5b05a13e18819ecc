"""The W = 12 kernels' plain twins against the JAX package on CPU
(BLS12-381: Fq of 381 bits, 12 words; Fr of 255 bits, 8 words).

On the card every kernel has its W = 12 instantiation; on the CPU each
wrapper takes its plain twin, which must give the JAX package's words:
K1's ``cuda_mont.mul_plain`` against ``tachyon_tpu.ops.mont._mul_jnp`` on
random operands (the edge operands are a case of ``test_torch_mont.py``);
K2, K3 and K4's twins against ``bls12_381_g1()``'s
``_add/_dbl/_madd_xyzz_jnp`` on lanes that double, cancel and hold
infinity; the ladder against the JAX ``scalar_mul`` scan, recorded in
``tests/fixtures/torch_groth16_bls12_381_jax.json``, and host ints.  K5,
K6, the bucket, lane and Horner kernels take bls12_381_g1 as a case of
their tests (``test_torch_sweeps.py``, ``test_torch_reduce.py``,
``test_torch_bucket.py``, ``test_torch_horner.py``).  Inputs come from
numpy seeds; JAX runs op by op (``jax.disable_jit``), a fraction of its
XLA:CPU compile at 24 limbs.
"""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math.ec import AffinePoint as JAffinePoint
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu.ops import mont as jmont
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import pairing_bls12_381 as bls
from tachyon_tpu_torch.math.ec import AffinePoint
from tachyon_tpu_torch.ops import cuda_ec, cuda_mont

from test_torch_bls12_groth16 import FIXTURE

torch.set_num_threads(1)

P, R, G = bls.P, bls.R, bls.G1_GEN


def jc():
    return jcurves.bls12_381_g1()


def tc():
    return curves.bls12_381_g1("cpu")


def lift(pt, lam):
    """Affine point (or None) -> XYZZ ints (x l^2, y l^3, l^2, l^3)."""
    if pt is None:
        return (0, 0, 0, 0)
    l2, l3 = lam * lam % P, lam ** 3 % P
    return (pt[0] * l2 % P, pt[1] * l3 % P, l2, l3)


def encode(lanes):
    """list of 4-tuples of ints -> (JAX coords, port PointXYZZ)."""
    F = jc().F
    j = tuple(F.encode(np.array([ln[k] for ln in lanes], dtype=object)) for k in range(4))
    return JPointXYZZ(*j), limbs.xyzz_from_jax(tuple(np.asarray(t) for t in j))


def same_words(jp, tp):
    for jt, tt in zip(jp, tp):
        np.testing.assert_array_equal(limbs.to_jax_limbs(tt), np.asarray(jt))


def special_lanes(rng):
    """(P, Q) lanes: generic, P = Q, P = -Q, P = inf, Q = inf, both inf,
    twice with other projective scalings."""
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 4)]
    ps, qs = [], []
    for i in range(2):
        a, b = pts[2 * i], pts[2 * i + 1]
        neg = (a[0], (-a[1]) % P)
        for pa, qa in ((a, b), (a, a), (a, neg), (None, b), (a, None), (None, None)):
            ps.append(lift(pa, int(rng.integers(2, 1 << 62))))
            qs.append(lift(qa, int(rng.integers(2, 1 << 62))))
    return ps, qs


def test_k1_mul_plain_vs_jax():
    """K1's twin at W = 12 word for word on random operands below p (the
    edge operands are a case of ``test_torch_mont.py``'s edge test)."""
    f = presets.BLS12_381_FQ
    assert limbs.word_count(f) == 12 and cuda_mont.has_spare_bit(f)
    rng = np.random.default_rng(110)
    xs = [int.from_bytes(rng.bytes(48), "little") % f.p for _ in range(64)]
    ys = [int.from_bytes(rng.bytes(48), "little") % f.p for _ in range(64)]
    ta, tb = limbs.from_ints(xs, 12), limbs.from_ints(ys, 12)
    want = jmont._mul_jnp(f, *(jnp.asarray(limbs.to_jax_limbs(t)) for t in (ta, tb)))
    got = cuda_mont.mul_plain(f, ta, tb)
    np.testing.assert_array_equal(limbs.to_jax_limbs(got), np.asarray(want))
    assert torch.equal(cuda_mont.mul(f, ta, tb), got)  # CPU tensors: the twin
    # and the integers: a b R^-1 mod p
    rinv = pow(f.R, -1, f.p)
    assert limbs.words_to_ints(got.numpy().view(np.uint32)) == \
        [x * y * rinv % f.p for x, y in zip(xs, ys)]


def test_add_dbl_twins_vs_jax():
    """K2's and K3's twins at W = 12 against the JAX twins; P = -Q lanes
    give infinity."""
    ps, qs = special_lanes(np.random.default_rng(111))
    jp, tp = encode(ps)
    jq, tq = encode(qs)
    f = tc().F.spec
    with jax.disable_jit():
        want_add, want_dbl = jc()._add_xyzz_jnp(jp, jq), jc()._dbl_xyzz_jnp(jp)
    got = cuda_ec.add_xyzz(f, tuple(tp), tuple(tq))
    same_words(want_add, got)
    assert [bool(v) for v in (got[2] == 0).all(0)[2::6]] == [True, True]
    same_words(want_dbl, cuda_ec.dbl_xyzz(f, tuple(tp)))


def test_madd_twin_vs_jax():
    """K4's twin at W = 12: generic, P = Q, P = -Q, P = inf, Q = inf, both."""
    rng = np.random.default_rng(112)
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 4)]
    ps, qs, qinf = [], [], []
    for i in range(2):
        a, b = pts[2 * i], pts[2 * i + 1]
        for pa, qa, qi in ((a, b, False), (a, a, False), (a, (a[0], P - a[1]), False),
                           (None, b, False), (a, b, True), (None, b, True)):
            ps.append(lift(pa, int(rng.integers(2, 1 << 62))))
            qs.append(qa)
            qinf.append(qi)
    jp, tp = encode(ps)
    F = jc().F
    jx = F.encode(np.array([q[0] for q in qs], dtype=object))
    jy = F.encode(np.array([q[1] for q in qs], dtype=object))
    with jax.disable_jit():
        want = jc()._madd_xyzz_jnp(jp, JAffinePoint(jx, jy, np.array(qinf)))
    got = cuda_ec.madd_xyzz(tc().F.spec, tuple(tp), limbs.from_jax_limbs(jx),
                            limbs.from_jax_limbs(jy), torch.tensor(qinf))
    same_words(want, got)
    assert [int(v) for v in tc().F.decode(got[2])][2::6] == [0, 0]


def test_ladder_twin_vs_jax_and_host():
    """The ladder's twin at W = 12 with one-word scalars (0, 1, 2^32 - 1,
    random; one point at infinity) gives the words of the JAX package's
    ``scalar_mul`` scan on bls12_381_g1, recorded by
    ``scripts/make_torch_bls12_groth16_fixture.py`` (its compile takes ~90 s
    on a CPU); with full 255-bit scalars (0, 1, r - 1, random) it equals
    host ints."""
    lad = json.loads(FIXTURE.read_text())["ladder"]
    curve = tc()
    base = [tuple(int(v, 16) for v in q) for q in lad["points"]]
    pts = AffinePoint(curve.F.encode([b[0] for b in base]), curve.F.encode([b[1] for b in base]),
                      torch.tensor(lad["inf"]))
    ks = [int(k, 16) for k in lad["scalars"]]
    assert ks[:3] == [0, 1, (1 << 32) - 1] and lad["inf"] == [False] * 5 + [True]
    got = curve.scalar_mul(pts, limbs.from_ints(ks, 1))
    assert [limbs.words_to_ints(t.numpy().view(np.uint32)) for t in got] == \
        [[int(v, 16) for v in c] for c in lad["xyzz"]]
    rng = np.random.default_rng(113)
    ks = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range(3)]
    aff = curve.to_affine(curve.scalar_mul(pts, limbs.from_ints(ks, 8)))
    got = chip_smoke.sampled_points(curve, aff, list(range(6)))
    want = [host_ec.scalar_mul(b, k, 0, P) for b, k in zip(base, ks)]
    assert got == want[:5] + [None]


@pytest.mark.parametrize("name", ["bls12_381_g1", "bls12_381_g2"])
def test_curves_match_jax(name):
    """The port's BLS12-381 curves carry the JAX package's parameters (G1
    over Fq, G2 over Fq2 = Fq[u]/(u^2 + 1), scalars in Fr) and put their
    constants on the card unless told otherwise."""
    fn = getattr(curves, name)
    for f in (fn, curves.bls12_381_fq, curves.bls12_381_fr, curves.bls12_381_fq2):
        assert inspect.signature(f).parameters["device"].default == torch.device("cuda")
    port, ref = fn("cpu"), getattr(jcurves, name)()
    assert (port.gen_x, port.gen_y, port.b_int) == \
        tuple(v if name.endswith("g1") else list(v) for v in (ref.gen_x, ref.gen_y, ref.b_int))
    assert (port.SF.p, port.SF.spec.generator) == (ref.SF.p, ref.SF.spec.generator)
    if name.endswith("g2"):
        assert (port.F.p, port.F.D, port.F._nr_host) == (ref.F.base.p, ref.F.D, -1)
    else:
        assert (port.F.p, port.F.W) == (ref.F.p, 12)
    assert bool(port.is_on_curve(port.generator((2,))).all())
