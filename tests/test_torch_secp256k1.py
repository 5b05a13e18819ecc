"""secp256k1 (and the curves Pallas and Vesta) in the port, against the
JAX package on CPU.

secp256k1's p fills all 256 bits of its 8 words, so on the card its point
and sweep kernels take the multiply's 64-bit CIOS form (w8_full); Pallas
and Vesta have a spare bit and take the even/odd chains, as BN254.  On the
CPU every wrapper takes its plain twin, which must give the JAX package's
words: K2, K3 and K4's twins and ``to_affine`` against ``SWCurve``'s
``_add/_dbl/_madd_xyzz_jnp`` and ``to_affine`` on lanes that double,
cancel and hold infinity (each JAX formula costs 3-8 s on one core, so
Pallas and Vesta take theirs in ``test_torch_pasta.py`` and the sweeps in
``test_torch_secp256k1_sweeps.py``); the MSM on the windowed and the naive
path against exact host ints; the curves' parameters, their card default
and the kernels' forms.  Inputs come from numpy seeds.  Every comparison
is exact.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math.ec import AffinePoint as JAffinePoint
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import msm as tmsm
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec, cuda_mont, cuda_msm

torch.set_num_threads(1)

CURVES = ["secp256k1", "pallas", "vesta"]


def params(name):
    jc = getattr(jcurves, name)()
    return jc, getattr(curves, name)("cpu"), jc.F.p, (jc.gen_x, jc.gen_y)


def lift(pt, lam, P):
    """Affine point (or None) -> XYZZ ints (x l^2, y l^3, l^2, l^3)."""
    if pt is None:
        return (0, 0, 0, 0)
    l2, l3 = lam * lam % P, lam ** 3 % P
    return (pt[0] * l2 % P, pt[1] * l3 % P, l2, l3)


def lanes(name, seed):
    """(P, Q) XYZZ lanes and (P, Q affine, q_inf) mixed-add lanes: generic,
    P = Q, P = -Q, P = inf, Q = inf, both inf, each with its own scaling."""
    _, _, P, G = params(name)
    rng = np.random.default_rng(seed)
    a, b = (host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, 2))
    neg = (a[0], -a[1] % P)
    pairs = [(a, b), (a, a), (a, neg), (None, b), (a, None), (None, None)]
    lam = [int(v) for v in rng.integers(2, 1 << 62, 2 * len(pairs))]
    ps = [lift(p, lam[2 * i], P) for i, (p, _) in enumerate(pairs)]
    qs = [lift(q, lam[2 * i + 1], P) for i, (_, q) in enumerate(pairs)]
    return ps, qs, [q or b for _, q in pairs], np.array([q is None for _, q in pairs])


def encode(jc, rows):
    """Rows of ints -> (JAX limb arrays, port word tensors)."""
    j = tuple(jc.F.encode(np.array(list(r), dtype=object)) for r in zip(*rows))
    return j, tuple(limbs.from_jax_limbs(np.asarray(t)) for t in j)


def assert_words(jax_coords, port_coords):
    for jt, tt in zip(jax_coords, port_coords):
        np.testing.assert_array_equal(limbs.to_jax_limbs(tt), np.asarray(jt))


def check_point_ops(name, jax_to_affine: bool):
    """K2, K3 and K4's twins (through the public ops) word for word against
    the JAX formulas, run eagerly; P + (-P) and inf + inf are infinity.
    to_affine's words against the JAX package's to_affine, or against its
    encoding of the host's affine ints (the same words: affine coordinates
    are unique), which costs no JAX inversion."""
    jc, tc, P, _ = params(name)
    ps, qs, qa, qinf = lanes(name, 71)
    (jp, tp), (jq, tq) = encode(jc, ps), encode(jc, qs)
    jp, jq, tp, tq = JPointXYZZ(*jp), JPointXYZZ(*jq), PointXYZZ(*tp), PointXYZZ(*tq)
    (jx, jy), (tx, ty) = encode(jc, qa)
    added = tc.add_xyzz(tp, tq)
    assert_words(jc._add_xyzz_jnp(jp, jq), added)
    assert_words(jc._dbl_xyzz_jnp(jp), tc.dbl_xyzz(tp))
    madd = tc.madd_xyzz(tp, AffinePoint(tx, ty, torch.from_numpy(qinf)))
    assert_words(jc._madd_xyzz_jnp(jp, JAffinePoint(jx, jy, jnp.asarray(qinf))), madd)
    assert [bool(v) for v in (added.zz == 0).all(0)] == [False, False, True, False, False, True]
    assert [bool(v) for v in (madd.zz == 0).all(0)] == [False, False, True, False, False, True]
    aff = tc.to_affine(added)
    if jax_to_affine:
        jaff = jc.to_affine(jc._add_xyzz_jnp(jp, jq))
        want = (jaff.x, jaff.y), np.asarray(jaff.inf)
    else:
        sums = [host_ec.affine_add(*(None if v[2] == 0 else (v[0] * pow(v[2], -1, P) % P,
                                                            v[1] * pow(v[3], -1, P) % P)
                                     for v in pq), 0, P) for pq in zip(ps, qs)]
        want = (encode(jc, [(0, 0) if v is None else v for v in sums])[0],
                np.array([v is None for v in sums]))
    assert_words(want[0], (aff.x, aff.y))
    np.testing.assert_array_equal(aff.inf.numpy(), want[1])
    assert bool(tc.is_on_curve(aff).all())


def test_point_ops_vs_jax():
    check_point_ops("secp256k1", jax_to_affine=True)


def msm_case(n, seed, bits=None):
    """n multiples of G (one at infinity) and n scalars below r (0, 1 and
    r - 1 first), or below 2^bits; the port's inputs and host ints."""
    _, tc, P, G = params("secp256k1")
    r = tc.SF.p
    rng = np.random.default_rng(seed)
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, n)]
    pts[3] = None
    top = r if bits is None else 1 << bits
    ks = [0, 1, top - 1] + [int.from_bytes(rng.bytes(40), "little") % top for _ in range(n - 3)]
    points = AffinePoint(tc.F.encode([0 if p is None else p[0] for p in pts]),
                         tc.F.encode([0 if p is None else p[1] for p in pts]),
                         torch.tensor([p is None for p in pts]))
    return tc, points, limbs.from_ints(ks, 8), host_ec.msm(pts, ks, 0, P)


@pytest.mark.parametrize("n,bits", [(40, None), (200, 40)], ids=["naive", "windowed"])
def test_msm_vs_host(n, bits):
    """The naive path (n <= 128: the ladder's twin over 256-bit scalars and
    the tree of adds) and the windowed path (n > 128: K5, the lane scan,
    the bucket add, K6, the fold and Horner, at c = 10 over 40-bit scalars)
    equal the host's point."""
    tc, points, sw, want = msm_case(n, 72 + n, bits)
    aff = tc.to_affine(tmsm.msm(tc, points, sw, total_bits=bits))
    assert (int(tc.F.decode(aff.x)), int(tc.F.decode(aff.y))) == want


def test_curves_match_jax_and_default_to_the_card(monkeypatch):
    """The new curves have the JAX package's parameters and fields, and
    their constructors default to CUDA (raising on a host without it)."""
    for name in CURVES:
        jc, tc, _, _ = params(name)
        assert (tc.F.p, tc.SF.p, tc.b_int, int(tc.gen_x), int(tc.gen_y)) == \
            (jc.F.p, jc.SF.p, jc.b_int, int(jc.gen_x), int(jc.gen_y))
        assert tc.F.spec.name == jc.F.spec.name and tc._kernel_ok and jc._pallas_ok
    cuda = torch.device("cuda")
    fns = (curves.secp256k1_fq, curves.secp256k1_fr, curves.secp256k1, curves.pallas,
           curves.vesta)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == cuda, fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in fns:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_kernel_forms_and_launch_tags():
    """secp256k1's fields take the full-width form at W = 8, Pallas, Vesta
    and BN254 the spare-bit chains, every W = 12 field the full form; a
    launch counts under its instantiation's tag."""
    Form = cuda_mont.Form
    assert cuda_mont.kernel_form(presets.SECP256K1_FQ) == Form(8, False)
    assert cuda_mont.kernel_form(presets.SECP256K1_FR).tag == "w8_full"
    for f in (presets.PALLAS_FP, presets.VESTA_FP, presets.BN254_FQ, presets.BN254_FR):
        assert cuda_mont.kernel_form(f).tag == "w8_spare"
    assert cuda_mont.kernel_form(presets.BLS12_381_FQ).tag == "w12_full"
    assert cuda_mont.kernel_form(presets.BABY_BEAR).tag == "w1_full"

    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_form = 0, {}
    for f in (presets.SECP256K1_FQ, presets.PALLAS_FP, presets.SECP256K1_FR):
        cuda_mont.count_launch(wrapper, f)
    assert wrapper.launches == 3 and wrapper.launches_by_form == {"w8_full": 2, "w8_spare": 1}
    # CPU tensors of a full-width field take the plain twins and launch nothing
    tc = curves.secp256k1("cpu")
    before = cuda_ec.add_xyzz.launches, cuda_msm.suffix_sweep.launches
    g = tc.to_xyzz(tc.generator((2,)))
    tc.add_xyzz(g, g)
    assert (cuda_ec.add_xyzz.launches, cuda_msm.suffix_sweep.launches) == before
