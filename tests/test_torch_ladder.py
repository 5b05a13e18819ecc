"""The fused ``scalar_mul`` ladder's wrapper on CPU (BN254 G1).

On the card ``SWCurve.scalar_mul`` is one launch of the ladder kernel
(``csrc/ladder.cu``).  On the CPU ``cuda_ec.scalar_mul`` takes its plain
twin ``scalar_mul_plain``, which must launch nothing and return the words
of the loop that ``SWCurve.scalar_mul`` ran before (K3, K4 and a select
per bit), and [s]P for s = 0, 1, r - 1 and P at infinity.  The KZG test
holds these words against the JAX package's scan (its fixture).
"""
import numpy as np
import pytest
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec, cuda_mont, cuda_msm

torch.set_num_threads(1)

G = (1, 2)
WRAPPERS = (cuda_mont.mul, cuda_ec.add_xyzz, cuda_ec.dbl_xyzz, cuda_ec.madd_xyzz,
            cuda_ec.scalar_mul, cuda_msm.suffix_sweep, cuda_msm.reduce_sweep)


def old_loop(curve, p, scalars):
    """``SWCurve.scalar_mul`` as it was: MSB first, a dbl, a mixed add and
    a select on the bit per step, through the curve's public point ops."""
    nbits = scalars.shape[0] * limbs.WORD_BITS
    acc = curve.infinity_xyzz(p.inf.shape)
    for i in range(nbits):
        b = nbits - 1 - i
        bit = ((scalars[b // limbs.WORD_BITS] >> (b % limbs.WORD_BITS)) & 1) != 0
        acc = curve.dbl_xyzz(acc)
        added = curve.madd_xyzz(acc, p)
        acc = PointXYZZ(*(curve.F.select(bit, a, c) for a, c in zip(added, acc)))
    return acc


def lanes(curve, ks, rng, inf_lanes=()):
    """Points [k]G for random k (those in inf_lanes at infinity, with their
    coordinates left non-zero) and the scalars ks as (Ws, n) words."""
    P = curve.F.p
    base = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, len(ks))]
    inf = torch.tensor([i in inf_lanes for i in range(len(ks))])
    pts = AffinePoint(curve.F.encode([b[0] for b in base]), curve.F.encode([b[1] for b in base]),
                      inf)
    return pts, base


@pytest.mark.parametrize("Ws", [1, 2])
def test_scalar_mul_on_cpu_takes_the_plain_twin(Ws):
    """Short scalars (Ws words, 0, 1 and all ones among them): the wrapper
    returns the old loop's words and launches no kernel."""
    tc = curves.bn254_g1("cpu")
    rng = np.random.default_rng(50 + Ws)
    top = (1 << (32 * Ws)) - 1
    ks = [0, 1, top] + [int.from_bytes(rng.bytes(4 * Ws), "little") for _ in range(3)]
    pts, _ = lanes(tc, ks, rng, inf_lanes=(4,))
    sw = limbs.from_ints(ks, Ws)
    before = [w.launches for w in WRAPPERS]
    got = cuda_ec.scalar_mul(tc.F.spec, pts.x, pts.y, pts.inf, sw)
    want = old_loop(tc, pts, sw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(tc.scalar_mul(pts, sw), want):
        assert torch.equal(g, w)
    assert [w.launches for w in WRAPPERS] == before


def test_scalar_mul_full_width_special_scalars():
    """Ws = 8: s = 0, 1, r - 1, r - 2 and a random scalar, and P at
    infinity, against host ints; int flags give the words of bool flags."""
    tc = curves.bn254_g1("cpu")
    r, P = tc.SF.p, tc.F.p
    rng = np.random.default_rng(52)
    ks = [0, 1, r - 1, r - 2, int.from_bytes(rng.bytes(40), "little") % r, 12345]
    pts, base = lanes(tc, ks, rng, inf_lanes=(5,))
    sw = limbs.from_ints(ks, 8)
    got = cuda_ec.scalar_mul(tc.F.spec, pts.x, pts.y, pts.inf.to(torch.int32), sw)
    for g, w in zip(got, tc.scalar_mul(pts, sw)):
        assert torch.equal(g, w)
    aff = tc.to_affine(PointXYZZ(*got))
    out = [None if bool(aff.inf[i]) else (int(tc.F.decode(aff.x[:, i])),
                                           int(tc.F.decode(aff.y[:, i]))) for i in range(6)]
    want = [host_ec.scalar_mul(b, k, 0, P) for b, k in zip(base, ks)]
    want[5] = None
    assert out == want
    assert out[0] is None and out[1] == base[1] and out[2] == (base[2][0], -base[2][1] % P)


def test_scalar_mul_batch_shapes():
    """A single point (batch ()) and a (2, 2) batch give the words of the
    same lanes in a flat batch."""
    tc = curves.bn254_g1("cpu")
    rng = np.random.default_rng(53)
    ks = [int(k) for k in rng.integers(0, 1 << 31, 4)]
    pts, _ = lanes(tc, ks, rng)
    sw = limbs.from_ints(ks, 1)
    flat = tc.scalar_mul(pts, sw)
    one = tc.scalar_mul(AffinePoint(pts.x[:, 2], pts.y[:, 2], pts.inf[2]), sw[:, 2])
    square = tc.scalar_mul(AffinePoint(pts.x.view(-1, 2, 2), pts.y.view(-1, 2, 2),
                                       pts.inf.view(2, 2)), sw.view(1, 2, 2))
    for f, o, s in zip(flat, one, square):
        assert tuple(o.shape) == (8,) and tuple(s.shape) == (8, 2, 2)
        assert torch.equal(o, f[:, 2]) and torch.equal(s.reshape(8, 4), f)
