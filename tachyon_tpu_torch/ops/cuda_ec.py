"""K2, K3 and K4: whole XYZZ point add, double and mixed add as
hand-written CUDA kernels, and the fused double-and-add ladder.

Replace the Pallas kernels of ``tachyon_tpu/ops/pallas_ec.py``:

* K2 ``_add_call`` (``pl.pallas_call`` at line 209, body ``_add_body``):
  complete add-2008-s, a = 0.  P = Q doubles, P = -Q gives infinity,
  infinity inputs pass through.
* K3 ``_dbl_call`` (``pl.pallas_call`` at line 232, body ``_dbl_body``):
  dbl-2008-s-1, a = 0; infinity (zz = 0) propagates.
* K4 ``_madd_call`` (``pl.pallas_call`` at line 257, body ``_madd_body``,
  wrapper ``madd_xyzz``): complete madd-2008-s, XYZZ + affine with a q_inf
  flag row; p = infinity gives q lifted with zz = zzz = mont(1).
* ``scalar_mul``: K4 redesigned for the card, the whole MSB-first
  double-and-add ladder of ``SWCurve.scalar_mul`` (the JAX package's
  ``lax.scan`` over K3, K4 and a select per bit) in one launch
  (``csrc/ladder.cu``), with the same words.
* ``lane_suffix_scan`` and ``lane_fold``: K2 redesigned for the MSM
  window's lane reductions, the JAX package's ``fori_loop``s over K2 in
  ``_suffix_scan_lanes`` and ``_fold_reduce_lanes``
  (``tachyon_tpu/math/msm.py:196-222``), each in one launch
  (``csrc/lanes.cu``: a cooperative launch with a grid-wide barrier
  between the scan's steps; one block through shared memory for the
  fold), with the loops' order of adds and so their words.  Each takes
  an optional bias point, the window's blind adds around them
  (``tachyon_tpu/math/msm.py:340-344`` and ``:363``, a K2 launch each
  before): the scan sums u + bias and returns its sums + bias, the fold
  sums every lane + bias.

Kernels (``csrc/ec.cu``, ``csrc/ladder.cu``, ``csrc/xyzz.cuh``): one thread
per point; each coordinate is a word-major ``(W, n)`` array so the loads of
a warp coalesce.  Every kernel here and in ``cuda_msm`` is built for each
(W, form) of ``cuda_mont.kernel_form``: W = 8 with the spare-bit multiply
(BN254, Pallas, Vesta) or the 64-bit CIOS (secp256k1's full-width p), and
W = 12; its launcher picks the instantiation from p's top word.  Bound on the card: an add is 14 field multiplies (~1.9k
word products) and a mixed add 10 (~1.4k) against 384 and 324 bytes moved,
so both are bound by integer multiplies once there are enough points to
fill 132 SMs; only the naive MSM's tree reduce and Pedersen's last add
still launch K2, on 1 to 32 points, where launch latency bounds it (the
MSM window's adds run in the lane kernels and ``cuda_msm.bucket_add``).  The ladder keeps the
point and its accumulator in registers for all 256 bits, so it moves ~230
bytes per lane and is bound by its multiplies alone.  The designs evaluate
the same formulas and case order as the TPU kernel, so results are
bit-identical.  The standalone K3 and K4 stay behind ``SWCurve.dbl_xyzz``
and ``SWCurve.madd_xyzz``; neither main path launches them.

``add_xyzz_plain`` / ``dbl_xyzz_plain`` / ``madd_xyzz_plain`` /
``scalar_mul_plain`` / ``lane_suffix_scan_plain`` / ``lane_fold_plain`` /
``horner_plain`` are the plain PyTorch twins (the CPU path, and the reference the kernels
are held against on the card); they mirror ``SWCurve._add_xyzz_jnp`` /
``_dbl_xyzz_jnp`` / ``_madd_xyzz_jnp`` / ``scalar_mul`` and the JAX
package's ``_suffix_scan_lanes`` / ``_fold_reduce_lanes``.
"""
from __future__ import annotations

import torch

from tachyon_tpu_torch.fields.limbs import WORD_BITS
from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.ops import _build, mont
from tachyon_tpu_torch.ops.cuda_mont import check_cuda, consts_ptr, count_launch


def _muls(f: FieldSpec, *pairs):
    """Independent Montgomery products as one multiply over a stacked batch:
    one plain pass on the CPU, one K1 launch on the card, the same words."""
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    return mont.mul(f, a, b).unbind(1)


def dbl_xyzz_plain(f: FieldSpec, p):
    """dbl-2008-s-1 (a = 0); infinity (zz = 0) propagates."""
    px, py, pzz, pzzz = p
    u = mont.double(f, py)
    v, x2 = _muls(f, (u, u), (px, px))
    w, s, zz3 = _muls(f, (u, v), (px, v), (v, pzz))
    m = mont.mul_small(f, x2, 3)
    m2, wy, zzz3 = _muls(f, (m, m), (w, py), (w, pzzz))
    x3 = mont.sub(f, m2, mont.double(f, s))
    y3 = mont.sub(f, mont.mul(f, m, mont.sub(f, s, x3)), wy)
    return x3, y3, zz3, zzz3


def _pick(mask, a, b):
    return tuple(mont.select(mask, x, y) for x, y in zip(a, b))


def _pick_dbl(f: FieldSpec, is_dbl, p, out):
    """out with the lanes of is_dbl replaced by 2p.  The JAX twins double
    every lane and select; the double is computed here only when some lane
    takes it (the same words, fewer multiplies)."""
    if not bool(is_dbl.any()):
        return out
    return _pick(is_dbl, dbl_xyzz_plain(f, p), out)


def _add_tail(f: FieldSpec, u1, s1, pp, r, zz, zzz):
    """The shared tail of add-2008-s and madd-2008-s: x3 = r^2 - ppp - 2 qq,
    y3 = r (qq - x3) - s1 ppp, zz3 = zz pp^2, zzz3 = zzz ppp."""
    pp2, r2 = _muls(f, (pp, pp), (r, r))
    ppp, qq, zz3 = _muls(f, (pp, pp2), (u1, pp2), (zz, pp2))
    x3 = mont.sub(f, mont.sub(f, r2, ppp), mont.double(f, qq))
    t, s1ppp, zzz3 = _muls(f, (r, mont.sub(f, qq, x3)), (s1, ppp), (zzz, ppp))
    return x3, mont.sub(f, t, s1ppp), zz3, zzz3


def add_xyzz_plain(f: FieldSpec, p, q):
    """add-2008-s with complete select-based case handling; mirrors
    ``SWCurve._add_xyzz_jnp``."""
    px, py, pzz, pzzz = p
    qx, qy, qzz, qzzz = q
    u1, u2, s1, s2, zz, zzz = _muls(f, (px, qzz), (qx, pzz), (py, qzzz), (qy, pzzz),
                                    (pzz, qzz), (pzzz, qzzz))
    pp = mont.sub(f, u2, u1)
    r = mont.sub(f, s2, s1)
    same_x = mont.is_zero(f, pp)
    same_y = mont.is_zero(f, r)
    out = _add_tail(f, u1, s1, pp, r, zz, zzz)

    p_inf = mont.is_zero(f, pzz)
    q_inf = mont.is_zero(f, qzz)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf
    is_inf = same_x & ~same_y & ~p_inf & ~q_inf
    zero = torch.zeros_like(pp)
    out = _pick(is_inf, (zero,) * 4, out)
    out = _pick_dbl(f, is_dbl, p, out)
    out = _pick(q_inf, p, out)
    out = _pick(p_inf, q, out)
    return out


def madd_xyzz_plain(f: FieldSpec, p, qx, qy, q_inf):
    """madd-2008-s (mixed add, q affine, q_inf bool) with complete case
    handling; mirrors ``SWCurve._madd_xyzz_jnp``."""
    px, py, pzz, pzzz = p
    u2, s2 = _muls(f, (qx, pzz), (qy, pzzz))
    pp = mont.sub(f, u2, px)
    r = mont.sub(f, s2, py)
    same_x = mont.is_zero(f, pp)
    same_y = mont.is_zero(f, r)
    out = _add_tail(f, px, py, pp, r, pzz, pzzz)

    p_inf = mont.is_zero(f, pzz)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf
    is_inf = same_x & ~same_y & ~p_inf & ~q_inf
    zero = torch.zeros_like(pp)
    one = mont.ones(f, q_inf.shape, qx.device)
    q_xyzz = _pick(q_inf, (zero,) * 4, (qx, qy, one, one))

    out = _pick(is_inf, (zero,) * 4, out)
    out = _pick_dbl(f, is_dbl, p, out)
    out = _pick(q_inf, p, out)
    out = _pick(p_inf, q_xyzz, out)
    return out


def top_bit(scalars) -> int:
    """1 + the highest bit set in any lane of (Ws, *batch) scalar words (0
    if none): the ladder's steps above it keep every accumulator at
    infinity, all-zero words that the double keeps, so a twin that skips
    them gives the same words."""
    if not scalars.numel():
        return 0
    tops = mont.widen(scalars).reshape(scalars.shape[0], -1).amax(dim=1).tolist()
    return max((WORD_BITS * k + v.bit_length() for k, v in enumerate(tops) if v), default=0)


def scalar_mul_plain(f: FieldSpec, px, py, pinf, scalars):
    """[s]P lane by lane: MSB-first over the bits of the scalar words,
    from infinity, a double, a mixed add and a select on the bit at every
    step, as the JAX package's ``scalar_mul`` scan (which also runs the
    steps above ``top_bit``: they leave the words as they are).  pinf:
    bool."""
    zero = torch.zeros_like(px)
    acc = (zero, zero.clone(), zero.clone(), zero.clone())
    for b in range(top_bit(scalars) - 1, -1, -1):
        bit = ((scalars[b // WORD_BITS] >> (b % WORD_BITS)) & 1) != 0
        acc = dbl_xyzz_plain(f, acc)
        added = madd_xyzz_plain(f, acc, px, py, pinf)
        acc = _pick(bit, added, acc)
    return acc


def _flat(f: FieldSpec, coords):
    """(W, *batch) coords -> contiguous (W, n) views, batch shape, n."""
    batch = coords[0].shape[1:]
    for t in coords:
        if t.shape != coords[0].shape:
            raise ValueError(f"coordinate shapes differ: {t.shape} vs {coords[0].shape}")
    W = check_cuda(f, *coords).W
    n = coords[0].numel() // W
    return [t.view(W, n) for t in coords], batch, n


def add_xyzz(f: FieldSpec, p, q):
    """p, q: 4-tuples of (W, *batch) int32 coords -> 4-tuple.  CPU tensors
    take ``add_xyzz_plain``; CUDA tensors launch K2 or raise."""
    if p[0].device.type == "cpu":
        return add_xyzz_plain(f, p, q)
    coords, batch, n = _flat(f, list(p) + list(q))
    outs = [torch.empty_like(c) for c in coords[:4]]
    if n:
        _build.launch("tt_add_xyzz", *(t.data_ptr() for t in coords + outs), n,
                      consts_ptr(f), coords[0].shape[0])
        count_launch(add_xyzz, f)
    return tuple(o.view(-1, *batch) for o in outs)


def dbl_xyzz(f: FieldSpec, p):
    """p: 4-tuple of (W, *batch) coords.  CPU tensors take
    ``dbl_xyzz_plain``; CUDA tensors launch K3 or raise."""
    if p[0].device.type == "cpu":
        return dbl_xyzz_plain(f, p)
    coords, batch, n = _flat(f, list(p))
    outs = [torch.empty_like(c) for c in coords]
    if n:
        _build.launch("tt_dbl_xyzz", *(t.data_ptr() for t in coords + outs), n,
                      consts_ptr(f), coords[0].shape[0])
        count_launch(dbl_xyzz, f)
    return tuple(o.view(-1, *batch) for o in outs)


def madd_xyzz(f: FieldSpec, p, qx, qy, qinf):
    """p: 4-tuple of (W, *batch) XYZZ coords; qx, qy: (W, *batch) affine
    coords; qinf: batch-shaped infinity flags of q (bool or int).  CPU
    tensors take ``madd_xyzz_plain``; CUDA tensors launch K4 or raise."""
    if p[0].device.type == "cpu":
        return madd_xyzz_plain(f, p, qx, qy, qinf.to(torch.bool))
    coords, batch, n = _flat(f, list(p) + [qx, qy])
    if qinf.shape != batch:
        raise ValueError(f"qinf must have the batch shape {tuple(batch)}, got {tuple(qinf.shape)}")
    flags = qinf.to(torch.int32).contiguous()
    check_cuda(f, flags)
    outs = [torch.empty_like(c) for c in coords[:4]]
    if n:
        _build.launch("tt_madd_xyzz", *(t.data_ptr() for t in coords + [flags] + outs), n,
                      consts_ptr(f), coords[0].shape[0])
        count_launch(madd_xyzz, f)
    return tuple(o.view(-1, *batch) for o in outs)


def scalar_mul(f: FieldSpec, px, py, pinf, scalars):
    """[s]P: px, py (W, *batch) affine coords, pinf batch-shaped infinity
    flags (bool or int), scalars (Ws, *batch) plain int32 words; returns
    4 XYZZ coords (W, *batch).  CPU tensors take ``scalar_mul_plain``; CUDA
    tensors launch the fused ladder (one launch) or raise."""
    if px.device.type == "cpu":
        return scalar_mul_plain(f, px, py, pinf.to(torch.bool), scalars)
    coords, batch, n = _flat(f, [px, py])
    if pinf.shape != batch or scalars.shape[1:] != batch:
        raise ValueError(f"pinf {tuple(pinf.shape)} and scalars {tuple(scalars.shape)} must "
                         f"have the batch shape {tuple(batch)}")
    flags = pinf.to(torch.int32).contiguous()
    check_cuda(f, flags, scalars)
    outs = [torch.empty_like(coords[0]) for _ in range(4)]
    if n:
        _build.launch("tt_scalar_mul_xyzz",
                      *(t.data_ptr() for t in coords + [flags, scalars] + outs), n,
                      scalars.shape[0], consts_ptr(f), coords[0].shape[0])
        count_launch(scalar_mul, f)
    return tuple(o.view(-1, *batch) for o in outs)


def shift_lanes(p, s: int):
    """Lane shift of a 4-tuple of (..., C) coords along the last axis:
    out[..., c] = p[..., c + s], with infinity (all-zero coordinates)
    shifted in at the end."""
    def sh(t):
        s_ = min(s, t.shape[-1])
        pad = torch.zeros(t.shape[:-1] + (s_,), dtype=t.dtype, device=t.device)
        return torch.cat([t[..., s_:], pad], dim=-1)

    return tuple(sh(t) for t in p)


def add_bias_plain(f: FieldSpec, p, bias):
    """p + bias on every lane of a 4-tuple of (W, C) coords (bias: four
    (W,) coords, the second operand), or p when bias is None."""
    if bias is None:
        return p
    return add_xyzz_plain(f, p, tuple(b[:, None].expand_as(t) for b, t in zip(bias, p)))


def lane_suffix_scan_plain(f: FieldSpec, u, bias=None):
    """Plain twin of ``lane_suffix_scan``: the JAX package's Hillis-Steele
    loop, one complete add over the whole lane axis per step, on u + bias,
    then + bias."""
    C = u[0].shape[-1]
    wk = shift_lanes(add_bias_plain(f, u, bias), 1)
    for i in range(max(C - 1, 0).bit_length()):
        wk = add_xyzz_plain(f, wk, shift_lanes(wk, 1 << i))
    return add_bias_plain(f, wk, bias)


def lane_fold_plain(f: FieldSpec, pts, bias=None):
    """Plain twin of ``lane_fold``: the JAX package's fold in half on
    pts + bias; the result is lane 0.  Its step i adds lane c + C/2^(i+1)
    to lane c at fixed width; lane 0 reads only the lower half, so halving
    the width each step gives its words with half the adds."""
    C = pts[0].shape[-1]
    assert C & (C - 1) == 0
    pts = add_bias_plain(f, pts, bias)
    while C > 1:
        C //= 2
        pts = add_xyzz_plain(f, tuple(t[..., :C] for t in pts), tuple(t[..., C:] for t in pts))
    return tuple(t[..., 0].contiguous() for t in pts)


def _lanes_in(f: FieldSpec, p, bias=None):
    """Check a 4-tuple of (W, C) CUDA coords for the lane kernels, and the
    bias (four (W,) coords) when given; returns W, C and the bias's four
    pointers (null without one)."""
    for t in p:
        if t.ndim != 2 or t.shape != p[0].shape:
            raise ValueError(f"lane coords must be four (W, C) tensors, got {t.shape}")
    W = check_cuda(f, *p).W
    if bias is None:
        return W, p[0].shape[1], (None,) * 4
    for b in bias:
        if b.shape != (W,):
            raise ValueError(f"the bias must be four ({W},) tensors, got {b.shape}")
    check_cuda(f, p[0], *bias)
    return W, p[0].shape[1], tuple(b.data_ptr() for b in bias)


def lane_suffix_scan(f: FieldSpec, u, bias=None):
    """Exclusive suffix sums over the lanes of a 4-tuple of (W, C) XYZZ
    coords; with a bias point (four (W,) coords), of u + bias, plus bias:
    out[c] = sum_{c' > c} (u[c'] + bias) + bias, in the JAX order of adds.
    CPU tensors take ``lane_suffix_scan_plain``; CUDA tensors launch the
    scan kernel (one cooperative launch) or raise."""
    if u[0].device.type == "cpu":
        return lane_suffix_scan_plain(f, u, bias)
    W, C, bp = _lanes_in(f, u, bias)
    outs = tuple(torch.empty_like(t) for t in u)
    if C:
        buf = torch.empty((2, 4, W, C), dtype=u[0].dtype, device=u[0].device)
        _build.launch("tt_lane_suffix_scan", *(t.data_ptr() for t in u), *bp, buf.data_ptr(),
                      *(o.data_ptr() for o in outs), C, consts_ptr(f), W)
        count_launch(lane_suffix_scan, f)
    return outs


def lane_fold(f: FieldSpec, pts, out=None, bias=None):
    """The sum of a 4-tuple of (W, C) XYZZ coords over the lanes (C a power
    of two), each lane plus the bias point first when given (four (W,)
    coords), as 4 (W,) coords, written into ``out`` when given: four (W,)
    tensors of one stride, such as column k of four (W, nwin) arrays.  CPU
    tensors take ``lane_fold_plain``; CUDA tensors launch the fold kernel
    (one block; C <= 512) or raise."""
    if pts[0].device.type == "cpu":
        res = lane_fold_plain(f, pts, bias)
        if out is None:
            return res
        for o, t in zip(out, res):
            o.copy_(t)
        return tuple(out)
    W, C, bp = _lanes_in(f, pts, bias)
    if C & (C - 1) or not 1 <= C <= 512:
        raise ValueError(f"lane_fold takes a power of two up to 512 lanes, got {C}")
    if out is None:
        out = tuple(torch.empty((W,), dtype=t.dtype, device=t.device) for t in pts)
    stride = out[0].stride(0)
    for o in out:
        if o.shape != (W,) or o.stride(0) != stride or o.dtype != torch.int32 \
                or o.device != pts[0].device:
            raise ValueError(f"out must be four int32 ({W},) tensors of one stride on "
                             f"{pts[0].device}")
    _build.launch("tt_lane_fold", *(t.data_ptr() for t in pts), *bp,
                  *(o.data_ptr() for o in out), stride, C, consts_ptr(f), W)
    count_launch(lane_fold, f)
    return tuple(out)


def horner_plain(f: FieldSpec, wins, c: int):
    """Plain twin of ``horner``: the loop of ``dbl_xyzz_plain`` and
    ``add_xyzz_plain`` that the JAX package runs across windows."""
    zero = torch.zeros_like(wins[0][:, 0])
    acc = (zero, zero.clone(), zero.clone(), zero.clone())
    for k in range(wins[0].shape[1] - 1, -1, -1):
        for _ in range(c):
            acc = dbl_xyzz_plain(f, acc)
        acc = add_xyzz_plain(f, acc, tuple(t[:, k] for t in wins))
    return acc


def horner(f: FieldSpec, wins, c: int):
    """sum_k 2^(c k) win[k] by Horner from infinity, MSB window first:
    acc = 2^c acc + win[k] with c doublings and one complete add.  wins: a
    4-tuple of (W, nwin) XYZZ coords, column k = window k; returns 4 (W,)
    coords.  CPU tensors take ``horner_plain``; CUDA tensors launch the
    Horner kernel (one launch, one thread) or raise."""
    if wins[0].device.type == "cpu":
        return horner_plain(f, wins, c)
    W, nwin, _ = _lanes_in(f, wins)
    if nwin < 1 or c < 0:
        raise ValueError(f"horner takes at least one window and c >= 0, got {nwin}, {c}")
    outs = tuple(torch.empty((W,), dtype=t.dtype, device=t.device) for t in wins)
    _build.launch("tt_horner_xyzz", *(t.data_ptr() for t in wins), *(o.data_ptr() for o in outs),
                  nwin, c, consts_ptr(f), W)
    count_launch(horner, f)
    return outs


add_xyzz.launches = 0
add_xyzz.launches_by_form = {}
dbl_xyzz.launches = 0
dbl_xyzz.launches_by_form = {}
madd_xyzz.launches = 0
madd_xyzz.launches_by_form = {}
scalar_mul.launches = 0
scalar_mul.launches_by_form = {}
lane_suffix_scan.launches = 0
lane_suffix_scan.launches_by_form = {}
lane_fold.launches = 0
lane_fold.launches_by_form = {}
horner.launches = 0
horner.launches_by_form = {}
