"""Pippenger multi-scalar multiplication in the suffix-sweep form.

Port of ``tachyon_tpu/math/msm.py``; see its module docstring for the
design.  For one c-bit window with the points sorted by digit,

    window = sum_i d_i P_i = sum_{b=1}^{2^c - 1} T[pos_b],

with T[j] = sum_{i >= j} P_i over the sorted array and
pos_b = searchsorted(d_sorted, b).  Per window: one stable sort, a gather
into C lanes x R rows, the K5 sweep (per-lane suffix sums from a blind D),
a Hillis-Steele scan of the lane totals (one launch of the lane scan, K2's
add, which also takes off and puts back the blind: u = suffix[0] - D in,
W'' = W - D out), the T-gather add at the bucket starts (one launch of the
bucket kernel, ``cuda_msm.bucket_add``, straight into K6's rows), the K6
sweep and a fold (one launch of the lane fold, which takes off K6's blind
from every lane first, into the window's column of a (W, nwin) array);
then Horner across all windows in one launch (``cuda_ec.horner``: K3's
doublings and K2's add in one thread).  The blinds' broadcasts over the
lanes are made once per MSM.
As in the JAX package, n <= 128 takes the naive path instead: a batched
double-and-add (``scalar_mul``: one launch of the fused ladder) and a tree
reduce (K2).

Curves without point kernels (G2 over Fq2; ``SWCurve._kernel_ok`` false)
take the JAX package's generic path (``_window_sum_generic``): the same window
with the complete formulas in field ops (K1 for every base multiply on the
card) and the blinds at infinity.  The sweeps are row loops of the generic
mixed add and add (``suffix_sweep_jnp`` / ``reduce_sweep_jnp``), the lane
scan and fold loops of the generic add, the T-gather an add with its
``where`` and pad, Horner c doublings and an add per window; the points
are gathered unpacked, with the infinity flags beside them (pad lanes at
infinity).  Adding an infinite blind leaves a point's words as they are,
so those adds are skipped.

The XLA steps that are not Pallas kernels map to PyTorch calls:
``lax.sort_key_val`` -> ``torch.sort(stable=True)``, ``jnp.take`` ->
indexing, ``jnp.searchsorted`` -> ``torch.searchsorted``; the window
loop -> a Python loop, and Horner's ``fori_loop`` over K3 and K2 and the
lane scan's and fold's ``fori_loop`` over K2 -> one kernel each; the
T-gather's takes, add, where, pad and reshape -> the bucket kernel.
"""
from __future__ import annotations

import functools
import math

import torch

from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ, SWCurve
from tachyon_tpu_torch.ops import cuda_ec, cuda_msm, mont


def optimal_window_bits(bits: int, n: int) -> int:
    """ln(n) + 2, clamped to [10, 17] (as in the JAX package)."""
    c = int(math.log(max(n, 2)) + 2.0)
    return max(10, min(c, 17))


def digit_decompose(scalars: torch.Tensor, total_bits: int, c: int) -> torch.Tensor:
    """(Ws, n) plain int32 scalar words -> (nwin, n) int32 digits in [0, 2^c).
    A digit of c <= 32 bits spans at most two words; the work is in int64."""
    Ws = scalars.shape[0]
    w = mont.widen(scalars)
    nwin = (total_bits + c - 1) // c
    mask = (1 << c) - 1
    digs = []
    for k in range(nwin):
        o = k * c
        i0, sh = o // 32, o % 32
        v = w[i0] >> sh
        if sh + c > 32 and i0 + 1 < Ws:
            v = v | (w[i0 + 1] << (32 - sh))
        digs.append(v & mask)
    return torch.stack(digs).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _blind_ints(curve_key: tuple):
    gen_x, gen_y, mod, order = curve_key
    return host_ec.blind_points((gen_x, gen_y), 0, mod, order)


def _blind_points(curve: SWCurve):
    """The two sweep blind points and their negations as XYZZ words (zz =
    zzz = mont(1)), equal to the JAX package's ``_blind_points``."""
    F = curve.F
    pts = []
    for x, y in _blind_ints((int(curve.gen_x), int(curve.gen_y), F.p, curve.SF.p)):
        one = F.encode(1)
        p = PointXYZZ(F.encode(x), F.encode(y), one, one.clone())
        pts.append((p, PointXYZZ(p.x, F.encode(-y % F.p), one, one.clone())))
    return pts


def _bcast(p: PointXYZZ, shape) -> PointXYZZ:
    """Broadcast a single point to a batch shape (contiguous copies)."""
    return PointXYZZ(*(t.reshape(t.shape + (1,) * len(shape))
                       .expand(t.shape + tuple(shape)).contiguous() for t in p))


def _shift_left(p: PointXYZZ, s: int) -> PointXYZZ:
    """Lane shift along the last axis: out[..., c] = p[..., c + s], with
    infinity (all-zero coordinates) shifted in at the end."""
    return PointXYZZ(*cuda_ec.shift_lanes(tuple(p), s))


def _suffix_scan_lanes(curve: SWCurve, u: PointXYZZ, bias: PointXYZZ | None = None) -> PointXYZZ:
    """EXCLUSIVE suffix sums over the last axis: out[c] = sum_{c' > c} u[c']
    (Hillis-Steele, log C steps; one kernel launch on the card); with a
    bias point, of u + bias, plus bias."""
    return PointXYZZ(*cuda_ec.lane_suffix_scan(curve.F.spec, tuple(u),
                                               None if bias is None else tuple(bias)))


def _fold_reduce_lanes(curve: SWCurve, pts: PointXYZZ, out=None,
                       bias: PointXYZZ | None = None) -> PointXYZZ:
    """Sum over the last axis (power-of-two length) by folding in half at
    fixed width; the result is lane 0 (one kernel launch on the card),
    written into ``out`` (four (W,) views) when given; with a bias point,
    of pts + bias."""
    return PointXYZZ(*cuda_ec.lane_fold(curve.F.spec, tuple(pts), out,
                                        None if bias is None else tuple(bias)))


def _sweep_suffix(curve: SWCurve, gx, gy, ginf, dc: PointXYZZ) -> PointXYZZ:
    """gx/gy: (W, R, C) sorted coords, ginf (R, C), dc the blind on C lanes
    -> suffix sums (R, W, C) with suffix[r, :, c] = D + sum_{r' >= r} P[:, r', c]."""
    x_r = gx.permute(1, 0, 2).contiguous()  # (R, W, C) rows for the sweep
    y_r = gy.permute(1, 0, 2).contiguous()
    inf_r = ginf.to(torch.int32)[:, None, :].contiguous()
    return PointXYZZ(*cuda_msm.suffix_sweep(curve.F.spec, x_r, y_r, inf_r, tuple(dc)))


def _window_sum(curve: SWCurve, packed, dw, C, R, B, blinds, out=None) -> PointXYZZ:
    """One Pippenger window: sum_i dw_i * P_i via the sorted suffix-sum
    identity.  packed: (2W, R*C) words, x then y, all zero at infinity;
    dw: (R*C,) int32 digits in [0, B); blinds: D1 on K5's C lanes, -D1,
    D2 on K6's min(512, B) lanes, -D2; out: four (W,) views to write the
    sum into, or None."""
    dc1, nd1, dc2, nd2 = blinds
    W = packed.shape[0] // 2
    d_s, order = torch.sort(dw, stable=True)
    idx2 = order.reshape(C, R).t().reshape(-1)  # (R*C,): item c*R + r
    g = packed.index_select(1, idx2).reshape(2 * W, R, C)
    ginf = (g == 0).all(dim=0)
    suffix = _sweep_suffix(curve, g[:W], g[W:], ginf, dc1)
    # the true column totals U = suffix[0] - D, their exclusive lane-suffix
    # scan Wk[c] = sum_{c' > c} U[c'], and W'' = Wk - D, in one scan
    wpp = _suffix_scan_lanes(curve, PointXYZZ(*(t[0] for t in suffix)), nd1)
    # T + W'' at the bucket starts (sorted index k -> row k % R, lane k // R),
    # B - 1 buckets and one infinity, as K6's (B / C2, W, C2) rows
    bq = torch.arange(1, B, dtype=dw.dtype, device=dw.device)
    pos = torch.searchsorted(d_s, bq, out_int32=True)  # (B-1,) in [0, n_pad]
    rows = cuda_msm.bucket_add(curve.F.spec, tuple(suffix), tuple(wpp), pos, min(512, B))
    red = cuda_msm.reduce_sweep(curve.F.spec, rows, tuple(dc2))  # (W, C2), D2-biased lanes
    return _fold_reduce_lanes(curve, red, out, nd2)  # unbias every lane, then sum


def _tree_reduce(curve: SWCurve, pts: PointXYZZ, axis_len: int) -> PointXYZZ:
    """Sum a vector of axis_len XYZZ points (last axis) to one point: pad
    with infinity to a power of two, then add halves (K2)."""
    m = 1 << max(axis_len - 1, 0).bit_length()
    if m != axis_len:
        pts = PointXYZZ(*(torch.nn.functional.pad(t, (0, m - axis_len)) for t in pts))
    while m > 1:
        half = m // 2
        pts = curve.add_xyzz(PointXYZZ(*(t[..., :half].contiguous() for t in pts)),
                             PointXYZZ(*(t[..., half:].contiguous() for t in pts)))
        m = half
    return PointXYZZ(*(t[..., 0].contiguous() for t in pts))


def _msm_naive(curve: SWCurve, points: AffinePoint, scalars: torch.Tensor) -> PointXYZZ:
    """Small-n MSM: a batched double-and-add (``scalar_mul``, the fused
    ladder) and a tree reduce."""
    n = scalars.shape[1]
    return _tree_reduce(curve, curve.scalar_mul(points, scalars), n)


MSM_NAIVE_THRESHOLD = 128


def _layout_and_blinds(curve: SWCurve, n: int):
    """The (R, C) sweep layout for n points, and the blind points: at
    infinity where the curve has no point kernels (no blinding needed).
    The kernel path keeps the JAX package's lanes; the generic path (G2)
    has no kernel shapes to keep, so below 512 points it takes n lanes
    rounded up to a power of two and scans and folds no padding lanes (the
    same point)."""
    C = 4096 if n >= (1 << 15) else 512
    if curve._kernel_ok:
        return C, -(-n // C), _blind_points(curve)
    C = min(C, 1 << max(n - 1, 0).bit_length())
    inf = curve.infinity_xyzz(())
    return C, -(-n // C), ((inf, inf), (inf, inf))


def _window_sum_generic(curve: SWCurve, px, py, pinf, dw, C, R, B, d1, d2) -> PointXYZZ:
    """One window of the generic path, as the JAX package's ``_window_sum``
    with ``packed=None``: px/py (*lead, R*C) coords, pinf (R*C,) bool,
    dw (R*C,) digits; d1, d2 the (infinite) blinds."""
    n_pad = R * C
    C2 = min(512, B)
    R2 = max(1, B // C2)
    d_s, order = torch.sort(dw, stable=True)
    idx2 = order.reshape(C, R).t()  # (R, C): item c*R + r
    gx, gy, ginf = px[..., idx2], py[..., idx2], pinf[idx2]
    # suffix_sweep_jnp: rows bottom-up from D1 with the complete mixed add
    acc = _bcast(d1, (C,))
    rows = [None] * R
    for r in range(R - 1, -1, -1):
        acc = curve.madd_xyzz(acc, AffinePoint(gx[..., r, :], gy[..., r, :], ginf[r]))
        rows[r] = acc
    suffix = PointXYZZ(*(torch.stack(ts, dim=-2) for ts in zip(*rows)))  # (*lead, R, C)
    # the lane scan of the column totals (u = suffix[0] - D1, D1 at infinity)
    wk = _shift_left(PointXYZZ(*(t[..., 0, :] for t in suffix)), 1)
    for i in range(max(C - 1, 0).bit_length()):
        wk = curve.add_xyzz(wk, _shift_left(wk, 1 << i))
    # T + W'' at the bucket starts (sorted index k -> row k % R, lane k // R)
    bq = torch.arange(1, B, dtype=dw.dtype, device=dw.device)
    pos = torch.searchsorted(d_s, bq)
    valid = pos < n_pad
    posc = torch.where(valid, pos, 0)
    flat = (posc % R) * C + posc // R
    lead = px.shape[:-1]
    tg = PointXYZZ(*(t.reshape(*lead, n_pad)[..., flat] for t in suffix))
    tv = curve.add_xyzz(tg, PointXYZZ(*(t[..., posc // R] for t in wk)))
    tv = [torch.nn.functional.pad(torch.where(valid, t, 0), (0, 1)).reshape(*lead, R2, C2)
          for t in tv]
    # reduce_sweep_jnp: rows top-down from D2 with the complete add
    red = _bcast(d2, (C2,))
    for r in range(R2):
        red = curve.add_xyzz(red, PointXYZZ(*(t[..., r, :] for t in tv)))
    # the fold (unbiasing by -D2 at infinity leaves red as it is): each
    # step adds lane c + C2/2^(i+1) to lane c; lane 0 reads only the lower
    # half, so halving the width each step gives its words (a tree reduce)
    return _tree_reduce(curve, red, C2)


def window_sums(curve: SWCurve, points: AffinePoint, digits: torch.Tensor,
                c: int) -> PointXYZZ:
    """The sums of the windows in ``digits`` (k, n) over the n points, each
    as a column of four (*coord, k) tensors: the kernel window
    (``_window_sum``) on a curve with point kernels, else the generic one
    (``_window_sum_generic``)."""
    n, nwin, B = digits.shape[1], digits.shape[0], 1 << c
    C, R, ((d1, nd1), (d2, nd2)) = _layout_and_blinds(curve, n)
    n_pad = R * C
    if n_pad != n:  # pad lanes: zero coordinates, at infinity, digit 0
        digits = torch.nn.functional.pad(digits, (0, n_pad - n))
    if not curve._kernel_ok:
        px, py, pinf = points.x, points.y, points.inf
        if n_pad != n:
            px = torch.nn.functional.pad(px, (0, n_pad - n))
            py = torch.nn.functional.pad(py, (0, n_pad - n))
            pinf = torch.nn.functional.pad(pinf, (0, n_pad - n), value=True)
        wins = [_window_sum_generic(curve, px, py, pinf, digits[k], C, R, B, d1, d2)
                for k in range(nwin)]
        return PointXYZZ(*(torch.stack(ts, dim=-1) for ts in zip(*wins)))
    live = (~points.inf).to(torch.int32)[None]
    # x || y words, all zero at infinity (x = y = 0 is not on a b != 0 curve)
    packed = torch.cat([points.x * live, points.y * live], dim=0)
    if n_pad != n:
        packed = torch.nn.functional.pad(packed, (0, n_pad - n))
    wins = tuple(torch.empty((curve.F.W, nwin), dtype=torch.int32, device=packed.device)
                 for _ in range(4))
    blinds = (_bcast(d1, (C,)), nd1, _bcast(d2, (min(512, B),)), nd2)
    for k in range(nwin):
        _window_sum(curve, packed, digits[k].contiguous(), C, R, B, blinds,
                    tuple(t[:, k] for t in wins))
    return PointXYZZ(*wins)


def fold_windows(curve: SWCurve, wins: PointXYZZ, c: int) -> PointXYZZ:
    """Horner over the window sums (column k weighs 2^(c k)): acc = 2^c acc
    + window from the top window down.  One launch of the Horner kernel on
    a curve with point kernels, else c doublings and an add a window (the
    doublings of the first window's infinity are all-zero words, so they
    are skipped)."""
    if curve._kernel_ok:
        return PointXYZZ(*cuda_ec.horner(curve.F.spec, tuple(wins), c))
    nwin = wins.x.shape[-1]
    acc = curve.infinity_xyzz(())
    for k in range(nwin - 1, -1, -1):
        if k < nwin - 1:
            for _ in range(c):
                acc = curve.dbl_xyzz(acc)
        acc = curve.add_xyzz(acc, PointXYZZ(*(t[..., k] for t in wins)))
    return acc


def msm(curve: SWCurve, points: AffinePoint, scalars: torch.Tensor,
        c: int | None = None, total_bits: int | None = None) -> PointXYZZ:
    """Variable-base MSM: sum_i scalars_i * points_i -> one XYZZ point.

    points: AffinePoint with (W, n) coords ((D, W, n) over an extension
    field); scalars: (Ws, n) plain int32 words of the scalar field.
    total_bits overrides the scalar bit width.
    """
    n = scalars.shape[1]
    if n <= MSM_NAIVE_THRESHOLD:
        return _msm_naive(curve, points, scalars)
    total_bits = total_bits or curve.SF.spec.bits
    c = c or optimal_window_bits(total_bits, n)
    digits = digit_decompose(scalars, total_bits, c)  # (nwin, n)
    return fold_windows(curve, window_sums(curve, points, digits, c), c)
