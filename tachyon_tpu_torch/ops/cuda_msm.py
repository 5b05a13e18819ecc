"""K5 and K6: the Pippenger bucket-phase sweeps as hand-written CUDA kernels.

Replace the Pallas kernels of ``tachyon_tpu/ops/pallas_msm.py``:

* K5 ``_suffix_sweep_call`` (``pl.pallas_call`` at line 147, body
  ``_madd_blinded``): per lane c, starting from the blind point D,
  ``suffix[r, :, c] = D + sum_{r' >= r} P[r', c]`` for every row r, with
  the 10-multiply blinded mixed add; lanes whose point is at infinity keep
  the accumulator.
* K6 ``_reduce_sweep_call`` (``pl.pallas_call`` at line 201, body
  ``_add_blinded``): per lane, D + sum_r Q[r, c] over XYZZ rows, with only
  the q = infinity branch of add-2008-s.

The TPU walks the rows in a sequential grid and keeps the lane accumulators
in VMEM scratch.  Blocks on Hopper run in no order, so the row walk becomes
a loop inside one thread per lane (``csrc/msm_sweeps.cu``), with the
accumulator in registers.  Bound on the card: K5 at 2^22 points is 2^22
mixed adds (~1.4k word products each) over 4096 lanes, i.e. only 4096
threads on 132 SMs, so it is latency- and occupancy-bound, not
memory-bound (it streams 64 bytes in and 128 bytes out per point).  Spreading
one lane's rows over several threads is later work.

The plain twins follow ``suffix_sweep_jnp`` / ``reduce_sweep_jnp``: row by
row with the complete formulas.  From a blind D they agree bit for bit with
the blinded kernels (the skipped branches need D + partial sum = +-P).
The public layouts are the JAX package's: points ``(R, W, C)``, infinity
flags ``(R, 1, C)``, blinds and totals ``(W, C)``.
"""
from __future__ import annotations

import torch

from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.ops import _build
from tachyon_tpu_torch.ops.cuda_ec import add_xyzz_plain, madd_xyzz_plain
from tachyon_tpu_torch.ops.cuda_mont import check_cuda, consts_ptr


def suffix_sweep_plain(f: FieldSpec, x, y, inf, d):
    """Plain twin of K5: rows bottom-up with the complete mixed add."""
    R = x.shape[0]
    acc = tuple(d)
    rows = [None] * R
    for r in range(R - 1, -1, -1):
        acc = madd_xyzz_plain(f, acc, x[r], y[r], inf[r, 0] != 0)
        rows[r] = acc
    return tuple(torch.stack([row[k] for row in rows]) for k in range(4))


def reduce_sweep_plain(f: FieldSpec, xyzz, d):
    """Plain twin of K6: rows top-down with the complete add."""
    acc = tuple(d)
    for r in range(xyzz[0].shape[0]):
        acc = add_xyzz_plain(f, acc, tuple(t[r] for t in xyzz))
    return acc


def _check_sweep(f: FieldSpec, pts, d, inf=None):
    R, W, C = pts[0].shape
    for t in pts:
        if t.shape != (R, W, C):
            raise ValueError(f"points must be (R, W, C) = {(R, W, C)}, got {t.shape}")
    for t in d:
        if t.shape != (W, C):
            raise ValueError(f"blinds must be (W, C) = {(W, C)}, got {t.shape}")
    extra = [] if inf is None else [inf]
    if inf is not None and inf.shape != (R, 1, C):
        raise ValueError(f"inf must be (R, 1, C) = {(R, 1, C)}, got {inf.shape}")
    check_cuda(f, *pts, *d, *extra)
    return R, W, C


def suffix_sweep(f: FieldSpec, x, y, inf, d):
    """x, y: (R, W, C) sorted affine coords; inf: (R, 1, C) int32 flags;
    d: 4-tuple of (W, C) blind coords.  Returns 4 arrays (R, W, C) with
    suffix[r, :, c] = D + sum_{r' >= r} P[r', c].  CPU tensors take
    ``suffix_sweep_plain``; CUDA tensors launch K5 or raise."""
    if x.device.type == "cpu":
        return suffix_sweep_plain(f, x, y, inf, d)
    R, W, C = _check_sweep(f, (x, y), d, inf)
    outs = [torch.empty_like(x) for _ in range(4)]
    if R and C:
        _build.launch("tt_suffix_sweep", x.data_ptr(), y.data_ptr(), inf.data_ptr(),
                      *(t.data_ptr() for t in d), *(o.data_ptr() for o in outs),
                      R, C, consts_ptr(f), W)
        suffix_sweep.launches += 1
    return tuple(outs)


def reduce_sweep(f: FieldSpec, xyzz, d):
    """xyzz: 4-tuple of (R, W, C); d: 4-tuple of (W, C) blind coords.
    Returns 4 arrays (W, C): D + column sums.  CPU tensors take
    ``reduce_sweep_plain``; CUDA tensors launch K6 or raise."""
    if xyzz[0].device.type == "cpu":
        return reduce_sweep_plain(f, xyzz, d)
    R, W, C = _check_sweep(f, xyzz, d)
    outs = [torch.empty_like(t) for t in d]
    if C:
        _build.launch("tt_reduce_sweep", *(t.data_ptr() for t in xyzz),
                      *(t.data_ptr() for t in d), *(o.data_ptr() for o in outs),
                      R, C, consts_ptr(f), W)
        reduce_sweep.launches += 1
    return tuple(outs)


suffix_sweep.launches = 0
reduce_sweep.launches = 0
