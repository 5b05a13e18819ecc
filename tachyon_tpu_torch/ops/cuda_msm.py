"""K5 and K6: the Pippenger bucket-phase sweeps as hand-written CUDA
kernels, and between them the window's T-gather add (K2 at the buckets).

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
in VMEM scratch.  Blocks on Hopper run in no order.  A loop over the rows
inside one thread per lane (``csrc/msm_sweeps.cu``) gives, at 2^22 points,
4096 threads on 132 SMs for K5, each a chain of 1024 mixed adds, and 512
threads for K6, each a chain of 256 adds: latency, far above their bounds.
So both cut each lane's R rows into S segments.  K5 runs a two-level
suffix scan in three launches (segment totals from D; carries
Cin[s] = (Cin[s+1] + T[s+1]) + (-D) with the complete add, one thread per
lane; every row emitted from Cin[s]), with S x C threads in the two
sweeping launches; ``segments`` picks S.  K6 is a plain sum, so it needs
no carries: S x C threads sum their segments from D into T[s], then a
tree of complete adds (T[a] + T[b]) + (-D) over a lane's partials, in two
launches; ``reduce_segments`` picks S.

**K5's words differ from the TPU kernel's; its points do not.**  The
segments change the order of additions, so every row outside the top
segment holds other XYZZ coordinates (X, Y, ZZ, ZZZ scaled by another
lambda^2, lambda^3) of the same point D + sum_{r' >= r} P[r', c].  The top
segment starts from D as before and keeps the TPU's words.  The MSM only
adds these rows, so its result does not move.
``suffix_sweep_segmented_plain`` is the twin of the three phases, word for
word; ``suffix_sweep_plain`` is the sequential twin of the TPU kernel,
equal to it as points.

**K6's words differ from the TPU kernel's for S > 1, too.**  Its total
D + sum_r Q[r, c] is the same point in other XYZZ words; at S = 1 (phase 1
alone) the words are the TPU kernel's.  The MSM's next steps, red + (-D2)
and the fold, only add these points, so its affine result does not move.
``reduce_sweep_segmented_plain`` is the twin of the two phases, word for
word; ``reduce_sweep_plain`` stays the sequential twin (the CPU path),
equal to ``reduce_sweep_jnp`` word for word.

``bucket_add`` is K2 (``tachyon_tpu/ops/pallas_ec.py`` ``_add_call``,
``pl.pallas_call`` at line 209) redesigned for the window's T-gather with
the XLA glue around it (``tachyon_tpu/math/msm.py:348-361``): at every
bucket start pos, T[pos % R, :, pos // R] + W''[:, pos // R], infinity
where the digit is absent and on the pad bucket, written straight into
K6's (R2, W, C2) rows, in one launch (``csrc/buckets.cu``).  It reads K5's
(R, W, C) output as K5 writes it.  ``bucket_add_plain`` is the JAX
package's code in PyTorch, word for word.

The plain twins follow ``suffix_sweep_jnp`` / ``reduce_sweep_jnp``: row by
row with the complete formulas.  From a blind D they agree bit for bit with
the blinded kernels (the skipped branches need D + partial sum = +-P).
The public layouts are the JAX package's: points ``(R, W, C)``, infinity
flags ``(R, 1, C)``, blinds and totals ``(W, C)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.ops import _build, mont
from tachyon_tpu_torch.ops.cuda_ec import add_xyzz_plain, madd_xyzz_plain
from tachyon_tpu_torch.ops.cuda_mont import check_cuda, consts_ptr, count_launch


def suffix_sweep_plain(f: FieldSpec, x, y, inf, d):
    """Plain twin of K5 as the TPU computes it: rows bottom-up with the
    complete mixed add."""
    R = x.shape[0]
    acc = tuple(d)
    rows = [None] * R
    for r in range(R - 1, -1, -1):
        acc = madd_xyzz_plain(f, acc, x[r], y[r], inf[r, 0] != 0)
        rows[r] = acc
    return tuple(torch.stack([row[k] for row in rows]) for k in range(4))


SWEEP_BLOCKS_PER_SM = 2   # where S stops growing
SWEEP_MIN_SEGMENTS = 4    # below this, one segment


def segments(R: int, C: int, sms: int, threads: int) -> int:
    """K5's segment count S for R rows x C lanes on a card of ``sms`` SMs,
    with ``threads`` per block in phases 1 and 3 (the kernel library's
    ``tt_suffix_sweep_threads``).

    A thread of phases 1 and 3 sweeps R / S rows twice, and each segment
    adds two complete adds to the serial carry chain of phase 2, which cost
    about 8 rows on the H100 (PERF.md).  So 2R / S + 8S rows is least
    near S = sqrt(R) / 2.  Below 4 segments the carries eat the gain
    (2 never gains: its threads sweep R rows as one does), so S = 1 there:
    R < 64.  S also stops where phases 1 and 3 hold two blocks per SM:
    beyond that they measured no faster (bound by the field multiply's
    rate), while the carries grow.  Then cut to ceil(R / L) for
    L = ceil(R / S) rows per segment, so that no segment is empty."""
    fill = SWEEP_BLOCKS_PER_SM * sms * threads // max(C, 1)
    S = min(math.isqrt(R) // 2, fill)
    if S < SWEEP_MIN_SEGMENTS:
        return 1
    L = -(-R // S)
    return -(-R // L)


def suffix_sweep_segmented_plain(f: FieldSpec, x, y, inf, d, S: int):
    """Plain twin of K5's three phases with S segments of ceil(R / S) rows
    (the top one ragged), word for word: segment totals T[s] from D, carries
    Cin[S-1] = D, Cin[s] = (Cin[s+1] + T[s+1]) + (-D) with the complete
    add, then every row of segment s from Cin[s].  Equal to
    ``suffix_sweep_plain`` as points; the top segment's words are equal."""
    R = x.shape[0]
    L = -(-R // S)
    bounds = [(s * L, min((s + 1) * L, R)) for s in range(S)]

    def sweep(acc, lo, hi, rows=None):
        for r in range(hi - 1, lo - 1, -1):
            acc = madd_xyzz_plain(f, acc, x[r], y[r], inf[r, 0] != 0)
            if rows is not None:
                rows[r] = acc
        return acc

    d = tuple(d)
    nd = (d[0], mont.neg(f, d[1]), d[2], d[3])
    cin = [d] * S
    for s in range(S - 2, -1, -1):
        total = sweep(d, *bounds[s + 1])
        cin[s] = add_xyzz_plain(f, add_xyzz_plain(f, cin[s + 1], total), nd)
    rows = [None] * R
    for s in range(S):
        sweep(cin[s], *bounds[s], rows)
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


class SweepPlan(NamedTuple):
    """K5's launches on one input: the outputs, the scratch they write, the
    segment count and the (launcher, args) of the three phases in order."""
    outs: tuple
    scratch: tuple
    S: int
    launches: list


def suffix_sweep_plan(f: FieldSpec, x, y, inf, d, S: int | None = None) -> SweepPlan:
    """Allocate K5's outputs and scratch for CUDA inputs and list its three
    launches (none for an empty input); ``suffix_sweep`` runs them.  S
    defaults to ``segments``; a given S is cut to 1 .. R with no segment
    empty (``chip_smoke.py`` times the kernel at S = 1 against it)."""
    R, W, C = _check_sweep(f, (x, y), d, inf)
    outs = tuple(torch.empty_like(x) for _ in range(4))
    if not (R and C):
        return SweepPlan(outs, (), 0, [])
    if S is None:
        S = segments(R, C, torch.cuda.get_device_properties(x.device).multi_processor_count,
                     _build.library().tt_suffix_sweep_threads())
    L = -(-R // max(1, min(R, S)))
    S = -(-R // L)
    tot, cin = (torch.empty((S - 1, 4, W, C), dtype=x.dtype, device=x.device) for _ in range(2))
    dp = [t.data_ptr() for t in d]
    consts = consts_ptr(f)
    launches = [
        ("tt_suffix_totals", (x.data_ptr(), y.data_ptr(), inf.data_ptr(), *dp, tot.data_ptr(),
                              R, C, L, S, consts, W)),
        ("tt_suffix_carries", (tot.data_ptr(), *dp, cin.data_ptr(), C, S, consts, W)),
        ("tt_suffix_emit", (x.data_ptr(), y.data_ptr(), inf.data_ptr(), *dp, cin.data_ptr(),
                            *(o.data_ptr() for o in outs), R, C, L, S, consts, W)),
    ]
    return SweepPlan(outs, (tot, cin), S, launches)


def run_plan(plan: SweepPlan) -> None:
    """Launch a plan's kernels in order."""
    for name, args in plan.launches:
        _build.launch(name, *args)


def suffix_sweep(f: FieldSpec, x, y, inf, d):
    """x, y: (R, W, C) sorted affine coords; inf: (R, 1, C) int32 flags;
    d: 4-tuple of (W, C) blind coords.  Returns 4 arrays (R, W, C) with
    suffix[r, :, c] = D + sum_{r' >= r} P[r', c].  CPU tensors take
    ``suffix_sweep_plain``; CUDA tensors launch K5's three phases or raise."""
    if x.device.type == "cpu":
        return suffix_sweep_plain(f, x, y, inf, d)
    plan = suffix_sweep_plan(f, x, y, inf, d)
    run_plan(plan)
    if plan.launches:
        count_launch(suffix_sweep, f)
    return plan.outs


REDUCE_BLOCKS_PER_SM = 2   # where K6's S stops growing
REDUCE_ROWS_PER_SEGMENT = 8


def reduce_segments(R: int, C: int, sms: int, threads: int) -> int:
    """K6's segment count S for R rows x C lanes on a card of ``sms`` SMs,
    with ``threads`` per block in phase 1 (the kernel library's
    ``tt_reduce_sweep_threads``).

    A thread of phase 1 adds R / S rows, ~8 us each on the H100, and
    phase 2 adds a lane's S partials in ceil(log2 S) tree levels of two
    complete adds, ~45 us a level (PERF.md).  R / S + 5.6 log2 S rows is
    least near S = R / 8, which was the fastest S timed at R = 16, 64 and
    256: 8 rows a segment, and one segment below R = 16.  S also stops
    where phase 1 holds two blocks per SM.  Then cut to ceil(R / L) for
    L = ceil(R / S) rows per segment, so that no segment is empty."""
    fill = REDUCE_BLOCKS_PER_SM * sms * threads // max(C, 1)
    S = max(1, min(R // REDUCE_ROWS_PER_SEGMENT, fill))
    L = -(-R // S)
    return -(-R // L)


def combine_fan(S: int, limit: int) -> int:
    """Threads per lane in K6's phase 2 for S partials: a tree, pairs first
    (ceil(S / 2) rounded up to a power of two), at most ``limit`` (the
    kernel library's ``tt_reduce_combine_threads``)."""
    return min(1 << max(S - 1, 1).bit_length() - 1, limit)


def reduce_sweep_segmented_plain(f: FieldSpec, xyzz, d, S: int, F: int):
    """Plain twin of K6's two phases with S segments of ceil(R / S) rows
    (the top one ragged), word for word: T[s] = D + the segment's rows with
    the complete add, then F threads per lane (as launched: ``combine_fan``,
    or 1 for the chain): chains of G = ceil(S / F) partials,
    u = (u + T[j]) + (-D), and a tree u[g] = (u[g] + u[g + h]) + (-D) over
    the chains' results.  Equal to ``reduce_sweep_plain`` as points, and
    word for word at S = 1."""
    R = xyzz[0].shape[0]
    L = -(-R // max(1, min(R, S)))
    S = -(-R // L)
    d = tuple(d)
    nd = (d[0], mont.neg(f, d[1]), d[2], d[3])
    T = [reduce_sweep_plain(f, tuple(t[s * L:(s + 1) * L] for t in xyzz), d) for s in range(S)]

    def step(a, b):
        return add_xyzz_plain(f, add_xyzz_plain(f, a, b), nd)

    G = -(-S // F)
    u = []
    for j0 in range(0, S, G):
        acc = T[j0]
        for j in range(j0 + 1, min(j0 + G, S)):
            acc = step(acc, T[j])
        u.append(acc)
    h = 1
    while h < len(u):
        for g in range(0, len(u) - h, 2 * h):
            u[g] = step(u[g], u[g + h])
        h *= 2
    return u[0]


def reduce_sweep_plan(f: FieldSpec, xyzz, d, S: int | None = None,
                      F: int | None = None) -> SweepPlan:
    """Allocate K6's output and scratch for CUDA inputs and list its
    launches (phase 1, then phase 2 when S > 1); ``reduce_sweep`` runs
    them.  With no rows the output is a copy of D and there is no launch.
    S defaults to ``reduce_segments`` and F to ``combine_fan``; a given S is
    cut to 1 .. R with no segment empty (``chip_smoke.py`` times the kernel
    at other S and F)."""
    R, W, C = _check_sweep(f, xyzz, d)
    out = torch.empty((4, W, C), dtype=xyzz[0].dtype, device=xyzz[0].device)
    outs = tuple(out.unbind(0))
    if not (R and C):
        for o, t in zip(outs, d):
            o.copy_(t)
        return SweepPlan(outs, (), 0, [])
    lib = _build.library()
    if S is None:
        S = reduce_segments(R, C,
                            torch.cuda.get_device_properties(out.device).multi_processor_count,
                            lib.tt_reduce_sweep_threads())
    L = -(-R // max(1, min(R, S)))
    S = -(-R // L)
    dp = [t.data_ptr() for t in d]
    consts = consts_ptr(f)
    tot = out if S == 1 else torch.empty((S, 4, W, C), dtype=out.dtype, device=out.device)
    launches = [("tt_reduce_partials", (*(t.data_ptr() for t in xyzz), *dp, tot.data_ptr(),
                                        R, C, L, S, consts, W))]
    if S > 1:
        F = F or combine_fan(S, lib.tt_reduce_combine_threads())
        launches.append(("tt_reduce_combine", (tot.data_ptr(), *dp, out.data_ptr(), C, S, F,
                                               consts, W)))
    return SweepPlan(outs, (tot,), S, launches)


def reduce_sweep(f: FieldSpec, xyzz, d):
    """xyzz: 4-tuple of (R, W, C); d: 4-tuple of (W, C) blind coords.
    Returns 4 arrays (W, C): D + column sums.  CPU tensors take
    ``reduce_sweep_plain``; CUDA tensors launch K6's two phases or raise."""
    if xyzz[0].device.type == "cpu":
        return reduce_sweep_plain(f, xyzz, d)
    plan = reduce_sweep_plan(f, xyzz, d)
    run_plan(plan)
    if plan.launches:
        count_launch(reduce_sweep, f)
    return plan.outs


def bucket_add_plain(f: FieldSpec, t, wpp, pos, C2: int):
    """Plain twin of ``bucket_add``: the JAX package's gathers at the bucket
    starts, the complete add, the mask, the pad to B and the reshape, then
    K6's row layout."""
    R, W, C = t[0].shape
    valid = pos < R * C
    posc = torch.where(valid, pos, 0).long()
    tg = tuple(x.permute(1, 0, 2)[:, posc % R, posc // R] for x in t)
    wg = tuple(x[:, posc // R] for x in wpp)
    tv = add_xyzz_plain(f, tg, wg)
    tv = tuple(torch.where(valid[None], x, 0) for x in tv)
    B = pos.shape[0] + 1
    return tuple(torch.nn.functional.pad(x, (0, 1)).reshape(W, B // C2, C2)
                 .permute(1, 0, 2).contiguous() for x in tv)


def bucket_add(f: FieldSpec, t, wpp, pos, C2: int):
    """The window's T values at the bucket starts as K6's rows: t, four
    (R, W, C) coords (K5's suffix sums); wpp, four (W, C) coords (W'', the
    biased lane scan's sums); pos, the (B - 1,) int32 first sorted index of
    each digit 1 .. B - 1, R C where it is absent.  Returns four
    (B / C2, W, C2) coords: bucket j at row j // C2, lane j % C2, equal to
    t[pos % R, :, pos // R] + wpp[:, pos // R], infinity for an absent
    digit and for the pad bucket j = B - 1.  CPU tensors take
    ``bucket_add_plain``; CUDA tensors launch the bucket kernel or raise."""
    if t[0].device.type == "cpu":
        return bucket_add_plain(f, t, wpp, pos, C2)
    R, W, C = t[0].shape
    B = pos.shape[0] + 1
    if any(x.shape != (R, W, C) for x in t) or any(x.shape != (W, C) for x in wpp):
        raise ValueError(f"t must be four (R, W, C) = {(R, W, C)} and wpp four (W, C) tensors")
    if pos.ndim != 1 or C2 < 1 or B % C2:
        raise ValueError(f"pos must be (B - 1,) with C2 = {C2} dividing B = {B}")
    check_cuda(f, *t, *wpp, pos)
    out = torch.empty((4, B // C2, W, C2), dtype=t[0].dtype, device=t[0].device)
    outs = tuple(out.unbind(0))
    _build.launch("tt_bucket_add", *(x.data_ptr() for x in (*t, *wpp, pos, *outs)),
                  R, C, B, C2, consts_ptr(f), W)
    count_launch(bucket_add, f)
    return outs


suffix_sweep.launches = 0
suffix_sweep.launches_by_form = {}
reduce_sweep.launches = 0
reduce_sweep.launches_by_form = {}
bucket_add.launches = 0
bucket_add.launches_by_form = {}
