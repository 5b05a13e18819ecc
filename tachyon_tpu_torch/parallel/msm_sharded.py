"""Multi-GPU MSM: points and windows sharded over a device mesh.

Port of ``tachyon_tpu/parallel/msm_sharded.py`` (reference: msm/algorithms/
pippenger/pippenger_adapter.h:15-100, the kParallelTerm, kParallelWindow
and kParallelWindowAndTerm strategies, lifted from threads to GPUs).
Every function takes the global points and scalars, as the JAX functions
do; each rank takes its block by its coordinate on the mesh axis
(``mesh.local_block``), runs the port's single-device code on it (the
MSM's kernels on the card), all_gathers the partial XYZZ words and
tree-adds them, so the result is replicated on every rank.  Field
arithmetic is exact, so the point is the same whatever the mesh's shape.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ, SWCurve
from tachyon_tpu_torch.math.msm import _tree_reduce, digit_decompose, fold_windows, msm, window_sums
from tachyon_tpu_torch.parallel.mesh import axis_index, axis_size, gather_blocks, local_block


def _local_points(points: AffinePoint, mesh: DeviceMesh, axis: str | None) -> AffinePoint:
    return AffinePoint(local_block(points.x, mesh, axis), local_block(points.y, mesh, axis),
                       local_block(points.inf, mesh, axis))


def _gather(p: PointXYZZ, mesh: DeviceMesh, axis: str | None) -> PointXYZZ:
    """Each coordinate's blocks of every rank on the axis, along the last axis."""
    return PointXYZZ(*(gather_blocks(t, mesh, axis) for t in p))


def msm_sharded(curve: SWCurve, mesh: DeviceMesh, points: AffinePoint,
                scalars: torch.Tensor, c: int | None = None, axis: str = "dp") -> PointXYZZ:
    """The MSM with points and scalars sharded on the element axis over the
    mesh axis: each rank runs ``msm`` on its block, the partial points are
    gathered and tree-added."""
    local = msm(curve, _local_points(points, mesh, axis), local_block(scalars, mesh, axis), c=c)
    partials = _gather(PointXYZZ(*(t[..., None] for t in local)), mesh, axis)
    return _tree_reduce(curve, partials, axis_size(mesh, axis))


def msm_sharded_windows(curve: SWCurve, mesh: DeviceMesh, points: AffinePoint,
                        scalars: torch.Tensor, c: int, window_axis: str = "win") -> PointXYZZ:
    """Window parallelism (kParallelWindow, pippenger.h:157): the points
    replicated, the Pippenger windows sharded over the mesh axis."""
    return msm_sharded_2d(curve, mesh, points, scalars, c, point_axis=None,
                          window_axis=window_axis)


def msm_sharded_2d(curve: SWCurve, mesh: DeviceMesh, points: AffinePoint,
                   scalars: torch.Tensor, c: int, point_axis: str | None = "dp",
                   window_axis: str = "win") -> PointXYZZ:
    """Points x windows (kParallelWindowAndTerm, pippenger_adapter.h:75-80).
    Each rank sums ITS windows over ITS point block (point_axis=None
    replicates the points); the raw window sums are gathered over the
    window axis, then over the point axis, tree-added per window, and one
    Horner over all W windows (W c doublings, the same on every rank) gives
    the point, as the JAX function's replicated scan does.

    scalars: (Ws, n) plain words; W = ceil(bits / c) must divide by the
    window axis's size."""
    win_dev = axis_size(mesh, window_axis)
    total_bits = curve.SF.spec.bits
    W = (total_bits + c - 1) // c
    if W % win_dev:
        raise ValueError(f"{W} windows do not split over {win_dev} ranks")
    Wk = W // win_dev
    w0 = axis_index(mesh, window_axis) * Wk
    local = _local_points(points, mesh, point_axis)
    digits = digit_decompose(local_block(scalars, mesh, point_axis), total_bits, c)
    wins = window_sums(curve, local, digits[w0:w0 + Wk], c)  # (*coord, Wk)
    wins = _gather(wins, mesh, window_axis)  # (*coord, W), window order
    if point_axis is not None:  # (*coord, W, pd): the point blocks' sums of each window
        parts = _gather(PointXYZZ(*(t[..., None] for t in wins)), mesh, point_axis)
        wins = _tree_reduce(curve, parts, axis_size(mesh, point_axis))
    return fold_windows(curve, wins, c)
