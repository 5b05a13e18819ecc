"""Device meshes over ``torch.distributed`` for the multi-GPU paths.

Port of ``tachyon_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` over a process's devices and runs its regions under
``shard_map``; here each rank is one process with one device, a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are the
JAX axis names, and the in- and out-specs of ``shard_map`` become
``local_block`` (a rank takes its block of a global tensor by its
coordinate on an axis) and ``gather_blocks`` (the blocks of every rank on
an axis, concatenated, on every rank).

The caller initializes the process group (``nccl`` for CUDA tensors,
``gloo`` for CPU ones) with its address, world size and rank; the mesh's
device type is explicit and must match the tensors' device.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for a gloo mesh on the CPU")
    return device.type


def _check_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group first")


def data_mesh(n: int | None = None, axis: str = "dp",
              device=torch.device("cuda")) -> DeviceMesh:
    """A 1-D mesh over the first ``n`` ranks (all of them by default) with
    the axis name ``axis``.  Every rank of the world calls it."""
    _check_group()
    n = n or dist.get_world_size()
    return DeviceMesh(_device_type(device), torch.arange(n), mesh_dim_names=(axis,))


def grid_mesh(shape: tuple, axes: tuple, device=torch.device("cuda")) -> DeviceMesh:
    """A mesh of the given shape over the first prod(shape) ranks, row-major,
    with one name an axis (e.g. (2, 2) and ("dp", "win") for
    ``msm_sharded_2d``)."""
    _check_group()
    return DeviceMesh(_device_type(device), torch.arange(math.prod(shape)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str | None) -> int:
    return 1 if axis is None else mesh[axis].size()


def axis_index(mesh: DeviceMesh, axis: str | None) -> int:
    """This rank's coordinate on the axis (0 for no axis)."""
    return 0 if axis is None else mesh.get_local_rank(axis)


def local_block(t: torch.Tensor, mesh: DeviceMesh, axis: str | None,
                dim: int = -1) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` for a mesh axis (the whole
    tensor for no axis): shard_map's in-spec.  The length must divide."""
    D = axis_size(mesh, axis)
    n = t.shape[dim]
    if n % D:
        raise ValueError(f"length {n} does not split over {D} ranks of axis {axis!r}")
    return t.narrow(dim, axis_index(mesh, axis) * (n // D), n // D)


def gather_blocks(t: torch.Tensor, mesh: DeviceMesh, axis: str | None,
                  dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` on the axis, concatenated along ``dim`` in axis
    order, on every rank (an all_gather, one rank's too): shard_map's out-spec."""
    if axis is None:
        return t
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)
