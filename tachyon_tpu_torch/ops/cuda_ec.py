"""K2 and K3: whole XYZZ point add and double as hand-written CUDA kernels.

Replace the Pallas kernels of ``tachyon_tpu/ops/pallas_ec.py``:

* K2 ``_add_call`` (``pl.pallas_call`` at line 209, body ``_add_body``):
  complete add-2008-s, a = 0.  P = Q doubles, P = -Q gives infinity,
  infinity inputs pass through.
* K3 ``_dbl_call`` (``pl.pallas_call`` at line 232, body ``_dbl_body``):
  dbl-2008-s-1, a = 0; infinity (zz = 0) propagates.

Kernels (``csrc/ec.cu``, ``csrc/xyzz.cuh``): one thread per point; each
coordinate is a word-major ``(W, n)`` array so the loads of a warp coalesce.
Bound on the card: an add is ~20 field multiplies (~3k integer multiply-adds)
against 384 bytes moved, so it is compute-bound once there are enough points
to fill 132 SMs; the MSM path calls it on 1 to 131k points, and below ~100k
points it is bound by occupancy and launch latency.  The design keeps a
whole point in registers (no shared memory) and evaluates the same formulas
and case order as the TPU kernel, so results are bit-identical.

``add_xyzz_plain`` / ``dbl_xyzz_plain`` are the plain PyTorch twins (the CPU
path, and the reference the kernels are held against on the card); they
mirror ``SWCurve._add_xyzz_jnp`` / ``_dbl_xyzz_jnp``.
"""
from __future__ import annotations

import torch

from tachyon_tpu.fields.spec import FieldSpec
from tachyon_tpu_torch.ops import _build, mont
from tachyon_tpu_torch.ops.cuda_mont import check_cuda, consts_ptr


def dbl_xyzz_plain(f: FieldSpec, p):
    px, py, pzz, pzzz = p
    u = mont.double(f, py)
    v = mont.square(f, u)
    w = mont.mul(f, u, v)
    s = mont.mul(f, px, v)
    m = mont.mul_small(f, mont.square(f, px), 3)
    x3 = mont.sub(f, mont.square(f, m), mont.double(f, s))
    y3 = mont.sub(f, mont.mul(f, m, mont.sub(f, s, x3)), mont.mul(f, w, py))
    zz3 = mont.mul(f, v, pzz)
    zzz3 = mont.mul(f, w, pzzz)
    return x3, y3, zz3, zzz3


def _pick(mask, a, b):
    return tuple(mont.select(mask, x, y) for x, y in zip(a, b))


def add_xyzz_plain(f: FieldSpec, p, q):
    """add-2008-s with complete select-based case handling."""
    px, py, pzz, pzzz = p
    qx, qy, qzz, qzzz = q
    u1 = mont.mul(f, px, qzz)
    u2 = mont.mul(f, qx, pzz)
    s1 = mont.mul(f, py, qzzz)
    s2 = mont.mul(f, qy, pzzz)
    pp = mont.sub(f, u2, u1)
    r = mont.sub(f, s2, s1)
    same_x = mont.is_zero(f, pp)
    same_y = mont.is_zero(f, r)
    pp2 = mont.square(f, pp)
    ppp = mont.mul(f, pp, pp2)
    qq = mont.mul(f, u1, pp2)
    x3 = mont.sub(f, mont.sub(f, mont.square(f, r), ppp), mont.double(f, qq))
    y3 = mont.sub(f, mont.mul(f, r, mont.sub(f, qq, x3)), mont.mul(f, s1, ppp))
    zz3 = mont.mul(f, mont.mul(f, pzz, qzz), pp2)
    zzz3 = mont.mul(f, mont.mul(f, pzzz, qzzz), ppp)
    out = (x3, y3, zz3, zzz3)

    dbl = dbl_xyzz_plain(f, p)
    p_inf = mont.is_zero(f, pzz)
    q_inf = mont.is_zero(f, qzz)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf
    is_inf = same_x & ~same_y & ~p_inf & ~q_inf
    zero = torch.zeros_like(x3)
    out = _pick(is_inf, (zero,) * 4, out)
    out = _pick(is_dbl, dbl, out)
    out = _pick(q_inf, p, out)
    out = _pick(p_inf, q, out)
    return out


def _flat(f: FieldSpec, coords):
    """(W, *batch) coords -> contiguous (W, n) views, batch shape, n."""
    batch = coords[0].shape[1:]
    for t in coords:
        if t.shape != coords[0].shape:
            raise ValueError(f"coordinate shapes differ: {t.shape} vs {coords[0].shape}")
    W = check_cuda(f, *coords)
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
        add_xyzz.launches += 1
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
        dbl_xyzz.launches += 1
    return tuple(o.view(-1, *batch) for o in outs)


add_xyzz.launches = 0
dbl_xyzz.launches = 0
