"""Short-Weierstrass point ops (a = 0), vectorized and select-complete.

Port of ``tachyon_tpu/math/ec.py`` for prime-field curves with a = 0
(BN254 G1).  Every op acts on a vector of points: coordinates are
``(W, *batch)`` int32 word tensors.  XYZZ is the accumulation form:
x = X/ZZ, y = Y/ZZZ; infinity is ZZ == 0 (all-zero coordinates).

``add_xyzz`` / ``dbl_xyzz`` / ``madd_xyzz`` / ``scalar_mul`` launch the
CUDA kernels K2 / K3 / K4 / the fused ladder on CUDA tensors and their
plain twins on CPU tensors (``ops/cuda_ec.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math.field import _shape
from tachyon_tpu_torch.ops import cuda_ec


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool, batch-shaped


class PointXYZZ(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    zz: torch.Tensor
    zzz: torch.Tensor


class SWCurve:
    """y^2 = x^3 + b over a PrimeField F (a = 0 only, for now)."""

    def __init__(self, name, field, a, b, gen_x, gen_y, scalar_field):
        if int(a) != 0:
            raise NotImplementedError("the port supports a = 0 curves only")
        self.name = name
        self.F = field
        self.a_int = 0
        self.b_int = b
        self.b = field.encode(b)
        self.gen_x = gen_x
        self.gen_y = gen_y
        self.SF = scalar_field  # PrimeField of the scalar group order

    @property
    def device(self) -> torch.device:
        return self.F.device

    # --- constructors -------------------------------------------------------
    def generator(self, shape=()) -> AffinePoint:
        s = _shape(shape)
        return AffinePoint(self.F.full(s, self.gen_x), self.F.full(s, self.gen_y),
                           torch.zeros(s, dtype=torch.bool, device=self.device))

    def infinity_xyzz(self, shape=()) -> PointXYZZ:
        z = self.F.zeros(_shape(shape))
        return PointXYZZ(z, z.clone(), z.clone(), z.clone())

    def infinity_affine(self, shape=()) -> AffinePoint:
        s = _shape(shape)
        z = self.F.zeros(s)
        return AffinePoint(z, z.clone(), torch.ones(s, dtype=torch.bool, device=self.device))

    def to_xyzz(self, p: AffinePoint) -> PointXYZZ:
        F = self.F
        one = F.ones(p.inf.shape)
        zero = F.zeros(p.inf.shape)
        ninf = ~p.inf
        return PointXYZZ(F.select(ninf, p.x, zero), F.select(ninf, p.y, zero),
                         F.select(ninf, one, zero), F.select(ninf, one, zero))

    def to_affine(self, p: PointXYZZ) -> AffinePoint:
        """Normalize via one batch inverse of zz and zzz (inf where zz == 0)."""
        F = self.F
        inf = F.is_zero(p.zz)
        invs = F.batch_inverse(torch.stack([p.zz, p.zzz], dim=1), axis=1)
        x = F.mul(p.x, invs[:, 0])
        y = F.mul(p.y, invs[:, 1])
        zero = torch.zeros_like(x)
        return AffinePoint(F.select(~inf, x, zero), F.select(~inf, y, zero), inf)

    def neg_affine(self, p: AffinePoint) -> AffinePoint:
        return AffinePoint(p.x, self.F.neg(p.y), p.inf)

    def neg_xyzz(self, p: PointXYZZ) -> PointXYZZ:
        return PointXYZZ(p.x, self.F.neg(p.y), p.zz, p.zzz)

    def is_on_curve(self, p: AffinePoint) -> torch.Tensor:
        F = self.F
        b = self.b.reshape((F.W,) + (1,) * (p.x.ndim - 1))
        rhs = F.add(F.mul(F.square(p.x), p.x), b)
        return F.eq(F.square(p.y), rhs) | p.inf

    def eq_affine(self, p: AffinePoint, q: AffinePoint) -> torch.Tensor:
        F = self.F
        both = F.eq(p.x, q.x) & F.eq(p.y, q.y) & ~p.inf & ~q.inf
        return both | (p.inf & q.inf)

    # --- xyzz group law -------------------------------------------------------
    def dbl_xyzz(self, p: PointXYZZ) -> PointXYZZ:
        return PointXYZZ(*cuda_ec.dbl_xyzz(self.F.spec, tuple(p)))

    def add_xyzz(self, p: PointXYZZ, q: PointXYZZ) -> PointXYZZ:
        return PointXYZZ(*cuda_ec.add_xyzz(self.F.spec, tuple(p), tuple(q)))

    def madd_xyzz(self, p: PointXYZZ, q: AffinePoint) -> PointXYZZ:
        return PointXYZZ(*cuda_ec.madd_xyzz(self.F.spec, tuple(p), q.x, q.y, q.inf))

    def _dbl_xyzz_plain(self, p: PointXYZZ) -> PointXYZZ:
        """dbl-2008-s-1 in plain tensor ops; infinity propagates (zz = 0)."""
        return PointXYZZ(*cuda_ec.dbl_xyzz_plain(self.F.spec, tuple(p)))

    def _add_xyzz_plain(self, p: PointXYZZ, q: PointXYZZ) -> PointXYZZ:
        """add-2008-s in plain tensor ops with complete case handling."""
        return PointXYZZ(*cuda_ec.add_xyzz_plain(self.F.spec, tuple(p), tuple(q)))

    # --- scalar multiplication (the MSM is in msm.py) -------------------------
    def scalar_mul(self, p: AffinePoint, scalars: torch.Tensor) -> PointXYZZ:
        """[s]P lane by lane: an MSB-first double-and-add over all Ws * 32
        bits of the scalar words, from infinity, with no bit skipped, so
        the XYZZ words equal the JAX package's ``lax.scan``.  On the card
        it is one launch of the fused ladder (``cuda_ec.scalar_mul``: every
        step's dbl and mixed add in registers); on the CPU its plain twin
        runs a dbl, a mixed add and a select on the bit per step.

        scalars: (Ws, *batch) plain (non-Montgomery) int32 scalar words."""
        return PointXYZZ(*cuda_ec.scalar_mul(self.F.spec, p.x.contiguous(), p.y.contiguous(),
                                             p.inf.contiguous(), scalars.contiguous()))

    def random_affine(self, n: int, rng=None):
        """n pseudo-random curve points [s_i]G, with the s_i drawn as the JAX
        package draws them (``rng.bytes(40)`` each, mod the group order)."""
        rng = rng or np.random.default_rng()
        SF = self.SF
        scalars = np.empty((n,), dtype=object)
        for i in range(n):
            scalars[i] = int.from_bytes(rng.bytes(40), "little") % SF.p
        pts = self.scalar_mul(self.generator((n,)), limbs.from_ints(scalars, SF.W, self.device))
        return self.to_affine(pts), scalars
