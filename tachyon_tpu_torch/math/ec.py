"""Short-Weierstrass point ops (a = 0), vectorized and select-complete.

Port of ``tachyon_tpu/math/ec.py``.  Every op acts on a vector of points:
coordinates are ``(W, *batch)`` int32 word tensors over a PrimeField, and
``(D, W, *batch)`` over an ExtField (G2 over Fq2).  XYZZ is the
accumulation form: x = X/ZZ, y = Y/ZZZ; infinity is ZZ == 0 (all-zero
coordinates).

Where the JAX package gates its Pallas point kernels on (``_pallas_ok``:
a = 0 over a prime field with a ``spec``), the port's ``_kernel_ok`` routes
``add_xyzz`` / ``dbl_xyzz`` / ``madd_xyzz`` / ``scalar_mul`` to the CUDA
kernels K2 / K3 / K4 / the fused ladder on CUDA tensors and to their plain
twins on CPU tensors (``ops/cuda_ec.py``).  Other curves (G2) take the
generic methods, written with the field object's ops as the JAX
``_dbl/_add/_madd_xyzz_jnp`` are, in the same order of case selects: no
point kernel, every base multiply K1 on the card.  The generic methods
batch independent multiplies (and subtractions) into one field op over a
stacked batch axis; values are canonical, so the words are the JAX ones.
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


def _is_zero_const(v) -> bool:
    """A host constant (an int, or a list of coefficients) is zero."""
    if isinstance(v, (list, tuple)):
        return all(_is_zero_const(x) for x in v)
    return int(v) == 0


def _batched(F, op, *pairs):
    """Independent binary field ops as one op over a new batch axis (one K1
    launch for multiplies on the card); the same values as one at a time."""
    cn = F.coeff_ndim
    return op(torch.stack([x for x, _ in pairs], dim=cn),
              torch.stack([y for _, y in pairs], dim=cn)).unbind(cn)


def _pick(F, mask, a, b) -> PointXYZZ:
    return PointXYZZ(*(F.select(mask, x, y) for x, y in zip(a, b)))


class SWCurve:
    """y^2 = x^3 + b over a field object F (a PrimeField or an ExtField;
    a = 0 only, as every curve of the port)."""

    def __init__(self, name, field, a, b, gen_x, gen_y, scalar_field):
        if not _is_zero_const(a):
            raise NotImplementedError("the port supports a = 0 curves only")
        self.name = name
        self.F = field
        self.a_int = a
        self.b_int = b
        self.b = field.encode(b)
        self.gen_x = gen_x
        self.gen_y = gen_y
        self.SF = scalar_field  # PrimeField of the scalar group order
        # the point kernels take a = 0 prime-field curves (the JAX _pallas_ok)
        self._kernel_ok = hasattr(field, "spec")

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
        """Normalize via one batch inverse of zz and zzz, stacked on a new
        batch axis behind the structure axes (inf where zz == 0)."""
        F = self.F
        cn = F.coeff_ndim
        inf = F.is_zero(p.zz)
        invs = F.batch_inverse(torch.stack([p.zz, p.zzz], dim=cn), axis=cn)
        x = F.mul(p.x, invs.select(cn, 0))
        y = F.mul(p.y, invs.select(cn, 1))
        zero = torch.zeros_like(x)
        return AffinePoint(F.select(~inf, x, zero), F.select(~inf, y, zero), inf)

    def neg_affine(self, p: AffinePoint) -> AffinePoint:
        return AffinePoint(p.x, self.F.neg(p.y), p.inf)

    def neg_xyzz(self, p: PointXYZZ) -> PointXYZZ:
        return PointXYZZ(p.x, self.F.neg(p.y), p.zz, p.zzz)

    def is_on_curve(self, p: AffinePoint) -> torch.Tensor:
        F = self.F
        b = self.b.reshape(self.b.shape + (1,) * (p.x.ndim - self.b.ndim))
        rhs = F.add(F.mul(F.square(p.x), p.x), b)
        return F.eq(F.square(p.y), rhs) | p.inf

    def eq_affine(self, p: AffinePoint, q: AffinePoint) -> torch.Tensor:
        F = self.F
        both = F.eq(p.x, q.x) & F.eq(p.y, q.y) & ~p.inf & ~q.inf
        return both | (p.inf & q.inf)

    # --- xyzz group law -------------------------------------------------------
    def dbl_xyzz(self, p: PointXYZZ) -> PointXYZZ:
        if not self._kernel_ok:
            return self._dbl_xyzz_generic(p)
        return PointXYZZ(*cuda_ec.dbl_xyzz(self.F.spec, tuple(p)))

    def add_xyzz(self, p: PointXYZZ, q: PointXYZZ) -> PointXYZZ:
        if not self._kernel_ok:
            return self._add_xyzz_generic(p, q)
        return PointXYZZ(*cuda_ec.add_xyzz(self.F.spec, tuple(p), tuple(q)))

    def madd_xyzz(self, p: PointXYZZ, q: AffinePoint) -> PointXYZZ:
        if not self._kernel_ok:
            return self._madd_xyzz_generic(p, q)
        return PointXYZZ(*cuda_ec.madd_xyzz(self.F.spec, tuple(p), q.x, q.y, q.inf))

    # --- the generic group law (ExtField coordinates) -------------------------
    def _dbl_xyzz_generic(self, p: PointXYZZ) -> PointXYZZ:
        """dbl-2008-s-1 (a = 0) in field ops, as ``_dbl_xyzz_jnp``;
        infinity propagates (zz = 0)."""
        F = self.F
        u = F.double(p.y)
        v, x2 = _batched(F, F.mul, (u, u), (p.x, p.x))
        w, s, zz3 = _batched(F, F.mul, (u, v), (p.x, v), (v, p.zz))
        m = F.mul_small(x2, 3)
        m2, wy, zzz3 = _batched(F, F.mul, (m, m), (w, p.y), (w, p.zzz))
        x3 = F.sub(m2, F.double(s))
        y3 = F.sub(F.mul(m, F.sub(s, x3)), wy)
        return PointXYZZ(x3, y3, zz3, zzz3)

    def _add_tail_generic(self, u1, s1, pp, r, zz, zzz) -> PointXYZZ:
        """The shared tail of add-2008-s and madd-2008-s: x3 = r^2 - ppp -
        2 qq, y3 = r (qq - x3) - s1 ppp, zz3 = zz pp^2, zzz3 = zzz ppp."""
        F = self.F
        pp2, r2 = _batched(F, F.mul, (pp, pp), (r, r))
        ppp, qq, zz3 = _batched(F, F.mul, (pp, pp2), (u1, pp2), (zz, pp2))
        x3 = F.sub(F.sub(r2, ppp), F.double(qq))
        t, s1ppp, zzz3 = _batched(F, F.mul, (r, F.sub(qq, x3)), (s1, ppp), (zzz, ppp))
        return PointXYZZ(x3, F.sub(t, s1ppp), zz3, zzz3)

    def _cases_generic(self, out, p, q, pp, r, p_inf, q_inf) -> PointXYZZ:
        """The JAX order of case selects: P = -Q gives infinity, P = Q the
        double (computed only when some lane takes it: the same words),
        q = inf gives p, p = inf gives q."""
        F = self.F
        same_x, same_y = F.is_zero(pp), F.is_zero(r)
        is_dbl = same_x & same_y & ~p_inf & ~q_inf
        is_inf = same_x & ~same_y & ~p_inf & ~q_inf
        zero = torch.zeros_like(out.x)
        out = _pick(F, is_inf, (zero,) * 4, out)
        if bool(is_dbl.any()):
            out = _pick(F, is_dbl, self._dbl_xyzz_generic(p), out)
        out = _pick(F, q_inf, p, out)
        return _pick(F, p_inf, q, out)

    def _add_xyzz_generic(self, p: PointXYZZ, q: PointXYZZ) -> PointXYZZ:
        """add-2008-s with complete case handling, as ``_add_xyzz_jnp``."""
        F = self.F
        u1, u2, s1, s2, zz, zzz = _batched(F, F.mul, (p.x, q.zz), (q.x, p.zz), (p.y, q.zzz),
                                           (q.y, p.zzz), (p.zz, q.zz), (p.zzz, q.zzz))
        pp, r = _batched(F, F.sub, (u2, u1), (s2, s1))
        out = self._add_tail_generic(u1, s1, pp, r, zz, zzz)
        return self._cases_generic(out, p, q, pp, r, F.is_zero(p.zz), F.is_zero(q.zz))

    def _madd_xyzz_generic(self, p: PointXYZZ, q: AffinePoint) -> PointXYZZ:
        """madd-2008-s (q affine) with complete case handling, as
        ``_madd_xyzz_jnp``: p = inf gives q lifted (zz = zzz = 1)."""
        F = self.F
        u2, s2 = _batched(F, F.mul, (q.x, p.zz), (q.y, p.zzz))
        pp, r = _batched(F, F.sub, (u2, p.x), (s2, p.y))
        out = self._add_tail_generic(p.x, p.y, pp, r, p.zz, p.zzz)
        return self._cases_generic(out, p, self.to_xyzz(q), pp, r, F.is_zero(p.zz), q.inf)

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

        scalars: (Ws, *batch) plain (non-Montgomery) int32 scalar words.

        Other curves (G2) run the JAX scan's steps in field ops: a double, a
        mixed add and a select on the bit.  Steps above the highest bit set
        in any lane leave every accumulator at infinity (all-zero words,
        which the double keeps), so they are skipped: the same words."""
        if not self._kernel_ok:
            return self._scalar_mul_generic(p, scalars)
        return PointXYZZ(*cuda_ec.scalar_mul(self.F.spec, p.x.contiguous(), p.y.contiguous(),
                                             p.inf.contiguous(), scalars.contiguous()))

    def _scalar_mul_generic(self, p: AffinePoint, scalars: torch.Tensor) -> PointXYZZ:
        acc = self.infinity_xyzz(p.inf.shape)
        for b in range(cuda_ec.top_bit(scalars) - 1, -1, -1):
            bit = ((scalars[b // 32] >> (b % 32)) & 1) != 0
            acc = self._dbl_xyzz_generic(acc)
            acc = _pick(self.F, bit, self._madd_xyzz_generic(acc, p), acc)
        return acc

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
