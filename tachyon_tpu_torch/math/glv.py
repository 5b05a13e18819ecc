"""GLV endomorphism-based scalar decomposition.

Port of ``tachyon_tpu/math/glv.py`` (the reference's
tachyon/math/elliptic_curves/msm/glv.h).  On a j = 0 curve (y^2 = x^3 + b)
over a field with a cube root of unity beta, phi(x, y) = (beta x, y) acts
as multiplication by a cube root of unity lambda mod r, so
k P = k1 P + k2 phi(P) with |k1|, |k2| ~ sqrt(r): the Pippenger MSM runs
twice the points at half the scalar width (130 bits for secp256k1's 256,
129 for BN254's 254).

The constants are derived as the JAX package derives them: the cube roots
from the fields' generators, the (beta, lambda) pair that agrees on the
curve's generator (exact host ints), the short lattice basis by the
extended Euclidean algorithm cut at sqrt(r).  The decomposition is exact
Python-int arithmetic; ``decompose_all`` runs it over numpy object arrays
(the same ints as ``decompose`` one at a time, in a C loop), and the words
of |k1| and |k2| are packed from their bytes (``limbs.from_ints``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ, SWCurve
from tachyon_tpu_torch.math.msm import msm


def _cube_roots_of_unity(p: int, generator: int) -> list[int]:
    if (p - 1) % 3:
        raise ValueError("the field has no cube root of unity")
    w = pow(generator, (p - 1) // 3, p)
    return [w, pow(w, 2, p)]


def _short_basis(r: int, lam: int):
    """Two short vectors (a, b) with a + b lam = 0 mod r: the extended
    Euclidean algorithm cut at sqrt(r), then one more step, v2 the shorter
    of (r_{l-1}, -t_{l-1}) and (r_{l+1}, -t_{l+1}) (the GLV recipe, as in
    the JAX package)."""
    s = math.isqrt(r)
    rs, ts = [r, lam], [0, 1]
    while rs[-1] >= s:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    l = len(rs) - 1
    v1 = (rs[l], -ts[l])
    q = rs[l - 1] // rs[l]
    rs.append(rs[l - 1] - q * rs[l])
    ts.append(ts[l - 1] - q * ts[l])
    cands = [(rs[l - 1], -ts[l - 1]), (rs[l + 1], -ts[l + 1])]
    v2 = min(cands, key=lambda v: v[0] * v[0] + v[1] * v[1])
    return v1, v2


class GLV:
    """beta, lambda, the short basis v1, v2 and the decomposition of one
    j = 0 prime-field curve (the port's curves are all a = 0)."""

    def __init__(self, curve: SWCurve):
        if not curve._kernel_ok or int(curve.b_int) == 0:
            raise ValueError(f"{curve.name}: GLV needs a j = 0 curve over a prime field")
        self.curve = curve
        p, r = curve.F.p, curve.SF.p
        g = (int(curve.gen_x), int(curve.gen_y))
        found = None
        for beta in _cube_roots_of_unity(p, curve.F.spec.generator):
            phi_g = (g[0] * beta % p, g[1])
            for lam in _cube_roots_of_unity(r, curve.SF.spec.generator):
                if host_ec.scalar_mul(g, lam, 0, p) == phi_g:
                    found = (beta, lam)
                    break
            if found:
                break
        if not found:
            raise ValueError(f"{curve.name}: no consistent (beta, lambda) pair")
        self.beta, self.lam = found
        self.v1, self.v2 = _short_basis(r, self.lam)
        self.r = r

    def _split(self, k):
        """k1, k2 with k = k1 + k2 lam (mod r), for an int or an object
        array of ints in [0, r): Babai's rounding against the basis,
        sign-safe (the reduced basis may give det < 0)."""
        (a1, b1), (a2, b2) = self.v1, self.v2
        det = a1 * b2 - a2 * b1
        sgn = -1 if det < 0 else 1

        def rnd(x):  # round(x / det) to nearest
            return (2 * sgn * x + sgn * det) // (2 * sgn * det)

        c1 = rnd(b2 * k)
        c2 = rnd(-b1 * k)
        return k - c1 * a1 - c2 * a2, -c1 * b1 - c2 * b2

    def decompose(self, k: int) -> tuple[int, int]:
        """k = k1 + k2 lam (mod r) with small |k1|, |k2| (signed)."""
        k1, k2 = self._split(int(k) % self.r)
        assert (k1 + k2 * self.lam - k) % self.r == 0
        return k1, k2

    def decompose_all(self, scalar_ints) -> tuple[np.ndarray, np.ndarray]:
        """``decompose`` over a sequence of ints, as two object arrays of
        signed ints (the same ints, each checked)."""
        k = np.asarray([int(s) for s in scalar_ints], dtype=object) % self.r
        k1, k2 = self._split(k)
        if ((k1 + k2 * self.lam - k) % self.r != 0).any():
            raise AssertionError("GLV decomposition is not k1 + k2 lambda")
        return k1, k2

    def endo(self, points: AffinePoint) -> AffinePoint:
        """phi(P) = (beta x, y), one field multiply over the batch."""
        F = self.curve.F
        return AffinePoint(F.mul(points.x, F.full((1,), self.beta)), points.y, points.inf)


def glv_inputs(curve: SWCurve, points: AffinePoint, scalar_ints):
    """The GLV MSM's inputs: the 2n points [P_i or -P_i, phi(P_i) or
    -phi(P_i)] (each negated where its half scalar is negative), the
    (Ws, 2n) words of |k1| then |k2| and their bit width, half_bits =
    ceil(bits / 2) + 2.  The decomposition runs on the host; the points'
    endomorphism and negations on the points' device."""
    glv = GLV(curve)
    F = curve.F
    half_bits = (curve.SF.spec.bits + 1) // 2 + 2
    k1, k2 = glv.decompose_all(scalar_ints)
    signs = [torch.from_numpy(np.asarray(k < 0, dtype=bool)).to(F.device) for k in (k1, k2)]
    mag = np.concatenate([np.abs(k1), np.abs(k2)])
    if mag.size and mag.max() >> half_bits:
        raise AssertionError(f"a GLV half scalar exceeds {half_bits} bits")
    scalars = limbs.from_ints(mag, -(-half_bits // limbs.WORD_BITS), F.device)
    phi = glv.endo(points)
    halves = [AffinePoint(p.x, F.select(s, F.neg(p.y), p.y), p.inf)
              for p, s in zip((points, phi), signs)]
    allp = AffinePoint(*(torch.cat(ts, dim=-1) for ts in zip(*halves)))
    return allp, scalars, half_bits


def msm_glv(curve: SWCurve, points: AffinePoint, scalar_ints, c: int | None = None) -> PointXYZZ:
    """GLV-decomposed Pippenger MSM: half-width scalars over the doubled
    point set (reference: glv.h + the Pippenger pipeline), through the
    port's ``msm(..., total_bits=half_bits)``.

    scalar_ints: host ints (the decomposition is host-exact); points: an
    AffinePoint with (W, n) coords on the curve's device.
    """
    allp, scalars, half_bits = glv_inputs(curve, points, scalar_ints)
    return msm(curve, allp, scalars, c=c, total_bits=half_bits)
