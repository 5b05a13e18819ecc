"""Extension fields F[x]/(x^D - non_residue) over the port's PrimeField.

Port of ``ExtField`` in ``tachyon_tpu/math/extfield.py``: degree D over a
``PrimeField`` or over another ``ExtField`` (a tower), so BN254's Fq2
(u^2 = -1) gives the coordinates of G2.  An element is a ``(D, W, *batch)``
int32 tensor, coefficient c_i at ``elt[i]`` (the JAX ``(D, L, *batch)`` with
its limbs repacked into 32-bit words; a tower nests: Fq6 is
``(3, 2, W, *batch)``).  Every op is vectorized over the batch axes.

Every base multiply goes through the base field's ``mul``, so on a
``PrimeField`` base each one is K1 on the card (``ops/cuda_mont.py``), as
the JAX ``ExtField.mul`` reaches Pallas K1 through ``mont.mul``.  Values are
canonical Montgomery residues, so any correct formula gives the JAX words;
the port therefore batches: the D coefficients of a linear op go through
one base op, and the D^2 products of ``mul`` through one base multiply over
a stacked batch (one K1 launch on the card), with the non-residue's
multiply in one more.

``HostExt`` is the exact host arithmetic on lists of D Python ints that the
STARK verifier and the challengers use for single values.
"""
from __future__ import annotations

import torch

from tachyon_tpu_torch.math.field import PrimeField, _shape


class ExtField:
    """Degree-D extension F[x]/(x^D - non_residue), non_residue in the base."""

    def __init__(self, base, degree: int, non_residue, name: str = ""):
        """``non_residue``: a base-field constant as ``base.encode`` takes it
        (an int over a PrimeField, a list of ints over an ExtField)."""
        self.base = base
        self.D = degree
        self.name = name or f"{getattr(base, 'name', base)}^ext{degree}"
        self._nr_host = non_residue
        self.non_residue = base.encode(non_residue)

    # --- shape helpers -----------------------------------------------------
    @property
    def coeff_ndim(self) -> int:
        """Leading structure axes of an element (coefficients and words)."""
        return 1 + self.base.coeff_ndim

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def p(self) -> int:
        return self.base.p

    @property
    def order(self) -> int:
        base_order = self.base.order if isinstance(self.base, ExtField) else self.base.p
        return base_order ** self.D

    def __repr__(self):
        return f"ExtField({self.name}, {self.device})"

    def _lin(self, op, *xs):
        """A base op over all D coefficients at once: the coefficient axis
        moves behind the base's structure axes, where it is a batch axis."""
        cn = self.base.coeff_ndim
        out = op(*(torch.movedim(x, 0, cn) for x in xs))
        return torch.movedim(out, cn, 0)

    def _stack(self, xs):
        """Base elements -> one base element with a new leading batch axis."""
        return torch.stack(xs, dim=self.base.coeff_ndim)

    def _unstack(self, x):
        return x.unbind(self.base.coeff_ndim)

    # --- construction -------------------------------------------------------
    def zeros(self, shape=()):
        return torch.stack([self.base.zeros(_shape(shape))] * self.D)

    def ones(self, shape=()):
        s = _shape(shape)
        return torch.stack([self.base.ones(s)] + [self.base.zeros(s)] * (self.D - 1))

    def encode(self, coeffs):
        """coeffs: D base-encodable values (ints or arrays of ints over a
        PrimeField) -> element (D, W, *shape)."""
        if len(coeffs) != self.D:
            raise ValueError(f"{self.name}: {len(coeffs)} coefficients, not {self.D}")
        return torch.stack([self.base.encode(c) for c in coeffs])

    def decode(self, a) -> list:
        """element -> D base decodes (numpy object arrays of ints)."""
        return [self.base.decode(a[i]) for i in range(self.D)]

    def full(self, shape, coeffs):
        """The constant with these D coefficients broadcast to a batch shape."""
        return torch.stack([self.base.full(shape, c) for c in coeffs])

    def embed(self, a):
        """base element -> extension element (c0 = a, the rest 0)."""
        return torch.stack([a] + [torch.zeros_like(a)] * (self.D - 1))

    # --- linear ops ---------------------------------------------------------
    def add(self, a, b):
        return self._lin(self.base.add, a, b)

    def sub(self, a, b):
        return self._lin(self.base.sub, a, b)

    def neg(self, a):
        return self._lin(self.base.neg, a)

    def double(self, a):
        return self._lin(self.base.double, a)

    def mul_small(self, a, k: int):
        return self._lin(lambda x: self.base.mul_small(x, k), a)

    def mul_base(self, a, s):
        """Multiply by a base-field element (broadcast over the coefficients)."""
        return self._lin(self.base.mul, a, s.unsqueeze(0))

    def _nr(self, like):
        """The non-residue shaped to broadcast against a base element."""
        nr = self.non_residue
        return nr.reshape(nr.shape + (1,) * (like.ndim - nr.ndim))

    def mul_by_nonresidue(self, x):
        """Base-field multiply by the tower's non-residue."""
        return self.base.mul(x, self._nr(x))

    # --- multiplication -----------------------------------------------------
    def mul(self, a, b):
        """Schoolbook with x^D = non_residue: out[k] = sum_{i+j=k} a_i b_j
        + nr sum_{i+j=k+D} a_i b_j.  One base multiply makes nr b_j for
        j >= 1, one more all D^2 products a_i (b_j or nr b_j), and D - 1
        base adds sum them for every k at once."""
        D = self.D
        a, b = torch.broadcast_tensors(a, b)
        av, bv = list(a.unbind(0)), list(b.unbind(0))
        bnr = self._unstack(self.mul_by_nonresidue(self._stack(bv[1:])))
        lhs = self._stack([av[i] for i in range(D) for _ in range(D)])
        rhs = self._stack([bv[j] if i + j < D else bnr[j - 1]
                           for i in range(D) for j in range(D)])
        prods = self._unstack(self.base.mul(lhs, rhs))  # (i, j) at i * D + j

        def by_k(i):  # the products a_i b_{(k - i) mod D} for k = 0 .. D - 1
            return self._stack([prods[i * D + (k - i) % D] for k in range(D)])

        acc = by_k(0)
        for i in range(1, D):
            acc = self.base.add(acc, by_k(i))
        return torch.movedim(acc, self.base.coeff_ndim, 0)

    def square(self, a):
        return self.mul(a, a)

    def sum(self, a, dim=-1):
        """The sum over a batch axis (each coefficient through the base's
        ``sum``)."""
        return self._lin(lambda x: self.base.sum(x, dim), a)

    # --- equality / select --------------------------------------------------
    def is_zero(self, a):
        return (a == 0).flatten(0, self.coeff_ndim - 1).all(dim=0)

    def eq(self, a, b):
        return (a == b).flatten(0, self.coeff_ndim - 1).all(dim=0)

    def select(self, mask, a, b):
        return torch.where(mask.reshape((1,) * self.coeff_ndim + mask.shape), a, b)

    # --- inversion ------------------------------------------------------------
    def inv(self, a):
        """Inverse (0 -> 0): the norm formula for D = 2, 3 and 4, Fermat over
        the extension otherwise (the JAX package takes Fermat for D = 4:
        the inverse is unique, so the words are the same)."""
        B = self.base
        if self.D == 4:
            return self._inv4(a)
        if self.D == 2:
            # (a0 - a1 x) / (a0^2 - nr a1^2)
            a0, a1 = a.unbind(0)
            sq = self._unstack(B.square(self._stack([a0, a1])))
            ninv = B.inv(B.sub(sq[0], self.mul_by_nonresidue(sq[1])))
            t = self._unstack(B.mul(self._stack([a0, a1]), self._stack([ninv, ninv])))
            return torch.stack([t[0], B.neg(t[1])])
        if self.D == 3:
            # the cubic-extension inverse of arkworks' Fp3
            a0, a1, a2 = a.unbind(0)
            n = self.mul_by_nonresidue
            t0, t1, t2, t3, t4, t5 = self._unstack(B.mul(
                self._stack([a0, a1, a2, a0, a0, a1]), self._stack([a0, a1, a2, a1, a2, a2])))
            c0 = B.sub(t0, n(t5))
            c1 = B.sub(n(t2), t3)
            c2 = B.sub(t1, t4)
            m0, m1, m2 = self._unstack(B.mul(self._stack([a0, a2, a1]),
                                             self._stack([c0, c1, c2])))
            ninv = B.inv(B.add(m0, n(B.add(m1, m2))))
            return torch.stack(self._unstack(B.mul(self._stack([c0, c1, c2]),
                                                   self._stack([ninv] * 3))))
        return self.pow_const(a, self.order - 2)

    def _inv4(self, a):
        """D = 4 through the quadratic subfield: with v = x^2 (v^2 = nr),
        a = A + x B for A = a0 + a2 v, B = a1 + a3 v, so a (A - x B) =
        A^2 - v B^2 = n0 + n1 v, whose inverse is (n0 - n1 v) / (n0^2 -
        nr n1^2); then a^-1 = (A - x B)(m0 + m1 v).  One base inverse, no
        exponent over the extension."""
        B, n = self.base, self.mul_by_nonresidue
        a0, a1, a2, a3 = a.unbind(0)
        s00, s22, s13, s02, s11, s33 = self._unstack(B.mul(
            self._stack([a0, a2, a1, a0, a1, a3]), self._stack([a0, a2, a3, a2, a1, a3])))
        n0 = B.sub(B.add(s00, n(s22)), B.double(n(s13)))  # a0^2 + nr a2^2 - 2 nr a1 a3
        n1 = B.sub(B.double(s02), B.add(s11, n(s33)))     # 2 a0 a2 - a1^2 - nr a3^2
        q0, q1 = self._unstack(B.square(self._stack([n0, n1])))
        dinv = B.inv(B.sub(q0, n(q1)))
        m0, m1 = self._unstack(B.mul(self._stack([n0, B.neg(n1)]), self._stack([dinv, dinv])))
        t = self._unstack(B.mul(self._stack([a0, a2, a0, a2, a1, a3, a1, a3]),
                                self._stack([m0, m1, m1, m0, m0, m1, m1, m0])))
        return torch.stack([B.add(t[0], n(t[1])),            # a0 m0 + nr a2 m1
                            B.neg(B.add(t[4], n(t[5]))),     # -(a1 m0 + nr a3 m1)
                            B.add(t[2], t[3]),               # a0 m1 + a2 m0
                            B.neg(B.add(t[6], t[7]))])       # -(a1 m1 + a3 m0)

    def pow_const(self, a, e: int):
        """a ** e for a host exponent, MSB-first square-and-multiply (a zero
        bit skips its multiply: the JAX scan computes it and selects it
        away, the values are the same)."""
        if e == 0:
            return self.ones(a.shape[self.coeff_ndim:])
        acc = a
        for i in range(e.bit_length() - 2, -1, -1):
            acc = self.square(acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def batch_inverse(self, a, axis=-1):
        """Montgomery-trick batch inverse along a batch axis (zeros -> zeros):
        exclusive prefix products, one inverse, a suffix pass."""
        cn = self.coeff_ndim
        if axis < 0:
            axis = a.ndim + axis
        if axis < cn:
            raise ValueError(f"axis {axis} is a structure axis (the first {cn} are)")
        xs_all = torch.movedim(a, axis, cn)
        n = xs_all.shape[cn]
        zero = self.is_zero(xs_all)  # (n, ...)
        one = self.ones(xs_all.shape[cn + 1:])
        xs = [self.select(zero[i], one, xs_all.select(cn, i)) for i in range(n)]
        prefix, carry = [], one
        for x in xs:
            prefix.append(carry)
            carry = self.mul(carry, x)
        carry = self.inv(carry)
        out = [None] * n
        for i in range(n - 1, -1, -1):
            out[i] = self.mul(carry, prefix[i])
            if i:
                carry = self.mul(carry, xs[i])
        res = torch.stack(out, dim=cn)
        res = self.select(zero, torch.zeros_like(res), res)
        return torch.movedim(res, cn, axis)


class HostExt:
    """Exact host arithmetic in F_p[x]/(x^D - nr) (port of ``HostExt`` in
    ``tachyon_tpu/math/extfield.py``).

    Elements are lists of D Python ints, coefficient-major as
    ``ExtField.decode`` gives them.  The verifier's constraint fold at an
    extension point and the challengers' bookkeeping use it, where a device
    round trip per scalar op would dominate.  Prime base fields only."""

    def __init__(self, ext: ExtField):
        if not isinstance(ext.base, PrimeField):
            raise TypeError("HostExt: prime base fields only")
        self.D = ext.D
        self.p = ext.p
        self.nr = int(ext._nr_host)

    def e(self, x) -> list:
        """An int embedded, or a sequence coerced to D canonical ints."""
        if isinstance(x, int):
            return [x % self.p] + [0] * (self.D - 1)
        out = [int(c) % self.p for c in x]
        if len(out) != self.D:
            raise ValueError(f"{len(out)} coefficients, not {self.D}")
        return out

    def add(self, a, b):
        return [(x + y) % self.p for x, y in zip(self.e(a), self.e(b))]

    def sub(self, a, b):
        return [(x - y) % self.p for x, y in zip(self.e(a), self.e(b))]

    def neg(self, a):
        return [(-x) % self.p for x in self.e(a)]

    def mul(self, a, b):
        a, b = self.e(a), self.e(b)
        D, p, nr = self.D, self.p, self.nr
        out = [0] * D
        for i in range(D):
            if a[i] == 0:
                continue
            for j in range(D):
                t = a[i] * b[j]
                if i + j >= D:
                    out[i + j - D] = (out[i + j - D] + t * nr) % p
                else:
                    out[i + j] = (out[i + j] + t) % p
        return out

    def pow(self, a, e: int):
        r, a = self.e(1), self.e(a)
        while e:
            if e & 1:
                r = self.mul(r, a)
            a = self.mul(a, a)
            e >>= 1
        return r

    def inv(self, a):
        return self.pow(a, self.p ** self.D - 2)
