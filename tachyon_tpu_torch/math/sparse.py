"""Sparse polynomial forms.

Port of ``tachyon_tpu/math/sparse.py`` (reference: tachyon/math/polynomials/
univariate/univariate_sparse_coefficients.h, multivariate/
multivariate_sparse_coefficients.h, multivariate/linear_combination.h).

Term structure (degrees, exponent matrices) is static host metadata;
coefficients are (W, k) Montgomery columns.  Every evaluation runs over
the k terms at once: exponentiation is one square-and-multiply ladder
driven by the host-known degree bits, so the device work is a fixed chain
of lane-parallel multiplies (K1 on the card) with no data-dependent
control flow.  ``SparseUnivariate.evaluate`` also takes a batch of points,
(W, *batch), where the JAX method takes one.
"""
from __future__ import annotations

import numpy as np
import torch

from tachyon_tpu_torch.math import mle
from tachyon_tpu_torch.math.field import PrimeField


def _pow_static(F: PrimeField, base: torch.Tensor, exps) -> torch.Tensor:
    """base: (W, k, *batch) columns; exps: k host ints -> base**exps.  One
    ladder for all terms: at bit b, the terms whose exponent has bit b
    multiply the running square in (a static lane mask)."""
    exps = [int(e) for e in exps]
    maxbits = max((e.bit_length() for e in exps), default=0)
    acc = F.ones(base.shape[1:])
    cur = base
    lanes = (len(exps),) + (1,) * (base.ndim - 2)
    for b in range(maxbits):
        mask = torch.tensor([(e >> b) & 1 for e in exps], dtype=torch.bool, device=base.device)
        acc = F.select(mask.reshape(lanes).expand(base.shape[1:]), F.mul(acc, cur), acc)
        if b != maxbits - 1:
            cur = F.square(cur)
    return acc


class SparseUnivariate:
    """sum_j c_j X^{d_j} with strictly increasing host-int degrees
    (reference: univariate_sparse_coefficients.h:95)."""

    def __init__(self, F: PrimeField, degrees, coeffs: torch.Tensor):
        self.F = F
        self.degrees = [int(d) for d in degrees]
        if any(a >= b for a, b in zip(self.degrees, self.degrees[1:])):
            raise ValueError("degrees must increase strictly")
        if coeffs.shape[1] != len(self.degrees):
            raise ValueError(f"{coeffs.shape[1]} coefficients for {len(self.degrees)} degrees")
        self.coeffs = coeffs  # (W, k) Montgomery

    @classmethod
    def from_dict(cls, F: PrimeField, terms: dict):
        degs = sorted(int(d) for d in terms)
        cf = F.encode(np.array([terms[d] % F.p for d in degs], dtype=object))
        return cls(F, degs, cf)

    def to_dict(self) -> dict:
        vals = self.F.decode(self.coeffs)
        return {d: int(v) for d, v in zip(self.degrees, vals) if int(v)}

    @property
    def degree(self) -> int:
        return self.degrees[-1] if self.degrees else 0

    def evaluate(self, z: torch.Tensor) -> torch.Tensor:
        """z: (W, *batch) encoded points -> (W, *batch) values; all terms in
        one ladder, then the field sum over the terms."""
        F = self.F
        batch = tuple(z.shape[1:])
        if not self.degrees:
            return F.zeros(batch)
        k = len(self.degrees)
        zs = z[:, None].expand(F.W, k, *batch)
        powers = _pow_static(F, zs, self.degrees)
        cf = self.coeffs.reshape(F.W, k, *(1,) * len(batch))
        return F.sum(F.mul(cf, powers), dim=1)

    def to_dense(self, n: int | None = None) -> torch.Tensor:
        n = n if n is not None else self.degree + 1
        if n <= self.degree:
            raise ValueError(f"{n} coefficients cannot hold degree {self.degree}")
        out = self.F.zeros((n,))
        out[:, torch.tensor(self.degrees, dtype=torch.long, device=out.device)] = self.coeffs
        return out

    def _merge(self, other: "SparseUnivariate", negate_other: bool):
        F = self.F
        degs = sorted(set(self.degrees) | set(other.degrees))
        pos = {d: i for i, d in enumerate(degs)}
        out = F.zeros((len(degs),))
        out[:, torch.tensor([pos[d] for d in self.degrees], dtype=torch.long,
                            device=out.device)] = self.coeffs
        ib = torch.tensor([pos[d] for d in other.degrees], dtype=torch.long, device=out.device)
        oc = F.neg(other.coeffs) if negate_other else other.coeffs
        # shared degrees need a modular add, not a raw scatter-add
        out[:, ib] = F.add(out[:, ib], oc)
        return SparseUnivariate(F, degs, out)

    def __add__(self, other):
        return self._merge(other, negate_other=False)

    def __sub__(self, other):
        return self._merge(other, negate_other=True)

    def __mul__(self, other: "SparseUnivariate"):
        F = self.F
        ka, kb = len(self.degrees), len(other.degrees)
        prod_deg = [da + db for da in self.degrees for db in other.degrees]
        cf = F.mul(self.coeffs[:, :, None], other.coeffs[:, None, :]).reshape(F.W, ka * kb)
        degs = sorted(set(prod_deg))
        pos = {d: i for i, d in enumerate(degs)}
        out = F.zeros((len(degs),))
        for j, d in enumerate(prod_deg):  # k^2 static one-column adds
            out[:, pos[d]] = F.add(out[:, pos[d]], cf[:, j])
        return SparseUnivariate(F, degs, out)


class SparseMultivariate:
    """sum_j c_j * prod_i x_i^{E[j, i]}; the exponent matrix is host
    metadata (reference: multivariate_sparse_coefficients.h:28 Term/Literal)."""

    def __init__(self, F: PrimeField, exponents, coeffs: torch.Tensor):
        self.F = F
        self.E = np.array([[int(e) for e in row] for row in exponents],
                          dtype=object)  # (k, n_vars)
        if coeffs.shape[1] != self.E.shape[0]:
            raise ValueError(f"{coeffs.shape[1]} coefficients for {self.E.shape[0]} terms")
        self.coeffs = coeffs

    @classmethod
    def from_terms(cls, F: PrimeField, terms):
        """terms: list of (coeff_int, {var_index: exponent})."""
        nv = 1 + max((max(lit, default=-1) for _, lit in terms), default=-1)
        E = np.zeros((len(terms), max(nv, 1)), dtype=object)
        for j, (_, lit) in enumerate(terms):
            for v, e in lit.items():
                E[j, v] = int(e)
        cf = F.encode(np.array([c % F.p for c, _ in terms], dtype=object))
        return cls(F, E, cf)

    @property
    def num_vars(self) -> int:
        return self.E.shape[1]

    def evaluate(self, point: list) -> torch.Tensor:
        """point: list of (W,) encoded values, one per variable."""
        F = self.F
        k, nv = self.E.shape
        if k == 0:
            return F.zeros(())
        acc = self.coeffs
        for i in range(nv):
            col = self.E[:, i]
            if all(int(e) == 0 for e in col):
                continue
            xs = point[i][:, None].expand(acc.shape)
            acc = F.mul(acc, _pow_static(F, xs, col))
        return F.sum(acc, dim=1)


class LinearCombination:
    """sum_j c_j * prod_t M_{j,t}(x) over shared dense MLE tables
    (reference: linear_combination.h:26; ``combine`` sums the product terms
    over the whole hypercube, ``evaluate`` evaluates at one point)."""

    def __init__(self, F: PrimeField, num_vars: int):
        self.F = F
        self.nv = num_vars
        self.mles: list[torch.Tensor] = []  # each (W, 2^nv)
        self.terms: list[tuple[int, list[int]]] = []

    def add_mle(self, evals: torch.Tensor) -> int:
        if mle.num_vars(evals) != self.nv:
            raise ValueError(f"an MLE of {mle.num_vars(evals)} variables, not {self.nv}")
        self.mles.append(evals)
        return len(self.mles) - 1

    def add_term(self, coeff: int, mle_indices: list[int]):
        self.terms.append((coeff % self.F.p, list(mle_indices)))

    def combine(self) -> torch.Tensor:
        """The sum over the hypercube: the sumcheck's claim."""
        F = self.F
        total = F.zeros((1 << self.nv,))
        for coeff, idxs in self.terms:
            prod = F.full((1 << self.nv,), coeff)
            for t in idxs:
                prod = F.mul(prod, self.mles[t])
            total = F.add(total, prod)
        return F.sum(total, dim=1)

    def evaluate(self, point: list) -> torch.Tensor:
        F = self.F
        vals = [mle.evaluate(F, m, point) for m in self.mles]
        acc = F.zeros(())
        for coeff, idxs in self.terms:
            prod = F.full((), coeff)
            for t in idxs:
                prod = F.mul(prod, vals[t])
            acc = F.add(acc, prod)
        return acc
