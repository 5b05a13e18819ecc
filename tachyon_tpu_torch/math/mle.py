"""Dense multilinear extensions (the sumcheck's tables).

Port of ``tachyon_tpu/math/mle.py`` (reference: tachyon/math/polynomials/
multivariate/multilinear_dense_evaluations.h, multilinear_extension.h).
An MLE over k variables is its (W, 2^k) evaluation table on the boolean
hypercube; every op is whole-table tensor work, its multiplies K1 on the
card.
"""
from __future__ import annotations

import torch

from tachyon_tpu_torch.math.field import PrimeField


def num_vars(evals: torch.Tensor) -> int:
    n = evals.shape[1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"table of {n} entries is not a power of two")
    return n.bit_length() - 1


def fix_first_variable(F: PrimeField, evals: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """f(x1..xk) -> f(r, x2..xk): the table halves.  The first variable is
    the low bit of the index (its parity), the reference's FixVariables
    order: (1 - r) lo + r hi = lo + r (hi - lo)."""
    lo, hi = evals[:, 0::2], evals[:, 1::2]
    return F.add(lo, F.mul(r[:, None] if r.ndim == 1 else r, F.sub(hi, lo)))


def evaluate(F: PrimeField, evals: torch.Tensor, point: list) -> torch.Tensor:
    """The table's value at a point (a list of (W,) field elements)."""
    cur = evals
    for r in point:
        cur = fix_first_variable(F, cur, r)
    return cur[:, 0]
