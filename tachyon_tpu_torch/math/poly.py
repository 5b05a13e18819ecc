"""Dense univariate polynomial helpers over (W, n) word tensors.

Port of ``tachyon_tpu/math/poly.py``: a polynomial is its (W, n)
coefficient tensor, low degree first, in Montgomery form.

``divide_by_linear`` is an n-step sequential ``lax.scan`` in the JAX
package.  At n = 2^20 a Python loop would be millions of launches, so the
port computes the same values in parallel:

    S_k = sum_{j >= k} c_j z^j          (a log-step suffix scan of adds)
    q_i = z^-(i+1) S_{i+1},  rem = S_0  (q_i = c_{i+1}, rem = c_0 at z = 0)

Field arithmetic is exact, so the words equal the scan's.
"""
from __future__ import annotations

import torch

from tachyon_tpu_torch.math.field import PrimeField


def eval_at(F: PrimeField, coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner evaluation: coeffs (W, n), z (W,) -> (W,); n sequential steps."""
    acc = F.zeros(())
    for i in range(coeffs.shape[1] - 1, -1, -1):
        acc = F.add(F.mul(acc, z), coeffs[:, i])
    return acc


def _pad_cols(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, n - a.shape[1])) if a.shape[1] < n else a


def eval_at_fast(F: PrimeField, coeffs: torch.Tensor, z_int: int) -> torch.Tensor:
    """Evaluation via a z-powers table and a log-depth tree sum."""
    n = coeffs.shape[1]
    terms = F.mul(coeffs, F.powers(z_int, n))
    m = 1 << max(n - 1, 0).bit_length()
    terms = _pad_cols(terms, m)
    while m > 1:
        m //= 2
        terms = F.add(terms[:, :m], terms[:, m:])
    return terms[:, 0]


def _suffix_sums(F: PrimeField, t: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along axis 1 (Hillis-Steele, log n adds)."""
    n = t.shape[1]
    s = 1
    while s < n:
        t = torch.cat([F.add(t[:, :n - s], t[:, s:]), t[:, n - s:]], dim=1)
        s *= 2
    return t


def divide_by_linear(F: PrimeField, coeffs: torch.Tensor,
                     z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, rem) with p(x) = q(x)(x - z) + rem; q has n - 1 coefficients."""
    n = coeffs.shape[1]
    z_int = int(F.decode(z))
    if n == 1:
        return F.zeros((0,)), coeffs[:, 0]
    if z_int == 0:
        return coeffs[:, 1:].contiguous(), coeffs[:, 0]
    suffix = _suffix_sums(F, F.mul(coeffs, F.powers(z_int, n)))
    z_inv = pow(z_int, F.p - 2, F.p)
    q = F.mul(suffix[:, 1:], F.powers(z_inv, n)[:, 1:])
    return q, suffix[:, 0]


def add(F: PrimeField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[1], b.shape[1])
    return F.add(_pad_cols(a, n), _pad_cols(b, n))


def scale(F: PrimeField, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return F.mul(a, s[:, None] if s.ndim == 1 else s)
