"""Radix-2 NTT / evaluation domain over (W, n, *batch) word tensors.

Port of ``Radix2Domain`` in ``tachyon_tpu/math/ntt.py``: one bit-reverse
gather, then log2(n) DIT butterfly stages, each a reshape, one field
multiply by the stage's twiddles (K1 on the card) and a field add and sub
over the whole array; the inverse scales by 1/n.  The twiddle table (n/2
powers of w) is built on the device by log-doubling and cached per
direction; each stage reads a strided slice of it.  Trailing batch axes
ride along.  The JAX package has no Pallas kernel here either: its stages
are XLA ops over ``mont.mul``.

Conventions as in the JAX package: ``fft(coeffs)`` gives natural-order
evaluations [p(w^i)]_i, ``ifft`` inverts exactly; Montgomery form throughout.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tachyon_tpu_torch.math.field import PrimeField


@functools.lru_cache(maxsize=None)
def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class Radix2Domain:
    """Evaluation domain of size n = 2^log_n over PrimeField F."""

    def __init__(self, F: PrimeField, n: int, omega_int: int | None = None):
        if n < 1 or n & (n - 1):
            raise ValueError(f"domain size {n} is not a power of two")
        self.F = F
        self.n = n
        self.log_n = n.bit_length() - 1
        spec = F.spec
        if omega_int is None:
            if self.log_n > spec.two_adicity:
                raise ValueError(f"{spec.name} has no 2^{self.log_n}-th root of unity")
            omega_int = spec.root_of_unity(n)
        self.omega_int = omega_int
        self.omega_inv_int = pow(self.omega_int, n - 1, spec.p)
        self.n_inv_int = pow(n, spec.p - 2, spec.p)
        self._tw_cache: dict[bool, torch.Tensor] = {}

    def twiddles(self, inverse: bool) -> torch.Tensor:
        """(W, n/2) table of w^j (or w^-j), built on the device by log-doubling."""
        if inverse not in self._tw_cache:
            w = self.omega_inv_int if inverse else self.omega_int
            self._tw_cache[inverse] = self.F.powers(w, max(self.n // 2, 1))
        return self._tw_cache[inverse]

    def _transform(self, coeffs: torch.Tensor, inverse: bool) -> torch.Tensor:
        """DIT FFT over axis 1 of (W, n, *batch)."""
        F = self.F
        n, log_n = self.n, self.log_n
        if coeffs.shape[1] != n:
            raise ValueError(f"axis 1 has length {coeffs.shape[1]}, the domain {n}")
        if n == 1:
            return coeffs
        perm = torch.from_numpy(_bitrev_perm(log_n)).to(coeffs.device)
        x = coeffs.index_select(1, perm)
        tw = self.twiddles(inverse)  # (W, n/2)
        batch = coeffs.shape[2:]
        W = coeffs.shape[0]
        ones = (1,) * len(batch)
        for s in range(log_n):
            m = 1 << (s + 1)
            w = tw[:, ::n // m].reshape(W, 1, m // 2, *ones)  # w^(j n/m), j < m/2
            xr = x.reshape(W, n // m, 2, m // 2, *batch)
            u = xr[:, :, 0]
            v = F.mul(xr[:, :, 1], w)
            x = torch.stack([F.add(u, v), F.sub(u, v)], dim=2).reshape(W, n, *batch)
        if inverse:
            x = F.mul(x, F.full((), self.n_inv_int).reshape((W,) + (1,) * (x.ndim - 1)))
        return x

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """coefficients -> evaluations on the domain (natural order)."""
        return self._transform(coeffs, inverse=False)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """evaluations -> coefficients."""
        return self._transform(evals, inverse=True)

    # --- coset ops -------------------------------------------------------------
    def shift_powers(self, shift_int: int, count: int | None = None) -> torch.Tensor:
        """(W, count) table of shift^i via device log-doubling."""
        return self.F.powers(shift_int, count or self.n)

    def _scale_rows(self, a: torch.Tensor, shift_int: int) -> torch.Tensor:
        sp = self.shift_powers(shift_int)
        return self.F.mul(a, sp.reshape(sp.shape + (1,) * (a.ndim - 2)))

    def coset_fft(self, coeffs: torch.Tensor, shift_int: int) -> torch.Tensor:
        """evaluations of p on the coset shift*H: FFT(coeffs .* shift^i)."""
        return self.fft(self._scale_rows(coeffs, shift_int))

    def coset_ifft(self, evals: torch.Tensor, shift_int: int) -> torch.Tensor:
        inv_shift = pow(shift_int, self.F.p - 2, self.F.p)
        return self._scale_rows(self.ifft(evals), inv_shift)
