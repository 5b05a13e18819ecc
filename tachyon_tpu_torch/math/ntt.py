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

Also ported: ``coset_lde_batch`` (run over column chunks, the words
unchanged), ``MixedRadixDomain`` for n = 2^a 3^b (its middle twiddles built
on the device) and ``DomainCache``.
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


class DomainCache:
    """Per-field domain factory: Radix2 for powers of two, MixedRadix for
    2^a 3^b sizes (analog of UnivariateEvaluationDomainFactory,
    univariate_evaluation_domain_factory.h)."""

    def __init__(self, F: PrimeField):
        self.F = F
        self._cache: dict[int, object] = {}

    def get(self, n: int):
        if n not in self._cache:
            self._cache[n] = (Radix2Domain(self.F, n) if n & (n - 1) == 0
                              else MixedRadixDomain(self.F, n))
        return self._cache[n]


LDE_CHUNK_ELEMS = 1 << 28  # output elements of one column chunk of coset_lde_batch


def coset_lde_batch(domain: Radix2Domain, evals: torch.Tensor, log_blowup: int,
                    shift_int: int) -> torch.Tensor:
    """Plonky3-style CosetLDEBatch (reference: radix2_evaluation_domain.h:122):
    (W, n, *batch) evaluations on H -> evaluations on shift H' with
    |H'| = n << log_blowup, natural order: ``ifft``, coefficients times
    shift^i, zero padding, ``fft`` over H'.

    The columns (the batch axes, flattened) are independent, so the port
    runs them in chunks of at most LDE_CHUNK_ELEMS output elements into one
    output tensor, with the JAX package's words: the plain field add and
    sub widen their operands to int64 word columns, so one butterfly stage
    over a whole 2^23 x 100 Goldilocks LDE (6.7 GB) would hold several
    times that in temporaries.  Only the n coefficient rows are scaled by
    shift^i; the padding stays zero."""
    F = domain.F
    n, W = domain.n, evals.shape[0]
    if evals.shape[1] != n:
        raise ValueError(f"axis 1 has length {evals.shape[1]}, the domain {n}")
    big_n = n << log_blowup
    big = Radix2Domain(F, big_n)
    batch = evals.shape[2:]
    cols = evals.reshape(W, n, -1)
    C = cols.shape[2]
    out = torch.empty((W, big_n, C), dtype=evals.dtype, device=evals.device)
    chunks = max(1, -(-C * big_n // LDE_CHUNK_ELEMS))
    step = max(1, -(-C // chunks))
    sp = big.shift_powers(shift_int, n)[:, :, None]  # (W, n, 1)
    for c0 in range(0, C, step):
        coeffs = domain.ifft(cols[:, :, c0:c0 + step])
        padded = torch.zeros((W, big_n, coeffs.shape[2]), dtype=evals.dtype,
                             device=evals.device)
        padded[:, :n] = F.mul(coeffs, sp)
        del coeffs
        out[:, :, c0:c0 + step] = big.fft(padded)
        del padded
    return out.reshape(W, big_n, *batch)


class MixedRadixDomain:
    """Evaluation domain of size n = 2^a 3^b (four-step composition).

    Port of ``MixedRadixDomain`` in ``tachyon_tpu/math/ntt.py`` (reference:
    polynomials/univariate/mixed_radix_evaluation_domain.h:53; bn254's Fr
    has 3^2 in p - 1, Goldilocks 3).  Index j = j2 n1 + j1 with n1 = 3^b,
    n2 = 2^a: a batched radix-2 FFT over j2, a twiddle by w^(j1 k2), and a
    direct n1-point DFT over j1 (one base multiply of the (n1, n1) matrix by
    the rows, then n1 - 1 adds).  Output in natural order: X[k2 + n2 k1].
    The (n2, n1) middle twiddles are built on the device, w^k2 by
    log-doubling and then n1 - 1 multiplies along j1, where the JAX package
    takes a host pow for each of the n entries; the words are the same."""

    def __init__(self, F: PrimeField, n: int):
        self.F = F
        self.n = n
        p = F.p
        n2 = n & (-n)
        n1 = n // n2
        t = n1
        while t % 3 == 0:
            t //= 3
        if t != 1:
            raise ValueError(f"size {n} is not 2^a * 3^b")
        if (p - 1) % n:
            raise ValueError(f"{F.name} has no subgroup of order {n}")
        self.n1, self.n2 = n1, n2
        self.omega_int = pow(F.spec.generator, (p - 1) // n, p)
        self.omega_inv_int = pow(self.omega_int, n - 1, p)
        self.w_n1 = pow(self.omega_int, n2, p)  # order n1
        self.r2 = Radix2Domain(F, n2, omega_int=pow(self.omega_int, n1, p)) if n2 > 1 else None
        self._cache: dict = {}

    def _small_dft_matrix(self, inverse: bool) -> torch.Tensor:
        """(W, n1, n1) matrix M[k, j] = w_n1^(+-jk) (times 1/n1 if inverse)."""
        key = ("M", inverse)
        if key not in self._cache:
            p, n1 = self.F.p, self.n1
            w = pow(self.w_n1, p - 2, p) if inverse else self.w_n1
            scale = pow(n1, p - 2, p) if inverse else 1
            self._cache[key] = self.F.encode(
                [[pow(w, j * k, p) * scale % p for j in range(n1)] for k in range(n1)])
        return self._cache[key]

    def _mid_twiddles(self, inverse: bool) -> torch.Tensor:
        """(W, n2, n1) table w^(+-j1 k2), on the device."""
        key = ("T", inverse)
        if key not in self._cache:
            F = self.F
            wk = F.powers(self.omega_inv_int if inverse else self.omega_int, self.n2)
            cols = [F.ones((self.n2,)), wk]
            while len(cols) < self.n1:
                cols.append(F.mul(cols[-1], wk))
            self._cache[key] = torch.stack(cols[:self.n1], dim=2)
        return self._cache[key]

    def _apply_small_dft(self, arr: torch.Tensor, inverse: bool) -> torch.Tensor:
        """DFT_n1 over axis 2 of (W, n2, n1, *batch)."""
        F, n1 = self.F, self.n1
        M = self._small_dft_matrix(inverse)  # (W, n1, n1)
        ones = (1,) * (arr.ndim - 3)
        prod = F.mul(M.reshape(M.shape[0], 1, n1, n1, *ones), arr[:, :, None])  # (W, n2, k1, j1, *b)
        acc = prod[:, :, :, 0]
        for j in range(1, n1):
            acc = F.add(acc, prod[:, :, :, j])
        return acc

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        W, batch = coeffs.shape[0], coeffs.shape[2:]
        ones = (1,) * len(batch)
        arr = coeffs.reshape(W, self.n2, self.n1, *batch)  # [j2, j1]
        if self.r2 is not None:
            arr = self.r2.fft(arr)
        arr = self.F.mul(arr, self._mid_twiddles(False).reshape(W, self.n2, self.n1, *ones))
        out = self._apply_small_dft(arr, False)  # (W, k2, k1, *b)
        return torch.movedim(out, 2, 1).reshape(W, self.n, *batch)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        W, batch = evals.shape[0], evals.shape[2:]
        ones = (1,) * len(batch)
        arr = torch.movedim(evals.reshape(W, self.n1, self.n2, *batch), 1, 2)  # (W, k2, k1, *b)
        arr = self._apply_small_dft(arr, True)
        arr = self.F.mul(arr, self._mid_twiddles(True).reshape(W, self.n2, self.n1, *ones))
        if self.r2 is not None:
            arr = self.r2.ifft(arr)
        return arr.reshape(W, self.n, *batch)
