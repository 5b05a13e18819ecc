"""Multilinear sumcheck prover and verifier (arkworks-style).

Port of ``tachyon_tpu/crypto/sumcheck.py`` (reference: tachyon/crypto/
sumcheck/multilinear/sumcheck_prover.h Round, sumcheck_verifier.h).  Proves
the sum over the boolean hypercube of a product of d multilinear tables.  A
round's evaluations are whole-table tensor work on the device (K1 and the
field adds); the challenges come from a caller's sampler on host ints.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tachyon_tpu_torch.math import mle
from tachyon_tpu_torch.math.field import PrimeField


class SumcheckProof(NamedTuple):
    round_evals: tuple  # per round: d + 1 ints, g_i at 0..d
    claimed_sum: int


def _tree_sum(F: PrimeField, arr: torch.Tensor) -> torch.Tensor:
    """The sum over axis 1 of (W, 2^k) by halving adds, as the JAX package
    sums (any order gives the same canonical words)."""
    n = arr.shape[1]
    while n > 1:
        half = n // 2
        arr = F.add(arr[:, :half], arr[:, half:2 * half])
        n = half
    return arr[:, 0]


def _product_sum(F: PrimeField, tables: list) -> int:
    prod = tables[0]
    for m in tables[1:]:
        prod = F.mul(prod, m)
    return int(F.decode(_tree_sum(F, prod)))


def prove(F: PrimeField, mles: list, sample_challenge: Callable[[list], int]
          ) -> tuple[SumcheckProof, list]:
    """mles: (W, 2^k) tables whose product is summed.  In each round the
    prover sends g(t) = sum over x' of prod_i f_i(t, x') at t = 0..d and
    fixes the first variable at ``sample_challenge(evals)``.  Returns the
    proof and the challenges."""
    d, k, p = len(mles), mle.num_vars(mles[0]), F.p
    claimed = _product_sum(F, mles)
    cur = list(mles)
    rounds, challenges = [], []
    for _ in range(k):
        evals_t = []
        for t in range(d + 1):
            tc = F.full((), t)
            evals_t.append(_product_sum(F, [mle.fix_first_variable(F, m, tc) for m in cur]))
        r = sample_challenge(evals_t) % p
        challenges.append(r)
        rc = F.encode(r)
        cur = [mle.fix_first_variable(F, m, rc) for m in cur]
        rounds.append(tuple(evals_t))
    return SumcheckProof(tuple(rounds), claimed), challenges


def _interp_eval(ys: list, x: int, p: int) -> int:
    """The degree-d polynomial through (0..d, ys) at x (host ints)."""
    d = len(ys) - 1
    acc = 0
    for i in range(d + 1):
        num, den = 1, 1
        for j in range(d + 1):
            if i != j:
                num = num * (x - j) % p
                den = den * (i - j) % p
        acc = (acc + ys[i] * num * pow(den, p - 2, p)) % p
    return acc


def verify(F: PrimeField, proof: SumcheckProof, final_evals: list,
           sample_challenge: Callable[[list], int]) -> bool:
    """final_evals: the prover's f_i(r), checked by the caller against
    commitments or a direct evaluation."""
    p = F.p
    expected = proof.claimed_sum % p
    for evals_t in proof.round_evals:
        if (evals_t[0] + evals_t[1]) % p != expected:  # g(0) + g(1) = the running claim
            return False
        r = sample_challenge(list(evals_t)) % p
        expected = _interp_eval(list(evals_t), r, p)
    final = 1
    for v in final_evals:
        final = final * v % p
    return final == expected
