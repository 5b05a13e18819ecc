"""Lookup & shuffle argument helpers.

The port's own copy of ``tachyon_tpu/zk/plonk/lookup.py``, so that the port
imports nothing of the JAX package; only its imports differ.

Host-side combinatorics for the three multiset arguments:

* halo2 permuted-pair lookup — analog of the reference's
  tachyon/zk/lookup/halo2/prover_impl.h + permute_expression_pair.h:
  sort the compressed input column, lay the table out so every first
  occurrence in the sorted input is matched in place (`permute_pair`).
* log-derivative lookup (Scroll flavor) — analog of
  tachyon/zk/lookup/log_derivative_halo2/: per-table-row multiplicity
  counting (`multiplicities`).
* shuffle — analog of tachyon/zk/shuffle/prover.h: no host prep needed
  (pure grand-product), nothing here.

The grand products / grand sums themselves are computed vectorized on
device by the PLONK prover (log-depth associative scans, replacing the
reference's serial running products in grand_product_argument.h:105).
"""
from __future__ import annotations

from collections import Counter

import numpy as np


def permute_pair(a_ints, s_ints):
    """(A', S') for the halo2 lookup.

    A' = sorted input values; S'[i] = A'[i] at each first occurrence, the
    remaining slots filled with the leftover table values (any order).
    Raises if some input value is missing from the table
    (reference: permute_expression_pair.h kInvalidLookup error path).
    Returns two numpy object arrays of python ints.
    """
    n = len(a_ints)
    assert len(s_ints) == n
    a_sorted = sorted(int(v) for v in a_ints)
    leftover = Counter(int(v) for v in s_ints)
    s_perm = [None] * n
    for i, v in enumerate(a_sorted):
        if i == 0 or v != a_sorted[i - 1]:
            if leftover[v] <= 0:
                raise ValueError(f"lookup input value not in table: {v}")
            leftover[v] -= 1
            s_perm[i] = v
    fill = iter([v for v, c in leftover.items() for _ in range(c)])
    for i in range(n):
        if s_perm[i] is None:
            s_perm[i] = next(fill)
    return (
        np.array(a_sorted, dtype=object),
        np.array(s_perm, dtype=object),
    )


def multiplicities(a_ints, s_ints):
    """m[i] = how many input rows equal table row i (log-derivative lookup).

    Duplicate table values accumulate their whole count on the first
    occurrence.  Raises if an input value is missing from the table.
    """
    first: dict[int, int] = {}
    for i, v in enumerate(s_ints):
        first.setdefault(int(v), i)
    m = [0] * len(s_ints)
    for v in a_ints:
        vi = int(v)
        if vi not in first:
            raise ValueError(f"lookup input value not in table: {vi}")
        m[first[vi]] += 1
    return np.array(m, dtype=object)


def compress(F, ev, exprs, theta: int):
    """theta-fold a list of expressions into one column:
    sum_i theta^(k-1-i) * eval(expr_i)  (reference: lookup/compress.h
    CompressExpressions — horner in theta)."""
    acc = None
    tc = F.full((), theta)[:, None]
    for e in exprs:
        v = ev.eval(e)
        acc = v if acc is None else F.add(F.mul(acc, tc), v)
    return acc


def compress_scalar(p: int, sev, exprs, theta: int) -> int:
    """host-int version of `compress` at a single point."""
    acc = None
    for e in exprs:
        v = sev.eval(e)
        acc = v if acc is None else (acc * theta + v) % p
    return acc
