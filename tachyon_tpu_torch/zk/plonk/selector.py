"""Selector compression: pack disjoint boolean selectors into shared
fixed columns.

The port's own copy of ``tachyon_tpu/zk/plonk/selector.py``, so that the
port imports nothing of the JAX package; only its imports differ.

Analog of the reference's SelectorCompressor
(reference: tachyon/zk/plonk/constraint_system/selector_compressor.h,
selector_assignment.h; halo2's compress_selectors).  Selectors that are
never active on the same row share one fixed "combination" column C whose
value at a row is the 1-based position of the active selector (0 = none).
Each selector expression q_j is rewritten to the interpolation polynomial

    P_j(C) = prod_{i in {0..k}, i != pos_j} (C - i) / (pos_j - i)

which is 1 exactly when C = pos_j and 0 on every other value C takes.
Grouping is greedy with a max group size bound standing in for the
reference's gate-degree budget (documented simplification; the degree
increase per gate is the group size k).
"""
from __future__ import annotations

import numpy as np

from tachyon_tpu_torch.zk.plonk import expressions as ex


def _rewrite(e, mapping):
    """replace Selector-placeholder Fixed refs via mapping: old fixed index
    -> expression."""
    if isinstance(e, ex.Fixed) and e.column in mapping:
        assert e.rotation == 0, "selector queries have rotation 0"
        return mapping[e.column]
    if isinstance(e, ex.Negated):
        return ex.Negated(_rewrite(e.expr, mapping))
    if isinstance(e, ex.Scaled):
        return ex.Scaled(_rewrite(e.expr, mapping), e.scale)
    if isinstance(e, ex.Sum):
        return ex.Sum(_rewrite(e.left, mapping), _rewrite(e.right, mapping))
    if isinstance(e, ex.Product):
        return ex.Product(_rewrite(e.left, mapping), _rewrite(e.right, mapping))
    return e


def compress_selectors(
    cs,
    selector_cols: list[int],
    fixed_values: list,
    p: int,
    max_group: int = 3,
):
    """Compress the given fixed columns (0/1 selectors) in place.

    cs: ConstraintSystem whose gates reference the selectors as Fixed
    columns; selector_cols: indices of fixed columns that are boolean
    selectors; fixed_values: per fixed column numpy object arrays.
    Returns the new fixed_values list (selector columns replaced by fewer
    combination columns); cs.gates/lookups/shuffles are rewritten.
    """
    acts = {
        c: np.asarray(fixed_values[c], dtype=object) != 0
        for c in selector_cols
    }
    # greedy disjoint grouping
    groups: list[list[int]] = []
    for c in selector_cols:
        placed = False
        for g in groups:
            if len(g) >= max_group:
                continue
            if not any((acts[c] & acts[o]).any() for o in g):
                g.append(c)
                placed = True
                break
        if not placed:
            groups.append([c])
    # build combination columns + rewrite map
    n = len(fixed_values[selector_cols[0]]) if selector_cols else 0
    new_cols: list[np.ndarray] = []
    mapping: dict[int, object] = {}
    for g in groups:
        col = np.zeros(n, dtype=object)
        k = len(g)
        col_index = cs.num_fixed + len(new_cols)
        for pos, c in enumerate(g, start=1):
            col[acts[c]] = pos
        new_cols.append(col)
        cref = ex.Fixed(col_index)
        for pos, c in enumerate(g, start=1):
            # interpolation over the value set {0..k} hitting 1 at pos
            expr = None
            denom = 1
            for i in range(k + 1):
                if i == pos:
                    continue
                term = ex.Sum(cref, ex.Constant(-i % p))
                expr = term if expr is None else ex.Product(expr, term)
                denom = denom * (pos - i) % p
            scale = pow(denom, p - 2, p)
            mapping[c] = ex.Scaled(expr, scale)
    # rewrite all registered expressions
    for gate in cs.gates:
        gate.polys = [_rewrite(e, mapping) for e in gate.polys]
    for lk in cs.lookups:
        lk.input_exprs = [_rewrite(e, mapping) for e in lk.input_exprs]
        lk.table_exprs = [_rewrite(e, mapping) for e in lk.table_exprs]
    for sh in cs.shuffles:
        sh.input_exprs = [_rewrite(e, mapping) for e in sh.input_exprs]
        sh.shuffle_exprs = [_rewrite(e, mapping) for e in sh.shuffle_exprs]

    # drop the original selector columns, append combinations; reindex
    keep = [i for i in range(cs.num_fixed) if i not in set(selector_cols)]
    reindex = {old: new for new, old in enumerate(keep)}
    for i, col in enumerate(new_cols):
        reindex[cs.num_fixed + i] = len(keep) + i

    def reindex_expr(e):
        if isinstance(e, ex.Fixed):
            return ex.Fixed(reindex[e.column], e.rotation)
        if isinstance(e, ex.Negated):
            return ex.Negated(reindex_expr(e.expr))
        if isinstance(e, ex.Scaled):
            return ex.Scaled(reindex_expr(e.expr), e.scale)
        if isinstance(e, ex.Sum):
            return ex.Sum(reindex_expr(e.left), reindex_expr(e.right))
        if isinstance(e, ex.Product):
            return ex.Product(reindex_expr(e.left), reindex_expr(e.right))
        return e

    for gate in cs.gates:
        gate.polys = [reindex_expr(e) for e in gate.polys]
    for lk in cs.lookups:
        lk.input_exprs = [reindex_expr(e) for e in lk.input_exprs]
        lk.table_exprs = [reindex_expr(e) for e in lk.table_exprs]
    for sh in cs.shuffles:
        sh.input_exprs = [reindex_expr(e) for e in sh.input_exprs]
        sh.shuffle_exprs = [reindex_expr(e) for e in sh.shuffle_exprs]
    # permutation columns that were fixed get reindexed too
    from tachyon_tpu_torch.zk.plonk.constraint_system import ColumnRef

    cs.permutation_columns = [
        ColumnRef("fixed", reindex[c.index]) if c.kind == "fixed" else c
        for c in cs.permutation_columns
    ]
    cs.copies = [
        tuple(
            ((ColumnRef("fixed", reindex[col.index]), row)
             if col.kind == "fixed" else (col, row))
            for (col, row) in pair
        )
        for pair in cs.copies
    ]

    # remap surviving fixed queries through the reindex (dropping queries
    # to removed selector columns); the rewritten gate expressions register
    # the new combination-column queries via collect_queries
    cs.fixed_queries = [
        (reindex[c], r) for (c, r) in cs.fixed_queries if c in reindex
    ]
    new_fixed = [fixed_values[i] for i in keep] + new_cols
    cs.num_fixed = len(new_fixed)
    cs.num_selectors = len(selector_cols)
    cs.collect_queries()
    return new_fixed


# --- halo2-exact compressor (bit-compatible keygen path) -------------------
#
# Deterministic reimplementation of the reference's SelectorCompressor
# (reference: tachyon/zk/plonk/constraint_system/selector_compressor.h:62-283,
# exclusion_matrix.h, selector_assignment.h; halo2's compress_selectors).
# Used by the halo2-compatible keygen: the combination assignments become new
# fixed columns appended after the circuit's own, and every Selector
# expression is substituted so pinned VK strings and fixed commitments match
# upstream halo2 bit-for-bit.

class SelectorAssignment:
    def __init__(self, selector_index, combination_index, expression):
        self.selector_index = selector_index
        self.combination_index = combination_index
        self.expression = expression


def compress_selectors_exact(selectors_in, degrees, max_degree, allocate):
    """selectors_in: list of list[bool] activations; degrees[i]: the max
    degree of any gate poly using selector i (0 for complex/unused);
    max_degree: the constraint system degree budget; allocate(): creates a
    fresh fixed column and returns its Rotation-cur expression.

    Returns (combination_assignments, selector_assignments): the new fixed
    column values (ints 0..k) and the substitution expressions.
    """
    if not selectors_in:
        return [], []
    n = len(selectors_in[0])
    assert all(len(a) == n for a in selectors_in)

    combination_assignments = []
    selector_assignments = []

    # zero-degree selectors (complex or unused in gates) first, in order
    remaining = []
    for idx, acts in enumerate(selectors_in):
        if degrees[idx] == 0:
            expression = allocate()
            combination_index = len(combination_assignments)
            combination_assignments.append([1 if b else 0 for b in acts])
            selector_assignments.append(
                SelectorAssignment(idx, combination_index, expression))
        else:
            remaining.append((idx, acts, degrees[idx]))

    # exclusion: two selectors conflict iff active on a common row
    def exclusive(a, b):
        return any(x and y for x, y in zip(a, b))

    added = [False] * len(remaining)
    for i in range(len(remaining)):
        if added[i]:
            continue
        added[i] = True
        sel_idx, acts, deg = remaining[i]
        assert deg <= max_degree, "selector degree exceeds budget"
        d = deg - 1  # virtual selector omitted: it will be substituted
        combination = [(sel_idx, acts, deg)]
        comb_pos = [i]
        for j in range(i + 1, len(remaining)):
            if d + len(combination) == max_degree:
                break  # nothing more fits
            if added[j]:
                continue
            _, acts_j, deg_j = remaining[j]
            if any(exclusive(acts_j, remaining[k][1]) for k in comb_pos):
                continue
            new_d = max(d, deg_j - 1)
            if new_d + len(combination) + 1 > max_degree:
                continue
            d = new_d
            combination.append(remaining[j])
            comb_pos.append(j)
            added[j] = True

        # construct the combined selector column + substitution exprs
        combination_assignment = [0] * n
        combination_len = len(combination)
        combination_index = len(combination_assignments)
        query = allocate()
        for assigned_root, (s_idx, s_acts, _) in enumerate(combination, 1):
            # q * prod_{root != assigned_root, 1<=root<=len}(root - q)
            expression = query
            for root in range(1, combination_len + 1):
                if root != assigned_root:
                    expression = ex.Product(
                        expression,
                        ex.Sum(ex.Constant(root), ex.Negated(query)),
                    )
            for r in range(n):
                if s_acts[r]:
                    combination_assignment[r] = assigned_root
            selector_assignments.append(
                SelectorAssignment(s_idx, combination_index, expression))
        combination_assignments.append(combination_assignment)
    return combination_assignments, selector_assignments
