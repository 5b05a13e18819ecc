"""PLONK constraint system (halo2-style columns/gates/copy constraints).

The port's own copy of ``tachyon_tpu/zk/plonk/constraint_system.py``, so
that the port imports nothing of the JAX package; only its imports differ.

Analog of the reference's halo2 constraint system
(reference: tachyon/zk/plonk/constraint_system/constraint_system.h, columns,
gates, selectors; permutation registration permutation/cycle_store.h).
Selector compression (combining simple selectors into packed fixed columns,
reference selector_compressor.h) lives in selector.py and is applied at
keygen; a single permutation argument covers all equality-enabled columns.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from tachyon_tpu_torch.zk.plonk import expressions as ex


class ColumnRef(NamedTuple):
    kind: str  # "fixed" | "advice" | "instance"
    index: int


@dataclasses.dataclass
class Gate:
    name: str
    polys: list  # list of Expr that must vanish on all rows


@dataclasses.dataclass
class LookupArgument:
    """input_exprs[i] must appear (as a theta-compressed tuple) among the
    rows of table_exprs (reference: zk/lookup/argument.h).  The
    log-derivative scheme supports several input SETS per table
    (inputs_list); the halo2 scheme always has exactly one."""

    name: str
    input_exprs: list
    table_exprs: list
    inputs_list: list = None

    def __post_init__(self):
        if self.inputs_list is None:
            self.inputs_list = [self.input_exprs]

    def required_degree(self) -> int:
        """reference: zk/lookup/argument.h:101-199 RequiredDegree (expr
        degrees floor at 1)."""
        combined = sum(
            max([ex.degree(e) for e in inputs] + [1])
            for inputs in self.inputs_list
        )
        table = max([ex.degree(e) for e in self.table_exprs] + [1])
        return max(3 + len(self.inputs_list), 2 + combined + table)


@dataclasses.dataclass
class LookupTracker:
    """log-derivative lookups keyed by table identifier: several input sets
    share one table (reference: constraint_system.h LookupTracker +
    UpdateLookupsMap)."""

    name: str
    table_exprs: list
    inputs: list  # list of input-expr lists


@dataclasses.dataclass
class ShuffleArgument:
    """input_exprs rows are a permutation of shuffle_exprs rows
    (reference: zk/shuffle/argument.h)."""

    name: str
    input_exprs: list
    shuffle_exprs: list


@dataclasses.dataclass
class ConstraintSystem:
    num_fixed: int = 0
    num_advice: int = 0
    num_instance: int = 0
    gates: list = dataclasses.field(default_factory=list)
    # permutation: columns participating in equality
    permutation_columns: list = dataclasses.field(default_factory=list)
    copies: list = dataclasses.field(default_factory=list)  # ((col, row), (col, row))
    lookups: list = dataclasses.field(default_factory=list)  # LookupArgument
    shuffles: list = dataclasses.field(default_factory=list)  # ShuffleArgument
    # "halo2" (permuted pairs, lookup/halo2/) or "log_derivative"
    # (m-poly grand sum, lookup/log_derivative_halo2/)
    lookup_type: str = "halo2"
    # ZK blinding rows (reference: zk/base/blinder.h + halo2 usable-rows
    # convention: rows [n-t-1, n) are the "last" row + t blind rows;
    # 0 = deterministic proofs)
    blinding_factors: int = 0
    # halo2-compatible query tracking (reference: constraint_system.h
    # advice_queries_/fixed_queries_/instance_queries_; indices feed the
    # pinned VK stringifier and the per-query proof layout).  Entries are
    # (column_index, rotation) in first-registration order.
    advice_queries: list = dataclasses.field(default_factory=list)
    fixed_queries: list = dataclasses.field(default_factory=list)
    instance_queries: list = dataclasses.field(default_factory=list)
    # columns usable for constant assignment (halo2 meta.enable_constant)
    constants: list = dataclasses.field(default_factory=list)
    # selector bookkeeping (count survives selector compression for the
    # pinned VK string; reference: constraint_system.h GetNumSelectors)
    num_selectors: int = 0
    minimum_degree: int | None = None
    # virtual selectors (halo2 path): True per selector iff simple
    # (reference: constraint_system.h CreateSimpleSelector/CreateComplexSelector)
    selectors: list = dataclasses.field(default_factory=list)
    # post-compression: selector index -> fixed ColumnRef
    selector_map: list = dataclasses.field(default_factory=list)
    # log-derivative lookups before chunking: table identifier -> tracker
    lookups_map: dict = dataclasses.field(default_factory=dict)
    # multi-phase (reference: constraint_system.h advice_column_phases_/
    # challenge_phases_; halo2 challenges API)
    advice_column_phases: list = dataclasses.field(default_factory=list)
    challenge_phases: list = dataclasses.field(default_factory=list)

    def usable_rows(self, n: int) -> int:
        """index u of the 'last' row: active rows are [0, u), blind rows
        (u, n); u itself carries the grand-product closing constraint."""
        if self.blinding_factors == 0:
            return n
        return n - self.blinding_factors - 1

    def fixed_column(self) -> ColumnRef:
        self.num_fixed += 1
        return ColumnRef("fixed", self.num_fixed - 1)

    def advice_column(self, phase: int = 0) -> ColumnRef:
        self.num_advice += 1
        self.advice_column_phases.append(phase)
        return ColumnRef("advice", self.num_advice - 1)

    def challenge_usable_after(self, phase: int) -> ex.Challenge:
        """register a challenge squeezed after the given phase's advice
        commitments (halo2 meta.challenge_usable_after)."""
        self.challenge_phases.append(phase)
        return ex.Challenge(len(self.challenge_phases) - 1, phase)

    @property
    def num_challenges(self) -> int:
        return len(self.challenge_phases)

    def phases(self) -> list:
        """all phases in order (reference: constraint_system.h GetPhases)."""
        top = max(self.advice_column_phases + self.challenge_phases,
                  default=0)
        return list(range(top + 1))

    def instance_column(self) -> ColumnRef:
        self.num_instance += 1
        return ColumnRef("instance", self.num_instance - 1)

    def enable_equality(self, col: ColumnRef):
        if col not in self.permutation_columns:
            self.permutation_columns.append(col)
        # halo2 enable_equality registers a Rotation::cur query immediately
        # (halo2 circuit.rs query_any_index); keeps query-index parity
        self.query_index(col, 0)

    def enable_constant(self, col: ColumnRef):
        """register a fixed column for constant assignment
        (halo2 meta.enable_constant: adds to constants + enables equality)."""
        assert col.kind == "fixed"
        if col not in self.constants:
            self.constants.append(col)
        self.enable_equality(col)

    def query_index(self, col: ColumnRef, rotation: int = 0) -> int:
        """dedup-register a (column, rotation) query; returns its index
        (reference: constraint_system.h QueryAdviceIndex etc.)."""
        table = {
            "fixed": self.fixed_queries,
            "advice": self.advice_queries,
            "instance": self.instance_queries,
        }[col.kind]
        key = (col.index, rotation)
        if key in table:
            return table.index(key)
        table.append(key)
        return len(table) - 1

    def create_simple_selector(self) -> ex.Selector:
        """Simple selector: multiplied at the top of a gate, eligible for
        combination during compression (halo2 meta.selector())."""
        self.selectors.append(True)
        self.num_selectors = len(self.selectors)
        return ex.Selector(len(self.selectors) - 1, True)

    def create_complex_selector(self) -> ex.Selector:
        """Complex selector: may appear anywhere (lookups); compressed to
        its own 0/1 fixed column (halo2 meta.complex_selector())."""
        self.selectors.append(False)
        self.num_selectors = len(self.selectors)
        return ex.Selector(len(self.selectors) - 1, False)

    def query_selector(self, sel: ex.Selector) -> ex.Selector:
        return sel

    def compute_blinding_factors(self) -> int:
        """reference: constraint_system.h:700-735 ComputeBlindingFactors:
        max(3, max #queries of any one advice column) + 2."""
        counts = {}
        for c, _r in self.advice_queries:
            counts[c] = counts.get(c, 0) + 1
        factors = max(counts.values()) if counts else 1
        factors = max(3, factors)
        return factors + 2

    def compute_extended_k(self, k: int) -> int:
        """max(ceil(log2(n * (d - 1))), k)
        (reference: constraint_system.h:691-696 ComputeExtendedK)."""
        q = self.required_degree() - 1
        val = (1 << k) * q
        return max((val - 1).bit_length(), k)

    # --- selector compression (halo2 keygen path) -------------------------
    def _extract_simple_selector(self, e):
        """the unique simple Selector inside a gate poly, or None
        (reference: expressions ExtractSimpleSelector; halo2
        extract_simple_selector)."""

        def merge(a, b):
            if a is not None and b is not None and a != b:
                raise ValueError("two simple selectors in one gate poly")
            return a if a is not None else b

        if isinstance(e, ex.Selector):
            return e if e.is_simple else None
        if isinstance(e, (ex.Negated, ex.Scaled)):
            return self._extract_simple_selector(e.expr)
        if isinstance(e, (ex.Sum, ex.Product)):
            return merge(self._extract_simple_selector(e.left),
                         self._extract_simple_selector(e.right))
        return None

    def compress_selectors(self, selector_activations: list) -> list:
        """Compress virtual selectors into fixed 'combination' columns.

        selector_activations: list (per selector) of list[bool] length n.
        Appends new fixed columns to the system, rewrites every Selector
        expression, fills selector_map, and returns the new columns' values
        (list of list[int]) to append after the circuit's fixed columns
        (reference: constraint_system.h:481-536 CompressSelectors,
        keys/key.h:104-111)."""
        from tachyon_tpu_torch.zk.plonk.selector import compress_selectors_exact

        assert len(selector_activations) == len(self.selectors)
        degrees = [0] * len(self.selectors)
        for g in self.gates:
            for poly in g.polys:
                sel = self._extract_simple_selector(poly)
                if sel is not None:
                    degrees[sel.index] = max(degrees[sel.index],
                                             ex.degree(poly))

        new_cols: list[ColumnRef] = []

        def allocate():
            col = self.fixed_column()
            new_cols.append(col)
            self.query_index(col, 0)
            return ex.Fixed(col.index, 0)

        combination_assignments, selector_assignments = (
            compress_selectors_exact(selector_activations, degrees,
                                     self.required_degree(), allocate))
        replacements = [None] * len(self.selectors)
        self.selector_map = [None] * len(self.selectors)
        for a in selector_assignments:
            replacements[a.selector_index] = a.expression
            self.selector_map[a.selector_index] = new_cols[a.combination_index]

        def substitute(e):
            if isinstance(e, ex.Selector):
                r = replacements[e.index]
                assert r is not None
                return r
            if isinstance(e, ex.Negated):
                return ex.Negated(substitute(e.expr))
            if isinstance(e, ex.Scaled):
                return ex.Scaled(substitute(e.expr), e.scale)
            if isinstance(e, ex.Sum):
                return ex.Sum(substitute(e.left), substitute(e.right))
            if isinstance(e, ex.Product):
                return ex.Product(substitute(e.left), substitute(e.right))
            return e

        for g in self.gates:
            g.polys = [substitute(p) for p in g.polys]
        for lk in self.lookups:
            lk.inputs_list = [
                [substitute(e) for e in inputs] for inputs in lk.inputs_list
            ]
            lk.input_exprs = lk.inputs_list[0]
            lk.table_exprs = [substitute(e) for e in lk.table_exprs]
        for sh in self.shuffles:
            sh.input_exprs = [substitute(e) for e in sh.input_exprs]
            sh.shuffle_exprs = [substitute(e) for e in sh.shuffle_exprs]
        return combination_assignments

    def create_gate(self, name: str, polys: list):
        self.gates.append(Gate(name, polys))

    def lookup(self, name: str, pairs: list):
        """pairs: list of (input_expr, table_expr).  In log-derivative mode
        lookups with an identical table-expression identifier merge into one
        tracker (reference: constraint_system.h:786-806 UpdateLookupsMap);
        chunk_lookups() materializes them into arguments."""
        inputs = [p[0] for p in pairs]
        tables = [p[1] for p in pairs]
        if self.lookup_type == "log_derivative":
            key = "".join(expression_identifier(e) for e in tables)
            tracker = self.lookups_map.get(key)
            if tracker is not None:
                tracker.inputs.append(inputs)
            else:
                self.lookups_map[key] = LookupTracker(name, tables, [inputs])
            return
        self.lookups.append(LookupArgument(name, inputs, tables))

    def chunk_lookups(self):
        """split the log-derivative lookup trackers into arguments under the
        degree budget (reference: constraint_system.h:266-343 ChunkLookups;
        iteration follows the btree order of table identifiers)."""
        assert self.lookup_type == "log_derivative"
        if not self.lookups_map:
            return
        max_gate_degree = max(self.max_gate_degree(), 1)

        def col_degree(exprs):
            return max([ex.degree(e) for e in exprs] + [1])

        max_single = 0
        for key in sorted(self.lookups_map):
            t = self.lookups_map[key]
            base = max(3, col_degree(t.table_exprs) + 2)
            max_inputs = max(col_degree(i) for i in t.inputs)
            max_single = max(max_single, base + max_inputs)
        required = max(max_gate_degree, max_single)
        self.minimum_degree = (1 << (required - 1).bit_length()) + 1

        for key in sorted(self.lookups_map):
            t = self.lookups_map[key]
            self.lookups.append(
                LookupArgument(t.name, list(t.inputs[0]),
                               list(t.table_exprs)))
            for inputs in t.inputs[1:]:
                added = False
                for arg in self.lookups:
                    if (arg.required_degree() + col_degree(inputs)
                            <= self.minimum_degree):
                        arg.inputs_list.append(list(inputs))
                        added = True
                        break
                if not added:
                    self.lookups.append(
                        LookupArgument(t.name, list(inputs),
                                       list(t.table_exprs)))

    def shuffle(self, name: str, pairs: list):
        """pairs: list of (input_expr, shuffle_expr)."""
        self.shuffles.append(
            ShuffleArgument(name, [p[0] for p in pairs], [p[1] for p in pairs])
        )

    def copy(self, a: tuple, b: tuple):
        """a, b: (ColumnRef, row)"""
        self.copies.append((a, b))

    def query(self, col: ColumnRef, rotation: int = 0):
        self.query_index(col, rotation)
        if col.kind == "fixed":
            return ex.Fixed(col.index, rotation)
        if col.kind == "advice":
            return ex.Advice(col.index, rotation)
        return ex.Instance(col.index, rotation)

    def collect_queries(self):
        """register any queries appearing in gate/lookup/shuffle expressions
        that were built without cs.query() (keeps the stringifier total)."""

        def walk(e):
            if isinstance(e, ex.Fixed):
                self.query_index(ColumnRef("fixed", e.column), e.rotation)
            elif isinstance(e, ex.Advice):
                self.query_index(ColumnRef("advice", e.column), e.rotation)
            elif isinstance(e, ex.Instance):
                self.query_index(ColumnRef("instance", e.column), e.rotation)
            elif isinstance(e, (ex.Negated, ex.Scaled)):
                walk(e.expr)
            elif isinstance(e, (ex.Sum, ex.Product)):
                walk(e.left)
                walk(e.right)

        for g in self.gates:
            for p in g.polys:
                walk(p)
        for lk in self.lookups:
            for inputs in lk.inputs_list:
                for e in inputs:
                    walk(e)
            for e in lk.table_exprs:
                walk(e)
        for sh in self.shuffles:
            for e in list(sh.input_exprs) + list(sh.shuffle_exprs):
                walk(e)
        # every permutation column needs its cur query registered
        for col in self.permutation_columns:
            self.query_index(col, 0)

    def max_gate_degree(self) -> int:
        return max(
            (ex.degree(p) for g in self.gates for p in g.polys), default=1
        )

    def required_degree(self) -> int:
        """max identity degree across gates/permutation/lookups/shuffles
        (reference: constraint_system.h ComputeDegree; halo2 cs.degree()).

        Per-component accounting matches halo2: transition identities gain
        the l_active (1 - l_last - l_blind) factor only when blinding is
        on; gates are never masked (selector discipline keeps them zero on
        blind rows).  With blinding the permutation argument is CHUNKED
        (halo2 permutation::Argument::required_degree == 3): chunk length
        adapts to the final degree, so it contributes the floor 3 rather
        than num_columns + 2."""
        act = 1 if self.blinding_factors > 0 else 0
        deg = max(self.max_gate_degree(), 2)
        if self.permutation_columns:
            if self.blinding_factors > 0:
                deg = max(deg, 3)
            else:
                # deterministic mode: single full-width grand product
                deg = max(deg, len(self.permutation_columns) + 2)
        for lk in self.lookups:
            din = max((ex.degree(e) for e in lk.input_exprs), default=1)
            dtb = max((ex.degree(e) for e in lk.table_exprs), default=1)
            if self.lookup_type == "halo2":
                # act * z(wx)(a'+beta)(s'+gamma) vs act * z(x)(A+b)(S+g)
                deg = max(deg, 3 + act, 1 + act + din + dtb)
            elif act:
                # multi-input log-derivative formula
                # (zk/lookup/argument.h:101-199)
                deg = max(deg, lk.required_degree())
            else:
                # deterministic legacy mode (no l_active factor)
                deg = max(deg, 1 + din + dtb, 2)
        for sh in self.shuffles:
            din = max((ex.degree(e) for e in sh.input_exprs), default=1)
            dsh = max((ex.degree(e) for e in sh.shuffle_exprs), default=1)
            deg = max(deg, 1 + act + max(din, dsh, 1))
        if self.minimum_degree is not None:
            deg = max(deg, self.minimum_degree)
        return deg

    def permutation_chunk_len(self) -> int:
        """columns per permutation grand-product chunk
        (halo2: degree - 2; unchunked when blinding is off)."""
        if self.blinding_factors == 0:
            return max(len(self.permutation_columns), 1)
        return max(self.required_degree() - 2, 1)

    def permutation_chunks(self) -> list:
        cl = self.permutation_chunk_len()
        cols = self.permutation_columns
        return [cols[i : i + cl] for i in range(0, len(cols), cl)]


class CycleStore:
    """union-find over (perm column position, row) building the sigma
    permutation (reference: zk/plonk/permutation/cycle_store.h)."""

    def __init__(self, num_cols: int, n: int):
        self.num_cols = num_cols
        self.n = n
        self.parent = np.arange(num_cols * n, dtype=np.int64)

    def _find(self, i):
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a, b):
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self.parent[ra] = rb

    def to_mapping(self) -> np.ndarray:
        """sigma: position -> next position in its cycle (num_cols*n,)."""
        groups: dict[int, list[int]] = {}
        total = self.num_cols * self.n
        for i in range(total):
            groups.setdefault(self._find(i), []).append(i)
        mapping = np.arange(total, dtype=np.int64)
        for members in groups.values():
            for k, m in enumerate(members):
                mapping[m] = members[(k + 1) % len(members)]
        return mapping


def build_permutation_mapping(cs: ConstraintSystem, n: int) -> np.ndarray:
    """(num_perm_cols, n) mapping array; entry = col'*n + row'."""
    cols = cs.permutation_columns
    col_idx = {c: i for i, c in enumerate(cols)}
    store = CycleStore(len(cols), n)
    for (ca, ra), (cb, rb) in cs.copies:
        assert ca in col_idx and cb in col_idx, "enable_equality first"
        store.union(col_idx[ca] * n + ra, col_idx[cb] * n + rb)
    return store.to_mapping().reshape(len(cols), n)


def expression_identifier(e) -> str:
    """stable identifier string of an expression; keys the log-derivative
    lookups map (reference: zk/plonk/expressions/evaluator/identifier.h)."""
    if isinstance(e, ex.Constant):
        return str(e.value)
    if isinstance(e, ex.Negated):
        return f"(-{expression_identifier(e.expr)})"
    if isinstance(e, ex.Sum):
        return (f"({expression_identifier(e.left)}+"
                f"{expression_identifier(e.right)})")
    if isinstance(e, ex.Product):
        return (f"({expression_identifier(e.left)}*"
                f"{expression_identifier(e.right)})")
    if isinstance(e, ex.Scaled):
        return f"*{e.scale}"
    if isinstance(e, ex.Fixed):
        return f"fixed[{e.column}][{e.rotation}]"
    if isinstance(e, ex.Advice):
        return f"advice[{e.column}][{e.rotation}]"
    if isinstance(e, ex.Instance):
        return f"instance[{e.column}][{e.rotation}]"
    if isinstance(e, ex.Challenge):
        return f"challenge[{e.index}]"
    if isinstance(e, ex.Selector):
        return f"selector[{e.index}]"
    raise TypeError(e)
