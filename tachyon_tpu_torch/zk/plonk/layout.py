"""Circuit synthesis API: Layouter / Region / floor planners.

The port's own copy of ``tachyon_tpu/zk/plonk/layout.py``, so that the port
imports nothing of the JAX package; only its imports differ.

Analog of the reference's halo2 layout layer
(reference: tachyon/zk/plonk/layout/layouter.h, region.h,
floor_planner/simple_floor_planner.h — sequential placement — and
floor_planner/v1/ — the two-pass measure-then-pack planner with the
slot-in-biggest-advice-first strategy, v1/v1_strategy.h).

Usage mirrors halo2:

    class MyCircuit:
        def configure(self, cs) -> config        # register columns/gates
        def synthesize(self, config, layouter)   # assign witness by region

    planner = SimpleFloorPlanner(cs, n)
    assignment = planner.synthesize(circuit, config)
    # assignment.fixed / .advice / .instance -> keygen + prover inputs
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from tachyon_tpu_torch.zk.plonk.constraint_system import ColumnRef, ConstraintSystem


@dataclasses.dataclass(frozen=True)
class Cell:
    column: ColumnRef
    row: int


class Assignment:
    """Collected column values (numpy object arrays of ints) + copies."""

    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.fixed = [np.zeros(n, dtype=object) for _ in range(cs.num_fixed)]
        self.advice = [np.zeros(n, dtype=object) for _ in range(cs.num_advice)]
        self.instance = [
            np.zeros(n, dtype=object) for _ in range(cs.num_instance)
        ]
        # virtual selector activations (halo2 Assembly::selectors;
        # reference: zk/plonk/keys/assembly.h) — compressed into fixed
        # columns at keygen
        self.selectors = [
            [False] * n for _ in range(len(getattr(cs, "selectors", [])))
        ]

    def enable_selector(self, sel, row: int):
        assert 0 <= row < self.n
        self.selectors[sel.index][row] = True

    def set(self, col: ColumnRef, row: int, value: int):
        assert 0 <= row < self.n, f"row {row} out of range"
        table = {"fixed": self.fixed, "advice": self.advice,
                 "instance": self.instance}[col.kind]
        table[col.index][row] = int(value)

    def get(self, col: ColumnRef, row: int) -> int:
        table = {"fixed": self.fixed, "advice": self.advice,
                 "instance": self.instance}[col.kind]
        return int(table[col.index][row])


class Region:
    """A contiguous row window; offsets are region-relative
    (reference: layout/region.h AssignAdvice/AssignFixed/ConstrainEqual)."""

    def __init__(self, planner: "SimpleFloorPlanner", start: int):
        self._p = planner
        self.start = start
        self.rows_used = 0
        # (value, advice Cell) pairs the layouter copies into the constants
        # column after the region completes (reference:
        # single_chip_layouter.h:103-126)
        self.constants: list = []

    def _touch(self, offset: int):
        self.rows_used = max(self.rows_used, offset + 1)

    def enable_selector(self, sel, offset: int):
        self._touch(offset)
        self._p.assignment.enable_selector(sel, self.start + offset)

    def assign_advice_from_constant(
        self, value: int, col: ColumnRef, offset: int
    ) -> Cell:
        """assign an advice cell to a constant; the layouter pins it against
        the constants fixed column (halo2 assign_advice_from_constant)."""
        cell = self.assign_advice(col, offset, value)
        self.constants.append((int(value), cell))
        return cell

    def assign_advice(self, col: ColumnRef, offset: int, value: int) -> Cell:
        assert col.kind == "advice"
        self._touch(offset)
        self._p.assignment.set(col, self.start + offset, value)
        return Cell(col, self.start + offset)

    def assign_fixed(self, col: ColumnRef, offset: int, value: int) -> Cell:
        assert col.kind == "fixed"
        self._touch(offset)
        self._p.assignment.set(col, self.start + offset, value)
        return Cell(col, self.start + offset)

    def assign_advice_from_instance(
        self, inst: ColumnRef, inst_row: int, col: ColumnRef, offset: int
    ) -> Cell:
        """copy a public input into an advice cell; copy order is
        (advice, instance) (reference: plan_region.h:65-80)."""
        v = self._p.assignment.get(inst, inst_row)
        cell = self.assign_advice(col, offset, v)
        self._p.cs.copy((col, cell.row), (inst, inst_row))
        return cell

    def constrain_equal(self, a: Cell, b: Cell):
        self._p.cs.copy((a.column, a.row), (b.column, b.row))


class SimpleFloorPlanner:
    """Reference-exact simple floor planner (reference:
    floor_planner/simple_floor_planner.h + single_chip_layouter.h:49-127).

    Each region runs a measurement pass (column footprint + height), is
    placed at the earliest row at which none of ITS columns are in use
    (per-column cursors, NOT a global cursor), then runs the assignment
    pass.  Constants collected by the region are assigned in order into the
    first constants column, advancing that column's cursor."""

    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.assignment = Assignment(cs, n)
        # RegionColumn -> next free row; keys are ColumnRef or
        # ("selector", index)
        self._columns: dict = {}
        self.region_starts: list[int] = []

    # Layouter surface ------------------------------------------------------
    def assign_region(self, name: str, fn: Callable[[Region], object]):
        shape = _ShapeRegion()
        fn(shape)
        start = max(
            (self._columns.get(c, 0) for c in shape.columns), default=0
        )
        self.region_starts.append(start)
        for c in shape.columns:
            self._columns[c] = start + shape.rows_used
        region = Region(self, start)
        out = fn(region)
        if region.constants:
            assert self.cs.constants, "no columns for constants"
            ccol = self.cs.constants[0]
            row = self._columns.get(ccol, 0)
            for value, cell in region.constants:
                self.assignment.set(ccol, row, value)
                self.cs.copy((ccol, row), (cell.column, cell.row))
                row += 1
            self._columns[ccol] = row
        return out

    def constrain_instance(self, cell: Cell, inst: ColumnRef, row: int):
        self.cs.copy((cell.column, cell.row), (inst, row))

    def set_instance(self, inst: ColumnRef, row: int, value: int):
        self.assignment.set(inst, row, value)

    def synthesize(self, circuit, config):
        circuit.synthesize(config, self)
        return self.assignment


class _ShapeRegion:
    """Measurement-pass region: records the column/row footprint without
    assigning (reference: floor_planner/v1/measurement_pass.h
    RegionShape)."""

    def __init__(self):
        self.columns: set = set()
        self.rows_used = 0
        self.advice_cells = 0

    def _touch(self, col: ColumnRef, offset: int):
        self.columns.add(col)
        self.rows_used = max(self.rows_used, offset + 1)

    def assign_advice(self, col: ColumnRef, offset: int, value: int) -> Cell:
        self._touch(col, offset)
        self.advice_cells += 1
        return Cell(col, offset)  # placeholder cell; ignored downstream

    def assign_fixed(self, col: ColumnRef, offset: int, value: int) -> Cell:
        self._touch(col, offset)
        return Cell(col, offset)

    def assign_advice_from_instance(self, inst, inst_row, col, offset) -> Cell:
        self._touch(col, offset)
        self.advice_cells += 1
        return Cell(col, offset)

    def assign_advice_from_constant(self, value, col, offset) -> Cell:
        self._touch(col, offset)
        self.advice_cells += 1
        return Cell(col, offset)

    def enable_selector(self, sel, offset: int):
        self.columns.add(("selector", sel.index))
        self.rows_used = max(self.rows_used, offset + 1)

    def constrain_equal(self, a: Cell, b: Cell):
        pass  # copies recorded in the assignment pass only


class _Allocations:
    """Disjoint allocated [start, start+len) intervals on one column
    (reference: floor_planner/allocations.h)."""

    def __init__(self):
        self.spans: list = []  # sorted (start, length)

    def insert(self, start: int, length: int):
        self.spans.append((start, length))
        self.spans.sort()

    def unbounded_interval_start(self) -> int:
        if not self.spans:
            return 0
        s, ln = self.spans[-1]
        return s + ln

    def free_intervals(self, start: int, end):
        """unallocated non-empty intervals intersecting [start, end);
        end=None is unbounded; yields (s, e_or_None)."""
        out = []
        row = start
        for s, ln in self.spans:
            if end is not None and s >= end:
                break
            if row < s:
                out.append((row, s))
            row = max(row, s + ln)
        if end is None or row < end:
            out.append((row, end))
        return out


def _first_fit_region(allocs: dict, cols: list, length: int, start: int,
                      slack):
    """recursive first-fit with slack propagation
    (reference: v1/v1_strategy.cc FirstFitRegion)."""
    if not cols:
        return start
    c, rest = cols[0], cols[1:]
    end = start + length + slack if slack is not None else None
    alloc = allocs.setdefault(c, _Allocations())
    for s, e in alloc.free_intervals(start, end):
        s_slack = e - s - length if e is not None else None
        if s_slack is None or s_slack >= 0:
            row = _first_fit_region(allocs, rest, length, s, s_slack)
            if row is not None:
                alloc.insert(row, length)
                return row
    return None


def _region_column_sort_key(col):
    """RegionColumn ordering: columns before selectors; across column types
    Instance < Advice < Fixed; ties keep insertion order (reference:
    region_column.h:49-56, column_key.h:166-182)."""
    if isinstance(col, tuple) and col and col[0] == "selector":
        return (1, col[1])
    rank = {"instance": 1, "advice": 2, "fixed": 3}[col.kind]
    return (0, rank)


class V1FloorPlanner:
    """halo2's V1 floor planner (reference: floor_planner/v1/):

    pass 1 measures every region (column footprint + height); regions are
    sorted by advice area (columns x rows) descending and packed with the
    recursive first-fit strategy over per-column free intervals; constants
    are positioned in the constants columns' free intervals below the
    first unassigned row; pass 2 replays synthesis at the packed starts."""

    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.assignment = Assignment(cs, n)
        self._measuring = True
        self._shapes: list[_ShapeRegion] = []
        self._starts: list[int] = []
        self._region_idx = 0
        self._constants: list = []  # (value, Cell) across regions, in order
        self._constant_positions: list = []

    # Layouter surface ------------------------------------------------------
    def assign_region(self, name: str, fn: Callable[[Region], object]):
        if self._measuring:
            shape = _ShapeRegion()
            out = fn(shape)
            self._shapes.append(shape)
            return out
        region = Region(self, self._starts[self._region_idx])
        self._region_idx += 1
        out = fn(region)
        self._constants.extend(region.constants)
        return out

    def constrain_instance(self, cell: Cell, inst: ColumnRef, row: int):
        if not self._measuring:
            self.cs.copy((cell.column, cell.row), (inst, row))

    def set_instance(self, inst: ColumnRef, row: int, value: int):
        if not self._measuring:
            self.assignment.set(inst, row, value)

    def _pack(self):
        """SlotInBiggestAdviceFirst (v1/v1_strategy.h:98-140): ascending
        stable sort by advice area then reverse (reversed tie order, as the
        reference's sort+reverse produces), then first-fit each region."""

        def advice_area(shape):
            cols = sum(
                1 for c in shape.columns
                if not (isinstance(c, tuple) and c[0] == "selector")
                and c.kind == "advice"
            )
            return cols * shape.rows_used

        order = sorted(range(len(self._shapes)),
                       key=lambda i: advice_area(self._shapes[i]))
        order.reverse()
        allocs: dict = {}
        starts = [0] * len(self._shapes)
        for i in order:
            shape = self._shapes[i]
            cols = sorted(shape.columns, key=_region_column_sort_key)
            row = _first_fit_region(allocs, cols, shape.rows_used, 0, None)
            assert row is not None
            starts[i] = row
        self._starts = starts
        self._allocs = allocs

    def _position_constants(self):
        """constant cells go into the constants columns' free intervals
        below the first unassigned row (v1_floor_planner.h:70-105)."""
        first_unassigned = max(
            (a.unbounded_interval_start() for a in self._allocs.values()),
            default=0,
        )
        positions = []
        for col in self.cs.constants:
            alloc = self._allocs.get(col, _Allocations())
            for s, e in alloc.free_intervals(0, first_unassigned):
                for row in range(s, e):
                    positions.append((col, row))
        self._constant_positions = positions

    def synthesize(self, circuit, config):
        self._measuring = True
        self._shapes = []
        circuit.synthesize(config, self)  # measurement pass
        self._pack()
        self._position_constants()
        self._measuring = False
        self._region_idx = 0
        self._constants = []
        circuit.synthesize(config, self)  # assignment pass
        assert len(self._constant_positions) >= len(self._constants), \
            "not enough columns for constants"
        for (value, cell), (col, row) in zip(self._constants,
                                             self._constant_positions):
            self.assignment.set(col, row, value)
            self.cs.copy((col, row), (cell.column, cell.row))
        return self.assignment


class LookupTable:
    """Lookup-table assignment surface (reference:
    layout/lookup_table.h + floor_planner/simple_lookup_table_layouter.h).
    Cells are assigned at absolute rows; after the callback the layouter
    fills [first_unused, usable_rows) of each column with its row-0
    default value (lookup_table_assigner.h:75-84)."""

    def __init__(self, assignment: Assignment):
        self._a = assignment
        self.columns: dict = {}  # ColumnRef -> {row: value}

    def assign_cell(self, col: ColumnRef, row: int, value: int):
        assert col.kind == "fixed"
        self._a.set(col, row, value)
        self.columns.setdefault(col, {})[row] = int(value)


def _assign_lookup_table(planner, fn):
    table = LookupTable(planner.assignment)
    fn(table)
    n = planner.n
    usable = n - (planner.cs.blinding_factors + 1) \
        if planner.cs.blinding_factors else n
    for col, cells in table.columns.items():
        first_unused = max(cells) + 1
        assert set(cells) == set(range(first_unused)), \
            "table column has gaps"
        default = cells[0]
        for row in range(first_unused, usable):
            planner.assignment.set(col, row, default)


def _planner_assign_lookup_table(self, name, fn):
    _assign_lookup_table(self, fn)


SimpleFloorPlanner.assign_lookup_table = _planner_assign_lookup_table


def _v1_assign_lookup_table(self, name, fn):
    if self._measuring:
        return
    _assign_lookup_table(self, fn)


V1FloorPlanner.assign_lookup_table = _v1_assign_lookup_table


def _get_challenge(self, challenge):
    """phase challenge value during witness synthesis, or None at keygen
    (reference: layouter.h GetChallenge / witness_collection.h)."""
    return getattr(self, "challenges", {}).get(challenge.index)


SimpleFloorPlanner.get_challenge = _get_challenge
V1FloorPlanner.get_challenge = _get_challenge
