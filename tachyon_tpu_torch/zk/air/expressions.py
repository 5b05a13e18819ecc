"""AIR expression AST (Plonky3-style).

The port's own copy of ``tachyon_tpu/zk/air/expressions.py`` (which
imports no JAX), so that the port imports nothing of the JAX package.

Analog of the reference's AIR layer
(reference: tachyon/zk/air/constraint_system/constraint_system.h,
zk/air/expressions/air_evaluator.h).  Constraints reference the main trace
at the local and next row (`Main(col, next=True)`), row-position selectors
(`First`, `Last`, `Transition`), and public values (`Pub`).  The reference
interprets the AST row-by-row; here evaluation is whole-column vectorized
over the quotient coset (prover) or host-exact at a single extension point
(verifier) — see zk/air/stark.py.
"""
from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class Constant:
    value: int


@dataclasses.dataclass(frozen=True)
class Main:
    column: int
    next: bool = False


@dataclasses.dataclass(frozen=True)
class Pub:
    index: int


@dataclasses.dataclass(frozen=True)
class First:
    """unnormalized-free L_0(x) selector (exact first-row Lagrange basis)."""


@dataclasses.dataclass(frozen=True)
class Last:
    """L_{n-1}(x) selector."""


@dataclasses.dataclass(frozen=True)
class Transition:
    """(x - w^{n-1}): vanishes on the last row only."""


@dataclasses.dataclass(frozen=True)
class Negated:
    expr: "Expr"


@dataclasses.dataclass(frozen=True)
class Sum:
    left: "Expr"
    right: "Expr"


@dataclasses.dataclass(frozen=True)
class Product:
    left: "Expr"
    right: "Expr"


Expr = Union[Constant, Main, Pub, First, Last, Transition, Negated, Sum, Product]


def degree(e: Expr) -> int:
    """degree in x, counting trace columns and selectors as polynomials:
    Main -> 1; First/Last -> n-ish (count 1 relative unit: callers use
    multiples-of-n accounting separately); here selectors count 1."""
    if isinstance(e, (Constant, Pub)):
        return 0
    if isinstance(e, (Main, First, Last, Transition)):
        return 1
    if isinstance(e, Negated):
        return degree(e.expr)
    if isinstance(e, Sum):
        return max(degree(e.left), degree(e.right))
    if isinstance(e, Product):
        return degree(e.left) + degree(e.right)
    raise TypeError(e)


class AirBuilder:
    """Collects constraints; mirrors plonky3's AirBuilder surface."""

    def __init__(self, width: int, num_public: int = 0):
        self.width = width
        self.num_public = num_public
        self.constraints: list[Expr] = []

    # row refs
    def local(self, col: int) -> Main:
        return Main(col, next=False)

    def next(self, col: int) -> Main:
        return Main(col, next=True)

    def public(self, i: int) -> Pub:
        return Pub(i)

    # constraint registration
    def assert_zero(self, e: Expr):
        self.constraints.append(e)

    def assert_eq(self, a: Expr, b: Expr):
        self.constraints.append(Sum(a, Negated(b)))

    def assert_zero_first(self, e: Expr):
        self.constraints.append(Product(First(), e))

    def assert_zero_last(self, e: Expr):
        self.constraints.append(Product(Last(), e))

    def assert_zero_transition(self, e: Expr):
        self.constraints.append(Product(Transition(), e))
