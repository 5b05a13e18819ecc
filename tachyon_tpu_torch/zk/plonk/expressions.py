"""PLONK expression AST + vectorized evaluator.

Port of ``tachyon_tpu/zk/plonk/expressions.py``: the node classes and
``degree`` are copied; ``Evaluator`` runs over the port's ``(W, n)``
Montgomery word columns, every node a whole-column field op (K1 for a
product on the card, the port's add and sub), and a rotation is
``torch.roll`` along the row axis where the JAX package takes ``jnp.roll``.

Analog of the reference's expression layer
(reference: tachyon/zk/expressions/expression.h, zk/plonk/vanishing/
graph_evaluator.h).  The reference compiles the gate AST into a register
machine evaluated row-by-row with OpenMP; here evaluation is vectorized
over whole columns.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch


@dataclasses.dataclass(frozen=True)
class Constant:
    value: int


@dataclasses.dataclass(frozen=True)
class Fixed:
    column: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class Advice:
    column: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class Instance:
    column: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class Challenge:
    index: int
    phase: int = 0


@dataclasses.dataclass(frozen=True)
class Selector:
    """Virtual selector reference (halo2 Expression::Selector; reference:
    tachyon/zk/expressions/expression.h kSelector).  Only valid before
    selector compression (keygen replaces every Selector with a fixed-column
    interpolation expression); evaluating one raises."""
    index: int
    is_simple: bool = True


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


@dataclasses.dataclass(frozen=True)
class Scaled:
    expr: "Expr"
    scale: int


Expr = Union[Constant, Fixed, Advice, Instance, Challenge, Selector, Negated,
             Sum, Product, Scaled]


def degree(e: Expr) -> int:
    """polynomial degree in the trace columns (reference: expression.h Degree)."""
    if isinstance(e, (Constant, Challenge)):
        return 0
    if isinstance(e, (Fixed, Advice, Instance, Selector)):
        return 1
    if isinstance(e, Negated):
        return degree(e.expr)
    if isinstance(e, Scaled):
        return degree(e.expr)
    if isinstance(e, Sum):
        return max(degree(e.left), degree(e.right))
    if isinstance(e, Product):
        return degree(e.left) + degree(e.right)
    raise TypeError(e)


class Evaluator:
    """Evaluates expressions over column tables.

    tables: lists of (W, n) word tensors (evaluation form over some domain);
    `rot_scale` maps rotation units to row offsets (extended-domain evals use
    rot_scale = blowup factor, as in the reference's CircuitPolynomialBuilder).
    """

    def __init__(self, F, fixed, advice, instance, challenges=None, rot_scale=1):
        self.F = F
        self.fixed = fixed
        self.advice = advice
        self.instance = instance
        self.challenges = challenges or {}
        self.rot_scale = rot_scale

    def _rot(self, col: torch.Tensor, rotation: int) -> torch.Tensor:
        if rotation == 0:
            return col
        return torch.roll(col, -rotation * self.rot_scale, dims=1)

    def _n(self) -> int:
        return (self.fixed or self.advice or self.instance)[0].shape[1]

    def eval(self, e: Expr) -> torch.Tensor:
        F = self.F
        if isinstance(e, Constant):
            return F.full((self._n(),), e.value)
        if isinstance(e, Fixed):
            return self._rot(self.fixed[e.column], e.rotation)
        if isinstance(e, Advice):
            return self._rot(self.advice[e.column], e.rotation)
        if isinstance(e, Instance):
            return self._rot(self.instance[e.column], e.rotation)
        if isinstance(e, Challenge):
            return F.full((self._n(),), self.challenges[e.index])
        if isinstance(e, Negated):
            return F.neg(self.eval(e.expr))
        if isinstance(e, Sum):
            return F.add(self.eval(e.left), self.eval(e.right))
        if isinstance(e, Product):
            return F.mul(self.eval(e.left), self.eval(e.right))
        if isinstance(e, Scaled):
            # the scale as a (W, 1) column, broadcast along the rows
            return F.mul(self.eval(e.expr), F.full((), e.scale)[:, None])
        raise TypeError(e)
