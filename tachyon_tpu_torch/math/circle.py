"""The unit circle group x^2 + y^2 = 1 over Mersenne-31 (Circle-STARK).

Port of ``tachyon_tpu/math/circle.py`` (reference: tachyon/math/circle/
circle.h, circle/affine_point.h, circle/m31/BUILD.bazel: M31's G1 with
generator (2, 1268011823), scalar group Z/2^31).  The group law is the
composition of rotations, (x1, y1) + (x2, y2) = (x1 x2 - y1 y2,
x1 y2 + y1 x2), identity (1, 0).  Coordinates are (1, *batch) Montgomery
words of M31, so every multiply is K1 at W = 1 on the card; every op is
vectorized over the batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math.field import PrimeField


class CirclePoint(NamedTuple):
    x: torch.Tensor  # (W, *batch)
    y: torch.Tensor


class CircleGroup:
    ORDER = 1 << 31  # the order of the M31 circle group: p + 1
    GEN = (2, 1268011823)

    def __init__(self, F: PrimeField):
        self.F = F

    def _one(self, like: torch.Tensor) -> torch.Tensor:
        """mont(1) shaped to broadcast against a coordinate."""
        return self.F.ones(()).reshape((-1,) + (1,) * (like.ndim - 1))

    def identity(self, shape=()) -> CirclePoint:
        return CirclePoint(self.F.ones(shape), self.F.zeros(shape))

    def generator(self, shape=()) -> CirclePoint:
        return CirclePoint(self.F.full(shape, self.GEN[0]), self.F.full(shape, self.GEN[1]))

    def encode(self, pts) -> CirclePoint:
        """pts: a sequence of (x, y) int pairs."""
        xs = np.array([p[0] for p in pts], dtype=object)
        ys = np.array([p[1] for p in pts], dtype=object)
        return CirclePoint(self.F.encode(xs), self.F.encode(ys))

    def decode(self, p: CirclePoint):
        return self.F.decode(p.x), self.F.decode(p.y)

    def is_on_circle(self, p: CirclePoint) -> torch.Tensor:
        F = self.F
        return F.eq(F.add(F.square(p.x), F.square(p.y)), self._one(p.x))

    def add(self, a: CirclePoint, b: CirclePoint) -> CirclePoint:
        F = self.F
        # the four products in one multiply: x1 x2, y1 y2, x1 y2, y1 x2
        a_x, a_y, b_x, b_y = torch.broadcast_tensors(a.x, a.y, b.x, b.y)
        xx, yy, xy, yx = F.mul(torch.stack([a_x, a_y, a_x, a_y], dim=1),
                               torch.stack([b_x, b_y, b_y, b_x], dim=1)).unbind(1)
        return CirclePoint(F.sub(xx, yy), F.add(xy, yx))

    def double(self, a: CirclePoint) -> CirclePoint:
        """(2 x^2 - 1, 2 x y)"""
        F = self.F
        xx, xy = F.mul(torch.stack([a.x, a.x], dim=1), torch.stack([a.x, a.y], dim=1)).unbind(1)
        return CirclePoint(F.sub(F.double(xx), self._one(a.x)), F.double(xy))

    def neg(self, a: CirclePoint) -> CirclePoint:
        """The conjugate: the inverse rotation."""
        return CirclePoint(a.x, self.F.neg(a.y))

    def antipode(self, a: CirclePoint) -> CirclePoint:
        return CirclePoint(self.F.neg(a.x), self.F.neg(a.y))

    def scalar_mul(self, a: CirclePoint, k: int) -> CirclePoint:
        """k a for a host int k, LSB first: a double a bit, an add a set bit."""
        k %= self.ORDER
        acc = None
        add = a
        while k:
            if k & 1:
                acc = add if acc is None else self.add(acc, add)
            k >>= 1
            if k:
                add = self.double(add)
        return acc if acc is not None else self.identity(tuple(a.x.shape[1:]))

    def subgroup_generator(self, log_size: int) -> tuple:
        """The generator of the order-2^log_size subgroup, as host ints."""
        p = self.F.p
        x, y = self.GEN
        for _ in range(31 - log_size):
            x, y = (2 * x * x - 1) % p, (2 * x * y) % p
        return (x, y)


def m31_circle(device=torch.device("cuda")) -> CircleGroup:
    """The circle over Mersenne-31 on the card unless the caller passes
    another device; on a host without CUDA the default raises."""
    return CircleGroup(PrimeField(presets.MERSENNE31, device))
