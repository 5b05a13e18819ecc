"""PrimeField: the array API over the port's Montgomery word ops.

Port of ``tachyon_tpu/math/field.py``.  A value is a ``(W, *batch)`` int32
word tensor in Montgomery form; the field holds its constants on one
explicit ``device``, and every method is vectorized over the batch axes.
"""
from __future__ import annotations

import numpy as np
import torch

from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.ops import mont


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


class PrimeField:
    """A prime field on one device: the card unless the caller passes
    another; on a host without CUDA the default raises."""

    coeff_ndim = 1  # an element's structure axes: the words

    def __init__(self, spec: FieldSpec, device=torch.device("cuda")):
        self.spec = spec
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{spec.name}: no CUDA device; pass device='cpu' "
                               "to run the plain PyTorch path on the CPU")

    @property
    def W(self) -> int:
        return limbs.word_count(self.spec)

    @property
    def L(self) -> int:
        return self.spec.L

    @property
    def p(self) -> int:
        return self.spec.p

    @property
    def name(self) -> str:
        return self.spec.name

    def __repr__(self):
        return f"PrimeField({self.spec.name}, {self.device})"

    # --- construction -----------------------------------------------------
    def zeros(self, shape=()):
        return mont.zeros(self.spec, _shape(shape), self.device)

    def ones(self, shape=()):
        return mont.ones(self.spec, _shape(shape), self.device)

    def full(self, shape, value: int):
        s = _shape(shape)
        v = self.encode(value % self.p)
        return v.reshape((self.W,) + (1,) * len(s)).expand(self.W, *s).contiguous()

    def powers(self, base: int, count: int):
        """(W, count) table of base^i for i < count, by log-doubling: each
        step appends the table times the next square of base."""
        tab = self.ones((1,))
        cur = self.encode(base % self.p)[:, None]
        while tab.shape[-1] < count:
            tab = torch.cat([tab, self.mul(tab, cur)], dim=-1)
            cur = self.square(cur)
        return tab[:, :count].contiguous()

    def encode(self, xs):
        """host Python ints -> Montgomery words (W, *shape) on the device."""
        return limbs.encode(self.spec, np.asarray(xs, dtype=object), self.device)

    def decode(self, words):
        """Montgomery words -> numpy object array of Python ints."""
        return limbs.decode(self.spec, words)

    def random(self, shape=(), rng: np.random.Generator | None = None):
        """Uniform random elements, drawn on the host as the JAX package
        draws them (each an integer of bits/8 + 8 bytes from ``rng.bytes``,
        reduced mod p), so one generator gives both the same values."""
        s = _shape(shape)
        rng = rng or np.random.default_rng()
        nbytes = (self.spec.bits + 7) // 8 + 8
        n = int(np.prod(s)) if s else 1
        vals = np.empty((n,), dtype=object)
        vals[:] = [int.from_bytes(rng.bytes(nbytes), "little") % self.p for _ in range(n)]
        return self.encode(vals.reshape(s) if s else vals[0])

    def root_of_unity(self, order: int):
        """A primitive ``order``-th root of unity (order a power of two) as
        Montgomery words (W,)."""
        return self.encode(self.spec.root_of_unity(order))

    @property
    def two_adicity(self) -> int:
        return self.spec.two_adicity

    def encode_canonical(self, xs: torch.Tensor):
        """Canonical values (an integer tensor of any shape, each in [0, p))
        -> Montgomery words (1, *shape) on the field's device, through K1
        with R^2 mod p: the device encode of a one-word field, where
        ``encode`` would reduce Python ints one by one on the host."""
        if self.W != 1:
            raise ValueError(f"{self.name}: encode_canonical takes one-word fields")
        return mont.to_mont(self.spec, xs.to(self.device, torch.int32)[None])

    def to_canonical(self, words):
        """Montgomery words (1, *shape) of a one-word field -> canonical
        int32 values (*shape) on the device (K1 with the integer 1)."""
        if self.W != 1:
            raise ValueError(f"{self.name}: to_canonical takes one-word fields")
        return mont.mont_reduce(self.spec, words)[0]

    # --- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return mont.add(self.spec, a, b)

    def sub(self, a, b):
        return mont.sub(self.spec, a, b)

    def neg(self, a):
        return mont.neg(self.spec, a)

    def mul(self, a, b):
        return mont.mul(self.spec, a, b)

    def square(self, a):
        return mont.square(self.spec, a)

    def double(self, a):
        return mont.double(self.spec, a)

    def mul_small(self, a, k: int):
        return mont.mul_small(self.spec, a, k)

    def pow_const(self, a, e: int):
        return mont.pow_const(self.spec, a, e)

    def inv(self, a):
        return mont.inv(self.spec, a)

    def batch_inverse(self, a, axis=-1):
        return mont.batch_inverse(self.spec, a, axis=axis)

    def sum(self, a, dim=-1):
        """The field sum over a batch axis."""
        return mont.sum_axis(self.spec, a, dim)

    def is_zero(self, a):
        return mont.is_zero(self.spec, a)

    def eq(self, a, b):
        return mont.eq(self.spec, a, b)

    def select(self, mask, a, b):
        return mont.select(mask, a, b)
