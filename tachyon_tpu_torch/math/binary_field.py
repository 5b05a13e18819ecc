"""Binary tower fields GF(2^k), k = 1..128 (the Binius / Ulvetanna tower).

Port of ``tachyon_tpu/math/binary_field.py`` (reference: tachyon/math/
finite_fields/binary_fields/binary_field.h, binary_tower_operations.h).
The Wiedemann tower: each level doubles the width by
F_{2k} = F_k[X]/(X^2 + alpha_k X + 1), alpha the previous level's
generator, so with Karatsuba

    (a0 + a1 X)(b0 + b1 X) = (z0 + z1) + (z2 + alpha z1) X,
    z0 = a0 b0,  z1 = a1 b1,  z2 = (a0 + a1)(b0 + b1) + z0 + z1.

The recursion bottoms out at the 1-bit AND; every level is bit operations
inside 32-bit lanes (k <= 32) or across a leading word axis of k/32 words,
little-endian (k = 64, 128).  Words are ``int32``, bit for bit the JAX
package's ``uint32`` words: ``>>`` on ``int32`` is arithmetic where the
``uint32`` shift is logical, so every right shift is masked to the bits it
keeps.  The JAX package has no Pallas kernel here (its tower is one fused
XLA elementwise graph); on the card these are PyTorch bitwise ops.
"""
from __future__ import annotations

import numpy as np
import torch


def _mask(k: int) -> int:
    """The low k bits (k <= 16: half of a lane, so a positive int32)."""
    return (1 << k) - 1


def _split(a, k: int):
    """The halves of width-k elements: within lanes for k <= 32, else the
    word axis."""
    h = k // 2
    if k <= 32:
        return a & _mask(h), (a >> h) & _mask(h)
    wh = max(h // 32, 1)  # words per half
    return a[:wh], a[wh:]


def _join(lo, hi, k: int):
    h = k // 2
    if k <= 32:
        return lo | (hi << h)
    return torch.cat([lo, hi], dim=0)


def _mul(a, b, k: int):
    if k == 1:
        return a & b
    h = k // 2
    a0, a1 = _split(a, k)
    b0, b1 = _split(b, k)
    z0 = _mul(a0, b0, h)
    z1 = _mul(a1, b1, h)
    z2 = _mul(a0 ^ a1, b0 ^ b1, h) ^ z0 ^ z1
    return _join(z0 ^ z1, z2 ^ _mul_alpha(z1, h), k)


def _mul_alpha(x, k: int):
    """Multiply by this level's generator X (binary_tower_operations.h
    MulByAlpha); alpha at 1 bit is the identity."""
    if k == 1:
        return x
    h = k // 2
    x0, x1 = _split(x, k)
    return _join(x1, x0 ^ _mul_alpha(x1, h), k)


def _square(x, k: int):
    if k == 1:
        return x
    h = k // 2
    x0, x1 = _split(x, k)
    z0 = _square(x0, h)
    z1 = _square(x1, h)
    return _join(z0 ^ z1, _mul_alpha(z1, h), k)


def _inv(x, k: int):
    if k == 1:
        return x  # 1^-1 = 1; 0 stays 0
    h = k // 2
    x0, x1 = _split(x, k)
    x0x1a = x0 ^ _mul_alpha(x1, h)
    delta = _mul(x0, x0x1a, h) ^ _square(x1, h)
    dinv = _inv(delta, h)
    return _join(_mul(dinv, x0x1a, h), _mul(dinv, x1, h), k)


class BinaryField:
    """GF(2^k) on one device (the card unless the caller passes another; on
    a host without CUDA the default raises).  Elements: int32 tensors of
    any shape for k <= 32, with a leading axis of k/32 words for 64 and 128."""

    def __init__(self, bits: int, device=torch.device("cuda")):
        if bits not in (1, 2, 4, 8, 16, 32, 64, 128):
            raise ValueError(f"GF(2^{bits}) is not a level of the tower")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"GF(2^{bits}): no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self.k = bits
        self.words = max(bits // 32, 1)

    def __repr__(self):
        return f"BinaryField(2^{self.k}, {self.device})"

    # --- construction -----------------------------------------------------
    def _shape(self, shape) -> tuple:
        s = (shape,) if isinstance(shape, int) else tuple(shape)
        return ((self.words,) + s) if self.k > 32 else s

    def _batch(self, a) -> tuple:
        return tuple(a.shape[1:]) if self.k > 32 else tuple(a.shape)

    def zeros(self, shape=()):
        return torch.zeros(self._shape(shape), dtype=torch.int32, device=self.device)

    def ones(self, shape=()):
        out = self.zeros(shape)
        out[0 if self.k > 32 else ...] = 1
        return out

    def encode(self, xs) -> torch.Tensor:
        """Python ints -> words (the JAX layout, as int32)."""
        arr = np.asarray(xs, dtype=object)
        flat = arr.reshape(-1)
        if self.k <= 32:
            out = (flat & ((1 << self.k) - 1)).astype(np.int64).astype(np.uint32)
        else:
            out = np.stack([((flat >> (32 * i)) & 0xFFFFFFFF).astype(np.int64)
                            for i in range(self.words)], axis=0).astype(np.uint32)
        out = out.reshape(self._shape(arr.shape))
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int32)).to(self.device)

    def decode(self, a) -> np.ndarray:
        arr = a.detach().cpu().contiguous().numpy().view(np.uint32)
        if self.k <= 32:
            return arr.astype(object)
        out = np.zeros(arr.shape[1:], dtype=object)
        for i in range(self.words):
            out |= arr[i].astype(object) << (32 * i)
        return out

    def random(self, shape=(), rng=None):
        """Uniform elements, drawn as the JAX package draws them (one
        ``rng.integers(0, 2^32)`` a word), so one generator gives both the
        same values."""
        rng = rng or np.random.default_rng()
        s = (shape,) if isinstance(shape, int) else tuple(shape)
        n = int(np.prod(s)) if s else 1
        vals = np.empty((n,), dtype=object)
        for i in range(n):
            v = 0
            for w in range(self.words):
                v |= int(rng.integers(0, 1 << 32)) << (32 * w)
            vals[i] = v & ((1 << self.k) - 1)
        return self.encode(vals.reshape(s) if s else vals[0])

    # --- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return a ^ b

    sub = add

    def neg(self, a):
        return a

    def mul(self, a, b):
        return _mul(a, b, self.k)

    def square(self, a):
        return _square(a, self.k)

    def mul_by_alpha(self, a):
        return _mul_alpha(a, self.k)

    def inv(self, a):
        """The inverse; 0 maps to 0."""
        return _inv(a, self.k)

    def is_zero(self, a):
        if self.k <= 32:
            return a == 0
        return (a == 0).all(dim=0)

    def pow_const(self, a, e: int):
        r = self.ones(self._batch(a))
        base = a
        while e:
            if e & 1:
                r = self.mul(r, base)
            e >>= 1
            if e:
                base = self.square(base)
        return r


def binary_field(bits: int, device=torch.device("cuda")) -> BinaryField:
    return BinaryField(bits, device)
