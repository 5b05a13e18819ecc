"""Field specification: all per-field constants derived from the modulus.

The port's own copy of ``tachyon_tpu/fields/spec.py``, so that the port
imports nothing of the JAX package.  ``FieldSpec`` stays the frozen,
hashable dataclass it is there: the port keys ``lru_cache``s on it
(``ops/mont._consts``, the kernels' ``consts_ptr``).  The text below is
the original's; "limbs" are the JAX package's 16-bit limbs, which the
port repacks into 32-bit words (``fields/limbs.py``).

This is the TPU-native equivalent of the reference's build-time field codegen
(reference: tachyon/math/finite_fields/generator/prime_field_generator/
prime_field_generator.cc and build_defs.bzl). Instead of emitting C++ headers,
we compute the Montgomery / FFT constants once at import time with exact
Python integers and expose them as numpy uint32 limb arrays.

Representation convention (everywhere in this framework):
  * A field element is an array of ``L`` limbs of 16 bits each, stored in
    uint32 slots, **little-endian**, with the limb axis LEADING:
    shape ``(L, *batch)``.  The trailing axes are the element batch, which
    XLA lays out on the 8x128 vector registers -- one limb op is a full-rate
    VPU op over 1024 elements.
  * Elements are kept in Montgomery form (R = 2**(16*L)) except where noted.

16-bit limbs are used because the TPU VPU has a 32-bit integer multiplier
but no widening 32x32->64 multiply; 16x16->32 products are exact in uint32.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def limb_count(p: int) -> int:
    """Number of 16-bit limbs for modulus p (multiple of 2 for sublane ease)."""
    bits = p.bit_length()
    L = (bits + LIMB_BITS - 1) // LIMB_BITS
    return max(L, 1)


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Python int -> (L,) uint32 little-endian 16-bit limb array."""
    assert 0 <= x < (1 << (LIMB_BITS * L)), (x, L)
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)], dtype=np.uint32
    )


def limbs_to_int(a) -> int:
    """(L,) limb array -> Python int."""
    a = np.asarray(a)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a.reshape(-1)))


def _two_adicity(n: int) -> tuple[int, int]:
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s, n


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """All static constants for a prime field.

    Hashable / frozen so it can be closed over by jitted functions.
    """

    name: str
    p: int
    generator: int  # multiplicative group generator (matches reference flags)
    # optional mixed-radix small subgroup (reference: small_subgroup_base/adicity)
    small_subgroup_base: int = 0
    small_subgroup_adicity: int = 0

    def __post_init__(self):
        assert self.p % 2 == 1 and self.p > 2, "modulus must be an odd prime"

    # ---- scalar integer constants -------------------------------------
    @functools.cached_property
    def L(self) -> int:
        return limb_count(self.p)

    @functools.cached_property
    def bits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.L)

    @functools.cached_property
    def R_mod_p(self) -> int:
        return self.R % self.p

    @functools.cached_property
    def R2_mod_p(self) -> int:
        return (self.R * self.R) % self.p

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^16 (Montgomery constant for 16-bit digit rounds)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def two_adicity(self) -> int:
        return _two_adicity(self.p - 1)[0]

    @functools.cached_property
    def trace(self) -> int:
        """(p-1) / 2^two_adicity."""
        return _two_adicity(self.p - 1)[1]

    @functools.cached_property
    def two_adic_root(self) -> int:
        """Canonical 2^two_adicity-th root of unity: g^trace (non-Montgomery)."""
        return pow(self.generator, self.trace, self.p)

    def root_of_unity(self, order: int) -> int:
        """Primitive ``order``-th root of unity (order = 2^k, non-Montgomery)."""
        assert order & (order - 1) == 0, "order must be a power of two"
        k = order.bit_length() - 1
        assert k <= self.two_adicity, (k, self.two_adicity)
        return pow(self.two_adic_root, 1 << (self.two_adicity - k), self.p)

    # ---- numpy limb constants ------------------------------------------
    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.p, self.L)

    @functools.cached_property
    def r_limbs(self) -> np.ndarray:
        """R mod p = Montgomery form of 1."""
        return int_to_limbs(self.R_mod_p, self.L)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R2_mod_p, self.L)

    @functools.cached_property
    def zero_limbs(self) -> np.ndarray:
        return np.zeros((self.L,), dtype=np.uint32)

    # ---- host-side conversions ------------------------------------------
    def to_mont_int(self, x: int) -> int:
        return (x * self.R) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * pow(self.R, -1, self.p)) % self.p

    def encode(self, xs) -> np.ndarray:
        """Python ints (array-like of object/int) -> Montgomery limb array.

        Returns uint32 array of shape (L, *np.shape(xs)).
        """
        arr = np.asarray(xs, dtype=object)
        flat = arr.reshape(-1)
        out = np.empty((self.L, flat.size), dtype=np.uint32)
        for j, v in enumerate(flat):
            out[:, j] = int_to_limbs(self.to_mont_int(int(v) % self.p), self.L)
        return out.reshape((self.L,) + arr.shape)

    def decode(self, limbs) -> np.ndarray:
        """Montgomery limb array (L, *shape) -> object ndarray of Python ints."""
        a = np.asarray(limbs)
        assert a.shape[0] == self.L, (a.shape, self.L)
        flat = a.reshape(self.L, -1)
        out = np.empty((flat.shape[1],), dtype=object)
        for j in range(flat.shape[1]):
            out[j] = self.from_mont_int(limbs_to_int(flat[:, j]))
        return out.reshape(a.shape[1:])
