"""Element representation of the port, and conversion to and from the JAX one.

The JAX package stores a field element as ``L`` 16-bit limbs in uint32
slots, limb axis leading: ``(L, *batch)``.  The port stores ``W = L / 2``
32-bit words, word axis leading: ``(W, *batch)`` ``torch.int32`` tensors
whose bits are the uint32 word (words >= 2^31 read as negative).  PyTorch's
CPU ``uint32`` has no add, shift, compare, ``index_select`` or
``searchsorted``, so int32 is the storage type; arithmetic widens to int64.

The Montgomery radix is the same in both, R = 2^(16 L) = 2^(32 W), so a
Montgomery value is the same integer and conversion is a repack:
word j = limb 2j | limb (2j+1) << 16.
"""
from __future__ import annotations

import numpy as np
import torch

from tachyon_tpu_torch.fields.spec import FieldSpec

WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1


def word_count(f: FieldSpec) -> int:
    """W = L / 2 words of 32 bits (every preset has an even limb count)."""
    if f.L % 2:
        raise ValueError(f"{f.name}: odd limb count {f.L} has no 32-bit word form")
    return f.L // 2


def n0inv32(f: FieldSpec) -> int:
    """-p^{-1} mod 2^32, the constant of 32-bit CIOS rounds
    (``spec.n0inv`` is the mod 2^16 one of the 16-bit limb rounds)."""
    return (-pow(f.p, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)


def int_to_words(x: int, W: int) -> np.ndarray:
    """Python int -> (W,) uint32 little-endian words."""
    if not 0 <= x < (1 << (WORD_BITS * W)):
        raise ValueError(f"{x} does not fit {W} words")
    return np.array([(x >> (WORD_BITS * i)) & WORD_MASK for i in range(W)],
                    dtype=np.uint32)


def from_jax_limbs(a, device=None, axis: int = 0) -> torch.Tensor:
    """(L, *b) uint32 16-bit limbs -> (L/2, *b) int32 words; the limb axis
    is ``axis`` (1 for an extension element (D, L, *b) -> (D, L/2, *b))."""
    a = np.moveaxis(np.asarray(a, dtype=np.uint32), axis, 0)
    if a.shape[0] % 2:
        raise ValueError(f"limb axis of length {a.shape[0]} is not even")
    words = np.moveaxis(a[0::2] | (a[1::2] << np.uint32(16)), 0, axis)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


def to_jax_limbs(t: torch.Tensor, axis: int = 0) -> np.ndarray:
    """(W, *b) int32 words -> (2W, *b) uint32 16-bit limbs; the word axis
    is ``axis``."""
    w = np.moveaxis(t.detach().cpu().contiguous().numpy().view(np.uint32), axis, 0)
    out = np.empty((2 * w.shape[0],) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def affine_from_jax(p, device=None):
    """JAX (x, y, inf) -> port AffinePoint (words, bool inf)."""
    from tachyon_tpu_torch.math.ec import AffinePoint

    x, y, inf = p
    return AffinePoint(from_jax_limbs(x, device), from_jax_limbs(y, device),
                       torch.from_numpy(np.asarray(inf, dtype=bool)).to(device))


def affine_to_jax(p) -> tuple:
    return (to_jax_limbs(p.x), to_jax_limbs(p.y), p.inf.cpu().numpy())


def xyzz_from_jax(p, device=None):
    """JAX (x, y, zz, zzz) -> port PointXYZZ of int32 words."""
    from tachyon_tpu_torch.math.ec import PointXYZZ

    return PointXYZZ(*(from_jax_limbs(t, device) for t in p))


def xyzz_to_jax(p) -> tuple:
    return tuple(to_jax_limbs(t) for t in p)


def ints_to_words(xs, W: int) -> np.ndarray:
    """Python ints in [0, 2^(32 W)) -> (W, n) uint32 words, in one step:
    the ints' little-endian bytes joined and read by ``np.frombuffer``."""
    buf = b"".join(int(x).to_bytes(4 * W, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, W).T.copy()


def from_ints(xs, W: int, device=None) -> torch.Tensor:
    """Python ints in [0, 2^(32 W)) -> (W, n) int32 plain words."""
    return torch.from_numpy(ints_to_words(xs, W).view(np.int32)).to(device)


def words_to_ints(w: np.ndarray) -> list:
    """(W, n) uint32 words -> n Python ints."""
    W = w.shape[0]
    buf = np.ascontiguousarray(w.T, dtype="<u4").tobytes()
    return [int.from_bytes(buf[i:i + 4 * W], "little") for i in range(0, len(buf), 4 * W)]


def encode(f: FieldSpec, xs, device=None) -> torch.Tensor:
    """Python ints -> Montgomery words (W, *shape), equal to the words of
    ``f.encode`` (x mod p times R mod p), vectorised over the ints."""
    arr = np.asarray(xs, dtype=object)
    W = word_count(f)
    mont = [int(x) % f.p * f.R % f.p for x in arr.reshape(-1)]
    return from_ints(mont, W, device).reshape((W,) + arr.shape)


def decode(f: FieldSpec, t: torch.Tensor) -> np.ndarray:
    """Montgomery words -> object ndarray of Python ints."""
    w = t.detach().cpu().contiguous().numpy().view(np.uint32)
    r_inv = pow(f.R, -1, f.p)
    vals = [v * r_inv % f.p for v in words_to_ints(w.reshape(w.shape[0], -1))]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out.reshape(w.shape[1:])

