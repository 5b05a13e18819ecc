"""Multi-word Montgomery arithmetic over (W, *batch) int32 word tensors.

Port of ``tachyon_tpu/ops/mont.py``.  Same contract: every op is
elementwise over the batch axes, the word axis leads, and values are
canonical (< p) Montgomery residues with R = 2^(32 W), which is the JAX
package's R = 2^(16 L).  ``is_zero`` and the point formulas' case selects
rely on canonical values, so every op here returns values < p.

``mul`` launches the hand-written CUDA kernel (``ops/cuda_mont.py``) for
CUDA tensors and its plain PyTorch twin for CPU tensors.  The other ops are
short plain tensor programs on both devices: they are XLA glue in the JAX
package too, not Pallas kernels.

Plain arithmetic widens the uint32 words to int64 (masking off the int32
sign extension), ripples carries word by word, and narrows back.  At one
word (W = 1, p < 2^31) add, sub and neg stay in int32: a difference in
(-p, p), plus p where it is negative (its sign bit, shifted out and masked
with p), which is the same canonical word in three or four tensor ops.
``sum_axis`` reduces an axis: at W = 1 one int64 sum and one remainder (exact
for fewer than 2^32 terms), a tree of field adds otherwise.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.fields.limbs import WORD_BITS, WORD_MASK, int_to_words, word_count


@functools.lru_cache(maxsize=None)
def _consts(f: FieldSpec, device: torch.device) -> dict:
    """Field constants as tensors on one device."""
    W = word_count(f)

    def words(v):
        return torch.from_numpy(int_to_words(v, W).astype("int64")).to(device)

    return {
        "p": words(f.p),                     # (W,) int64
        "one": narrow(words(f.R_mod_p)),     # mont(1), (W,) int32
        "r2": narrow(words(f.R2_mod_p)),     # mont(R), (W,) int32
        "plain_one": narrow(words(1)),       # the integer 1, (W,) int32
    }


def widen(a: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32)."""
    return a.to(torch.int64) & WORD_MASK


def narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(W,) constant -> (W, 1, ..., 1) for broadcasting over ndim-1 batch axes."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def ripple(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lazy non-negative int64 word columns -> (normalized words, carry out)."""
    out = []
    c = torch.zeros_like(cols[0])
    for j in range(cols.shape[0]):
        t = cols[j] + c
        out.append(t & WORD_MASK)
        c = t >> WORD_BITS
    return torch.stack(out), c


def _borrow_ripple(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Word differences in (-2^32, 2^32) -> (normalized words, borrow out 0/1)."""
    out = []
    borrow = torch.zeros_like(d[0])
    for j in range(d.shape[0]):
        t = d[j] - borrow
        out.append(t & WORD_MASK)
        borrow = -(t >> WORD_BITS)  # t >= -2^32, so the shift is 0 or -1
    return torch.stack(out), borrow


def csub_p(f: FieldSpec, w: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """Value (extra << 32W) + w < 2p, with w normalized int64 words ->
    canonical int32 words (subtract p once where the value is >= p)."""
    diff, borrow = _borrow_ripple(w - _col(_consts(f, w.device)["p"], w.ndim))
    keep = (extra - borrow) < 0  # borrowed out of the top: value < p
    return narrow(torch.where(keep[None], w, diff))


# ----------------------------------------------------------------------------
# public ops: all take/return (W, *batch) int32 words in Montgomery form
# ----------------------------------------------------------------------------

def zeros(f: FieldSpec, batch_shape: Sequence[int],
          device=torch.device("cuda")) -> torch.Tensor:
    return torch.zeros((word_count(f), *batch_shape), dtype=torch.int32, device=device)


def ones(f: FieldSpec, batch_shape: Sequence[int],
         device=torch.device("cuda")) -> torch.Tensor:
    one = _consts(f, torch.device(device))["one"]
    return _col(one, 1 + len(batch_shape)).expand(-1, *batch_shape).contiguous()


def _wrap_p(f: FieldSpec, d: torch.Tensor) -> torch.Tensor:
    """int32 values in (-p, p) -> canonical (add p where negative), W = 1."""
    return d + ((d >> 31) & f.p)


def add(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if f.L == 2:
        return _wrap_p(f, (a - f.p) + b)
    a, b = torch.broadcast_tensors(a, b)
    w, c = ripple(widen(a) + widen(b))
    return csub_p(f, w, c)


def sub(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if f.L == 2:
        return _wrap_p(f, a - b)
    a, b = torch.broadcast_tensors(a, b)
    d, borrow = _borrow_ripple(widen(a) - widen(b))
    # borrow == 1: a < b, add p back (the carry out of that add is dropped)
    p = _col(_consts(f, a.device)["p"], a.ndim)
    res, _ = ripple(d + borrow[None] * p)
    return narrow(res)


def neg(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    if f.L == 2:
        return _wrap_p(f, -a)
    return sub(f, torch.zeros_like(a), a)


def sum_axis(f: FieldSpec, a: torch.Tensor, dim: int) -> torch.Tensor:
    """The field sum over batch axis ``dim`` (not the word axis 0)."""
    if dim < 0:
        dim += a.ndim
    if dim == 0:
        raise ValueError("axis 0 is the word axis")
    if f.L == 2:
        if a.shape[dim] >= 1 << 32:
            raise ValueError("the int64 sum is exact for fewer than 2^32 terms")
        return torch.remainder(torch.sum(a, dim, dtype=torch.int64), f.p).to(torch.int32)
    while a.shape[dim] > 1:
        m = a.shape[dim]
        lo, hi = a.narrow(dim, 0, m // 2), a.narrow(dim, m // 2, m // 2)
        s = add(f, lo, hi)
        a = torch.cat([s, a.narrow(dim, m - 1, 1)], dim) if m % 2 else s
    return a.squeeze(dim) if a.shape[dim] == 1 else zeros(f, a.shape[1:dim] + a.shape[dim + 1:],
                                                          a.device)


def double(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(f, a, a)


def mul(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: mont(a) * mont(b) -> mont(a*b).

    CUDA tensors go to the hand-written kernel, CPU tensors to its plain
    PyTorch twin (both in ops/cuda_mont.py)."""
    from tachyon_tpu_torch.ops import cuda_mont

    return cuda_mont.mul(f, a, b)


def square(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mul(f, a, a)


def mont_reduce(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """mont(x) -> x (divide by R): a Montgomery product with the integer 1."""
    return mul(f, a, _col(_consts(f, a.device)["plain_one"], a.ndim))


def to_mont(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """x (plain words, < p) -> mont(x)."""
    return mul(f, a, _col(_consts(f, a.device)["r2"], a.ndim))


def mul_small(f: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for a small non-negative Python int k (repeated doubling)."""
    if k == 0:
        return torch.zeros_like(a)
    acc = None
    base = a
    while k:
        if k & 1:
            acc = base if acc is None else add(f, acc, base)
        k >>= 1
        if k:
            base = double(f, base)
    return acc


def is_zero(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(batch,) bool; requires canonical form (always true here)."""
    return (a == 0).all(dim=0)


def eq(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with mask of batch shape (broadcast over words)."""
    return torch.where(mask[None], a, b)


def pow_const(f: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a ** e for a fixed Python-int exponent, MSB-first square-and-multiply.
    The exponent is a host constant, so a zero bit skips its multiply (the
    JAX scan computes it and selects it away; the values are the same)."""
    if e == 0:
        return ones(f, a.shape[1:], a.device)
    acc = a
    for i in range(e.bit_length() - 2, -1, -1):
        acc = square(f, acc)
        if (e >> i) & 1:
            acc = mul(f, acc, a)
    return acc


def inv(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse; inv(0) = 0."""
    return pow_const(f, a, f.p - 2)


def scan(op, a: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Inclusive scan of the associative ``op`` (a field multiply or add)
    along batch ``axis``: log2(n) steps, each ``op`` over whole columns
    (Hillis-Steele).  The field ops' outputs are canonical, so the words are
    those of the sequential scan."""
    if axis < 0:
        axis = a.ndim + axis
    if axis == 0:
        raise ValueError("axis 0 is the word axis")
    a = torch.movedim(a, axis, 1)
    n, s = a.shape[1], 1
    while s < n:
        a = torch.cat([a[:, :s], op(a[:, s:], a[:, :n - s])], dim=1)
        s *= 2
    return torch.movedim(a, 1, axis)


def batch_inverse(f: FieldSpec, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Montgomery-trick batch inverse along a batch axis (zeros -> zeros):
    1/a_i = (prod_{j<i} a_j)(prod_{j>i} a_j) / prod_j a_j, the prefix and
    suffix products as two log-depth ``scan``s, one Fermat inverse."""
    if axis < 0:
        axis = a.ndim + axis
    if axis == 0:
        raise ValueError("axis 0 is the word axis")
    x = torch.movedim(a, axis, 1)  # (W, n, ...)
    zero = is_zero(f, x)
    one = ones(f, (1,) + x.shape[2:], a.device)
    x = select(zero, one.expand_as(x), x)
    mul_f = lambda u, v: mul(f, u, v)  # noqa: E731
    pre = scan(mul_f, x)
    suf = torch.flip(scan(mul_f, torch.flip(x, dims=[1])), dims=[1])
    excl = mul(f, torch.cat([one, pre[:, :-1]], dim=1), torch.cat([suf[:, 1:], one], dim=1))
    res = mul(f, excl, inv(f, pre[:, -1:]))
    res = select(zero, torch.zeros_like(res), res)
    return torch.movedim(res, 1, axis)
