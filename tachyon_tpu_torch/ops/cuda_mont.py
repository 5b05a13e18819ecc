"""K1: elementwise Montgomery multiply as a hand-written CUDA kernel.

Replaces the Pallas kernel ``tachyon_tpu/ops/pallas_mont.py`` ``_mul_call``
(``pl.pallas_call`` at line 90, body ``_mul_body``): a . b . R^-1 mod p,
canonical, over a flat batch of field elements.

Kernel (``csrc/mont_mul.cu``, ``csrc/field.cuh``): one thread per element,
word-major ``(W, n)`` layout so that the threads of a warp load neighbouring
words.  W-word CIOS with 32-bit words (8 rounds for BN254 instead of the
TPU's 16 rounds of 16-bit limbs).  Where p has a spare bit (p < 2^(32 W -
1), BN254's Fq and Fr) the rounds are PTX multiply-add chains in sppark's
even/odd layout; a full-width p (secp256k1) takes 64-bit CIOS products.
The launcher picks the form from p's top word; the point kernels use the
spare-bit form only, so ``check_cuda`` refuses them other fields.  Bound
on the card: at 2^22 elements it moves 96 bytes per element against 136
word products, so it sits near the memory roofline; on the MSM path it
runs on one or two elements (``to_affine``) and, on the KZG path, on
thousands of small batches: there the wrapper's host time per call is the
cost, so the wrapper does no work that fitting inputs do not need.

``mul_plain`` is the plain PyTorch twin: the CPU path and the reference the
kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.fields.limbs import int_to_words, n0inv32, word_count
from tachyon_tpu_torch.ops import _build
from tachyon_tpu_torch.ops.mont import _consts, csub_p, ripple, widen

SUPPORTED_W = (8,)  # word counts the kernels are instantiated for (BN254)


@functools.lru_cache(maxsize=None)
def field_consts(f: FieldSpec):
    """Host array handed to every launcher: p words, mont(1) words, n0inv32."""
    W = word_count(f)
    vals = [*int_to_words(f.p, W), *int_to_words(f.R_mod_p, W), n0inv32(f)]
    return (ctypes.c_uint32 * len(vals))(*(int(v) for v in vals))


@functools.lru_cache(maxsize=None)
def consts_ptr(f: FieldSpec) -> int:
    return ctypes.addressof(field_consts(f))


def has_spare_bit(f: FieldSpec) -> bool:
    """p < 2^(32 W - 1): the condition of the kernels' even/odd multiply."""
    return f.p >> (32 * word_count(f) - 1) == 0


def check_cuda(f: FieldSpec, *ts: torch.Tensor, any_width: bool = False) -> int:
    """Check the kernels can take these tensors; returns W.  Only K1 takes a
    full-width p (``any_width``); the point kernels need a spare bit."""
    W = word_count(f)
    if W not in SUPPORTED_W:
        raise ValueError(f"{f.name}: no CUDA kernel for W={W} (have {SUPPORTED_W})")
    if not any_width and not has_spare_bit(f):
        raise ValueError(f"{f.name}: the point kernels need p < 2^{32 * W - 1}")
    dev = ts[0].get_device()
    for t in ts:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"tensors must share one CUDA device, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 words, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return W


@functools.lru_cache(maxsize=None)
def _columns(W: int, device: torch.device) -> torch.Tensor:
    """(W * 2W,) 16-bit column 2i + j of the partial product a_i * b16_j
    (a_i a 32-bit word at 2^(32 i), b16_j a 16-bit limb at 2^(16 j))."""
    i = torch.arange(W, device=device)
    j = torch.arange(2 * W, device=device)
    return (2 * i[:, None] + j[None, :]).reshape(-1)


def mul_plain(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: products of a's 32-bit words with b's 16-bit limbs
    (one broadcasted (W, 2W, *batch) int64 product, each below 2^48) summed
    into 16-bit columns, L Montgomery rounds on 16-bit digits
    (``spec.n0inv``), each adding the digit times p's 32-bit words, then
    32-bit word normalization and one conditional subtract.  Columns stay
    below 2^53, so int64 never overflows."""
    a, b = torch.broadcast_tensors(a, b)
    W = a.shape[0]
    L = 2 * W
    batch = a.shape[1:]
    wb = widen(b)
    b16 = torch.stack([wb & 0xFFFF, wb >> 16], dim=1).reshape(L, *batch)
    prod = widen(a)[:, None] * b16[None, :]  # (W, L, *batch) < 2^48
    cols = torch.zeros((2 * L + 1, *batch), dtype=torch.int64, device=a.device)
    cols.index_add_(0, _columns(W, a.device), prod.reshape(W * L, *batch))
    p32 = _consts(f, a.device)["p"].reshape((W,) + (1,) * len(batch))
    n0 = int(f.n0inv)
    for i in range(L):
        m = ((cols[i] & 0xFFFF) * n0) & 0xFFFF
        cols[i:i + L:2] += m * p32  # digit m at 2^(16 i) times p's words
        cols[i + 1] += cols[i] >> 16  # low 16 bits of cols[i] are now zero
    # the high columns as 16-bit limbs plus one carry each, then 32-bit words
    hi = cols[L:]
    lo, carry = hi & 0xFFFF, hi >> 16
    limbs16 = torch.cat([lo[:1], lo[1:L] + carry[:L - 1]])
    words, c = ripple(limbs16[0::2] + (limbs16[1::2] << 16))
    return csub_p(f, words, hi[L] + carry[L - 1] + c)


def mul(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (W, *batch) int32 words.  CPU tensors take
    ``mul_plain``; CUDA tensors launch K1 or raise."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    if a.is_cpu:
        return mul_plain(f, a, b)
    a, b = a.contiguous(), b.contiguous()
    W = check_cuda(f, a, b, any_width=True)
    n = a.numel() // W
    out = torch.empty_like(a)
    if n:
        _build.launch("tt_mont_mul", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      n, consts_ptr(f), W)
        mul.launches += 1
    return out


mul.launches = 0
