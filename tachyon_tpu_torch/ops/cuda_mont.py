"""K1: elementwise Montgomery multiply as a hand-written CUDA kernel.

Replaces the Pallas kernel ``tachyon_tpu/ops/pallas_mont.py`` ``_mul_call``
(``pl.pallas_call`` at line 90, body ``_mul_body``): a . b . R^-1 mod p,
canonical, over a flat batch of field elements.

Kernel (``csrc/mont_mul.cu``, ``csrc/field.cuh``): one thread per element,
word-major ``(W, n)`` layout so that the threads of a warp load neighbouring
words.  W-word CIOS with 32-bit words (8 rounds for BN254 instead of the
TPU's 16 rounds of 16-bit limbs; 12 for BLS12-381's Fq instead of 24).
At W = 8, where p has a spare bit (p < 2^(32 W - 1), BN254's Fq and Fr)
the rounds are PTX multiply-add chains in sppark's even/odd layout; a
full-width p (secp256k1) takes 64-bit CIOS products, and so does every
W = 12 field.  The launcher picks the form from p's top word, as every
kernel's launcher does (``kernel_form`` gives the same (W, form) here); the
point kernels take W = 8 in both forms and W = 12.
Bound on the card: at 2^22 elements it moves 96 bytes per element
against 136 word products at W = 8 (144 against 300 at W = 12), so it
sits near the memory roofline; on the MSM path it
runs on one or two elements (``to_affine``) and, on the KZG path, on
thousands of small batches: there the wrapper's host time per call is the
cost, so the wrapper does no work that fitting inputs do not need.

At one word (W = 1: BabyBear, KoalaBear, Mersenne-31) K1 is its own
kernel, ``mont_mul1_kernel`` behind ``mul1``: a 64-bit product, one 32-bit
reduction round and one conditional subtract, in a grid-stride loop.  It
moves 12 bytes an element against 3 word products, so it is bound by
bytes; a ``b`` that broadcasts along one run of a's axes (a constant per
Poseidon2 lane, an NTT stage's twiddles, a weight per column) is read in
place rather than expanded first.  ``mul`` sends W = 1 there.

At two words (W = 2: Goldilocks) K1 is ``mont_mul2_kernel`` behind
``mul2``: an element as one uint64, a 128-bit product, one 64-bit
reduction round that keeps the carry into bit 64 (Goldilocks has no spare
bit), one conditional subtract; the same grid-stride loop and in-place
broadcast as at W = 1, 24 bytes an element against 10 word products.  It is
kept out of the point kernels' dispatch: ``POINT_W`` has no 2, so every
point and sweep kernel refuses Goldilocks.

``mul_plain`` is the plain PyTorch twin: the CPU path and the reference the
kernel is held against on the card, at every W.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tachyon_tpu_torch.fields.spec import FieldSpec
from tachyon_tpu_torch.fields.limbs import int_to_words, n0inv32, word_count
from tachyon_tpu_torch.ops import _build
from tachyon_tpu_torch.ops.mont import _consts, csub_p, ripple, widen

SUPPORTED_W = (1, 2, 8, 12)  # word counts K1 is instantiated for (31-bit fields, Goldilocks, W = 8, BLS12-381)
POINT_W = {8, 12}  # the point and MSM kernels: BN254, secp256k1, Pallas, Vesta; BLS12-381's Fq


class Form(NamedTuple):
    """The instantiation of the kernels a field takes: its word count W and
    the multiply's form, the even/odd PTX chains (``spare``: W = 8 and
    p < 2^255) or the 64-bit CIOS (a full-width p, every W = 12 field, and
    K1 at one and two words).  ``tag`` names it in the launch counts:
    w8_spare, w8_full, w12_full, w1_full, w2_full."""
    W: int
    spare: bool

    @property
    def tag(self) -> str:
        return f"w{self.W}_{'spare' if self.spare else 'full'}"


def kernel_form(f: FieldSpec) -> Form:
    """The (W, form) the launchers pick for f from p's top word, by the rule
    of ``csrc/field.cuh``'s TT_DISPATCH: the chains only at W = 8 with a
    spare bit."""
    W = word_count(f)
    return Form(W, W == 8 and has_spare_bit(f))


def count_launch(wrapper, f: FieldSpec) -> None:
    """One launch of ``wrapper``'s kernel for field f: ``wrapper.launches``
    counts every launch, ``wrapper.launches_by_form`` them by the
    instantiation's tag (``Form.tag``: K1 runs at W = 8 and 12 on the
    BLS12-381 path; BN254 takes the w8_spare kernels and secp256k1 the
    w8_full ones)."""
    wrapper.launches += 1
    tag = kernel_form(f).tag
    wrapper.launches_by_form[tag] = wrapper.launches_by_form.get(tag, 0) + 1


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


def check_cuda(f: FieldSpec, *ts: torch.Tensor, any_width: bool = False) -> Form:
    """Check the kernels can take field f and these tensors (CUDA int32
    words on one device, contiguous); returns f's ``Form``.  K1 takes every
    W of SUPPORTED_W (``any_width``); the point kernels W = 8 (either form:
    a full-width p takes the 64-bit CIOS) and W = 12."""
    W = word_count(f)
    if W not in SUPPORTED_W:
        raise ValueError(f"{f.name}: no CUDA kernel for W={W} (have {SUPPORTED_W})")
    if not any_width and W not in POINT_W:
        raise ValueError(f"{f.name}: the point kernels take W in {sorted(POINT_W)}, not W={W}")
    dev = ts[0].get_device() if ts else None
    for t in ts:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"tensors must share one CUDA device, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 words, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return kernel_form(f)


def mul_plain(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: products of a's 32-bit words with b's 16-bit limbs
    (each below 2^48) summed into 16-bit columns, one fused multiply-add of
    a word by every limb of b at a time (no (W, 2W, *batch) product held),
    L Montgomery rounds on 16-bit digits (``spec.n0inv``), each adding the
    digit times p's 32-bit words, then 32-bit word normalization and one
    conditional subtract.  Columns stay below 2^53, so int64 never
    overflows."""
    a, b = torch.broadcast_tensors(a, b)
    W = a.shape[0]
    L = 2 * W
    batch = a.shape[1:]
    wa, wb = widen(a), widen(b)
    b16 = torch.stack([wb & 0xFFFF, wb >> 16], dim=1).reshape(L, *batch)
    cols = torch.zeros((2 * L + 1, *batch), dtype=torch.int64, device=a.device)
    for i in range(W):  # a_i b16_j lands in 16-bit column 2i + j
        cols[2 * i:2 * i + L].addcmul_(b16, wa[i])
    p32 = _consts(f, a.device)["p"].reshape((W,) + (1,) * len(batch))
    n0 = int(f.n0inv)
    for i in range(L):
        m = ((cols[i] & 0xFFFF) * n0) & 0xFFFF
        cols[i:i + L:2].addcmul_(p32, m)  # digit m at 2^(16 i) times p's words
        cols[i + 1] += cols[i] >> 16  # low 16 bits of cols[i] are now zero
    # the high columns as 16-bit limbs plus one carry each, then 32-bit words
    hi = cols[L:]
    lo, carry = hi & 0xFFFF, hi >> 16
    limbs16 = torch.cat([lo[:1], lo[1:L] + carry[:L - 1]])
    words, c = ripple(limbs16[0::2] + (limbs16[1::2] << 16))
    return csub_p(f, words, hi[L] + carry[L - 1] + c)


def broadcast_run(out_shape, b_shape) -> tuple[int, int] | None:
    """(inner, period) such that b's element for a's flat index k is b's
    flat element (k // inner) % period, when the axes along which b varies
    are one contiguous run of the output's axes; None otherwise.  Equal
    shapes give (1, n)."""
    nd = len(out_shape)
    bs = (1,) * (nd - len(b_shape)) + tuple(b_shape)
    live = [i for i in range(nd) if out_shape[i] != 1 and bs[i] != 1]
    if not live:
        return 1, 1
    lo, hi = live[0], live[-1] + 1
    if any(bs[i] == 1 and out_shape[i] != 1 for i in range(lo, hi)):
        return None
    inner = 1
    for d in out_shape[hi:]:
        inner *= d
    period = 1
    for d in out_shape[lo:hi]:
        period *= d
    return inner, period


def _narrow_operands(a: torch.Tensor, b: torch.Tensor):
    """Operands of K1 at W = 1 or 2, broadcasting as PyTorch does: the
    operand of the output's shape streams (contiguous), the other is read
    in place where ``broadcast_run`` finds its pattern over the batch axes
    (the word axis is whole in both), else expanded.  Returns (a, b,
    (inner, period)); equal shapes take the short path (the wrapper's host
    time is K1's cost on small batches)."""
    if a.shape == b.shape:
        a, b = a.contiguous(), b.contiguous()
        return a, b, (1, a[0].numel())
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.shape != shape and b.shape == shape:
        a, b = b, a  # the product commutes, word for word
    a = a.expand(shape).contiguous()
    b = b.reshape((1,) * (len(shape) - b.ndim) + tuple(b.shape))
    b = b.expand(shape[0], *b.shape[1:])  # the word axis whole
    n = a[0].numel()
    run = broadcast_run(shape[1:], b.shape[1:])
    if run is not None and run[1] != n and n >= 1 << 32:
        run = None  # the kernel's broadcast index is 32-bit
    b = (b if run is not None else b.expand(shape)).contiguous()
    return a, b, run or (1, n)


def _mul_narrow(wrapper, launcher: str, f: FieldSpec, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """K1 at W = 1 or 2 on CUDA tensors through ``launcher``; counts a
    launch on ``wrapper``."""
    a, b, (inner, period) = _narrow_operands(a, b)
    if not (a.is_cuda and a.dtype == b.dtype == torch.int32 and b.device == a.device):
        check_cuda(f, a, b, any_width=True)  # raises with the reason
    if a.shape[0] != word_count(f):
        raise ValueError(f"{f.name}: {a.shape[0]} words, not {word_count(f)}")
    n = a[0].numel()
    out = torch.empty_like(a)
    if n:
        _build.launch(launcher, a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                      inner, period, consts_ptr(f))
        count_launch(wrapper, f)
    return out


def mul1(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 at W = 1 on CUDA tensors (1, *batch), a broadcast b read in
    place (``_narrow_operands``)."""
    return _mul_narrow(mul1, "tt_mont_mul1", f, a, b)


mul1.launches = 0
mul1.launches_by_form = {}


def mul2(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 at W = 2 (Goldilocks) on CUDA tensors (2, *batch), a broadcast b
    (an NTT stage's twiddles, a Poseidon2 round's constants) read in place
    (``_narrow_operands``)."""
    return _mul_narrow(mul2, "tt_mont_mul2", f, a, b)


mul2.launches = 0
mul2.launches_by_form = {}


def mul(f: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (W, *batch) int32 words.  CPU tensors take
    ``mul_plain``; CUDA tensors launch K1 (``mul1`` at W = 1, ``mul2`` at
    W = 2) or raise."""
    if a.is_cpu and b.is_cpu:
        return mul_plain(f, a, b)
    if f.L == 2:
        return mul1(f, a, b)
    if f.L == 4:
        return mul2(f, a, b)
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    a, b = a.contiguous(), b.contiguous()
    W = check_cuda(f, a, b, any_width=True).W
    n = a.numel() // W
    out = torch.empty_like(a)
    if n:
        _build.launch("tt_mont_mul", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      n, consts_ptr(f), W)
        count_launch(mul, f)
    return out


mul.launches = 0
mul.launches_by_form = {}
