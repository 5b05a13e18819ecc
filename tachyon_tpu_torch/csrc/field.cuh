// W-word Montgomery arithmetic for one field element per thread.
//
// Port of the limb programs inside the Pallas kernels of
// tachyon_tpu/ops/pallas_mont.py (_mul_body) and tachyon_tpu/ops/pallas_ec.py
// (_fadd, _fsub, _fzero_mask, _fsel).  An element is W little-endian 32-bit
// words; R = 2^(32 W) equals the JAX package's R = 2^(16 L), so Montgomery
// values are the same integers.  Every function takes canonical inputs (< p)
// and returns a canonical result: the point formulas select their cases with
// fp_is_zero, which is only right on canonical values.
//
// Additions and subtractions are PTX carry chains (add.cc / addc / sub.cc /
// subc; 13% faster on the 2^22 MSM than the same chains in portable C++).
// The multiply has two forms, and the form is part of the constants' type,
// FieldConst<W, SPARE>, so that every function and kernel that multiplies
// carries it as a template parameter and none can fall back on a default:
// SPARE = true for p < 2^255 at W = 8 (BN254, Pallas, Vesta: a spare bit),
// 32-bit PTX multiply-add chains in the even/odd layout of sppark's mont_t,
// written for W = 8 only; SPARE = false, CIOS on 64-bit C++ products with
// two words above the top, right for any W and any p < 2^(32 W) (secp256k1's
// p is a full 256 bits; BLS12-381's Fq, W = 12).  The launchers pick the
// form from p's top word (TT_DISPATCH below).
#pragma once

#include <cstdint>

// SPARE: the multiply's form, the even/odd chains (true) or the 64-bit CIOS.
template <int W, bool SPARE>
struct FieldConst {
  uint32_t p[W];    // modulus words
  uint32_t one[W];  // mont(1) = R mod p
  uint32_t n0inv;   // -p^-1 mod 2^32
};

// Launchers receive the constants as a host array [p | one | n0inv].
template <int W, bool SPARE>
inline FieldConst<W, SPARE> load_consts(const uint32_t* host) {
  FieldConst<W, SPARE> f;
  for (int i = 0; i < W; ++i) f.p[i] = host[i];
  for (int i = 0; i < W; ++i) f.one[i] = host[W + i];
  f.n0inv = host[2 * W];
  return f;
}

// p < 2^(32 W - 1), the condition of the even/odd chains: the top word's
// high bit is clear.
template <int W>
inline bool has_spare_bit(const uint32_t* consts) {
  return (consts[W - 1] >> 31) == 0;
}

// The (W, form) pairs every multi-word kernel is built at: (8, spare) for
// BN254, Pallas and Vesta, (8, full) for secp256k1's full-width p, (12,
// full) for BLS12-381's Fq (the chains are W = 8 code, so W = 12 takes the
// 64-bit CIOS whatever p).  A launcher's body is a lambda on the constexpr
// int kW and bool kS: TT_DISPATCH(W, consts, [&] { kernel<kW, kS><<<...>>>(...);
// ... }) runs it with the form p's top word gives and returns what it
// returns, and refuses any other W.  ops/cuda_mont.py's POINT_W and
// kernel_form name the same set and rule.
#define TT_DISPATCH(W, consts, ...)                      \
  switch ((W) == 8 ? (has_spare_bit<8>(consts) ? 0 : 1) \
                   : (W) == 12 ? 2 : -1) {              \
    case 0: {                                            \
      constexpr int kW = 8;                              \
      constexpr bool kS = true;                          \
      return __VA_ARGS__();                              \
    }                                                    \
    case 1: {                                            \
      constexpr int kW = 8;                              \
      constexpr bool kS = false;                         \
      return __VA_ARGS__();                              \
    }                                                    \
    case 2: {                                            \
      constexpr int kW = 12;                             \
      constexpr bool kS = false;                         \
      return __VA_ARGS__();                              \
    }                                                    \
    default:                                             \
      return cudaErrorInvalidValue;                      \
  }

// ---- PTX carry-chain primitives ---------------------------------------------
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// ---- element helpers ----------------------------------------------------------
template <int W>
__device__ __forceinline__ void fp_copy(uint32_t r[W], const uint32_t a[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = a[i];
}

template <int W>
__device__ __forceinline__ void fp_zero(uint32_t r[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = 0;
}

template <int W>
__device__ __forceinline__ bool fp_is_zero(const uint32_t a[W]) {
  uint32_t acc = a[0];
#pragma unroll
  for (int i = 1; i < W; ++i) acc |= a[i];
  return acc == 0;
}

// r = mask ? a : b  (r may alias b)
template <int W>
__device__ __forceinline__ void fp_select(uint32_t r[W], bool mask, const uint32_t a[W],
                                          const uint32_t b[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = mask ? a[i] : b[i];
}

// Value (top:t) < 2p -> r = canonical value.  r may alias t.
template <int W, bool SPARE>
__device__ __forceinline__ void fp_reduce_once(uint32_t r[W], const uint32_t t[W], uint32_t top,
                                               const FieldConst<W, SPARE>& f) {
  uint32_t d[W];
  d[0] = sub_cc(t[0], f.p[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) d[i] = subc_cc(t[i], f.p[i]);
  uint32_t borrow = subc(top, 0u);  // 0xffffffff when (top:t) < p
  bool keep = borrow != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = keep ? t[i] : d[i];
}

template <int W, bool SPARE>
__device__ __forceinline__ void fp_add(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                                       const FieldConst<W, SPARE>& f) {
  uint32_t s[W];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) s[i] = addc_cc(a[i], b[i]);
  uint32_t top = addc(0u, 0u);
  fp_reduce_once<W, SPARE>(r, s, top, f);
}

template <int W, bool SPARE>
__device__ __forceinline__ void fp_dbl(uint32_t r[W], const uint32_t a[W], const FieldConst<W, SPARE>& f) {
  fp_add<W, SPARE>(r, a, a, f);
}

template <int W, bool SPARE>
__device__ __forceinline__ void fp_sub(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                                       const FieldConst<W, SPARE>& f) {
  uint32_t d[W];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) d[i] = subc_cc(a[i], b[i]);
  uint32_t mask = subc(0u, 0u);  // 0xffffffff when a < b: add p back
  r[0] = add_cc(d[0], f.p[0] & mask);
#pragma unroll
  for (int i = 1; i < W; ++i) r[i] = addc_cc(d[i], f.p[i] & mask);
  (void)addc(0u, 0u);  // close the chain; the carry out is dropped
}

// ---- the spare-bit multiply: sppark's even/odd layout --------------------------
// The running sum t is kept as two W-word arrays, t = even + odd * 2^32:
// the product a[j] * b_i of an even j lands in even[j..j+1], of an odd j in
// odd[j-1..j], so neither array has two products on one word and each row
// is one unbroken chain of mad.lo / mad.hi with the carry in the flag (in
// SASS, IMAD.WIDE.U32.X with the carry in a predicate): one wide integer
// multiply-add per word product, and no separate add for a carry.
// t < 2 p 2^32 < 2^(32 (W + 1)) before every shift (p < 2^(32 W - 1)), so
// the odd array never carries out of its top word.  Each chain is one asm
// statement: as separate statements, the compiler reordered them apart
// from the carry flag they pass (wrong words on the H100).  Written for
// W = 8 only; other word counts take the 64-bit CIOS below.

// One CIOS round on t = even + odd * 2^32: t = (t + a * bi + m * p) / 2^32
// with m = t[0] * n0inv.  After it the roles swap: the caller passes the
// arrays in the other order next round, since the shift moves odd to word 0.
template <int W>
__device__ __forceinline__ void mad_n_redc(uint32_t even[W], uint32_t odd[W], const uint32_t a[W],
                                           uint32_t bi, const FieldConst<W, true>& f, bool first) {
  static_assert(W == 8, "the chains below are written for W = 8");
  if (first) {
#pragma unroll
    for (int j = 0; j < W; j += 2) {
      even[j] = a[j] * bi;
      even[j + 1] = __umulhi(a[j], bi);
      odd[j] = a[j + 1] * bi;
      odd[j + 1] = __umulhi(a[j + 1], bi);
    }
  } else {
    // the last round left even[0] = 0: even[1] joins word 0 and even[2..]
    // shift into the odd array, which takes a[odd] * bi; then even takes
    // a[even] * bi in a fresh chain whose carry goes to odd's top word
    asm(
      "add.cc.u32 %0, %0, %9;\n\t"
      "madc.lo.cc.u32 %8, %17, %24, %10;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %11;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %12;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %13;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %14;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %15;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, 0;\n\t"
      "madc.hi.u32 %15, %23, %24, 0;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;\n\t"
      : "+r"(even[0]), "+r"(even[1]), "+r"(even[2]), "+r"(even[3]), "+r"(even[4]), "+r"(even[5]),
        "+r"(even[6]), "+r"(even[7]), "+r"(odd[0]), "+r"(odd[1]), "+r"(odd[2]), "+r"(odd[3]),
        "+r"(odd[4]), "+r"(odd[5]), "+r"(odd[6]), "+r"(odd[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(bi));
  }
  const uint32_t mi = even[0] * f.n0inv;
  // odd += p[odd] * mi (no carry out), even += p[even] * mi
  asm(
      "mad.lo.cc.u32 %8, %17, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %12;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, %14;\n\t"
      "madc.hi.u32 %15, %23, %24, %15;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;\n\t"
      : "+r"(even[0]), "+r"(even[1]), "+r"(even[2]), "+r"(even[3]), "+r"(even[4]), "+r"(even[5]),
        "+r"(even[6]), "+r"(even[7]), "+r"(odd[0]), "+r"(odd[1]), "+r"(odd[2]), "+r"(odd[3]),
        "+r"(odd[4]), "+r"(odd[5]), "+r"(odd[6]), "+r"(odd[7])
      : "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]), "r"(f.p[3]), "r"(f.p[4]), "r"(f.p[5]), "r"(f.p[6]),
        "r"(f.p[7]), "r"(mi));
}

// CIOS Montgomery product r = a * b * R^-1 mod p, canonical.  r may alias a or b.
//
// SPARE (p < 2^(32 W - 1), W = 8): the even/odd chains above; the rounds
// leave t < 2p in W words after the merge.  Otherwise each round adds
// a * b[i], then m * p with m = t[0] * n0inv so that the low word cancels,
// and shifts t down one word; t < 2p after every round, so the two words
// above the top (t[W], t[W+1]) never overflow.  Those products are plain
// 64-bit C++ (IMAD.WIDE with a separate add for each carry).  The form is
// f's type, never a default: secp256k1's full-width p at W = 8 and every p
// at W = 12 come here as FieldConst<W, false>.
template <int W, bool SPARE>
__device__ __forceinline__ void fp_mul(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                                       const FieldConst<W, SPARE>& f) {
  if constexpr (SPARE) {
    uint32_t even[W], odd[W];
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      mad_n_redc<W>(even, odd, a, b[i], f, i == 0);
      mad_n_redc<W>(odd, even, a, b[i + 1], f, false);
    }
    // merge: t = odd + even * 2^32 with odd[0] = 0, so t / 2^32 = even + odd[1..]
    asm(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
        : "+r"(even[0]), "+r"(even[1]), "+r"(even[2]), "+r"(even[3]), "+r"(even[4]), "+r"(even[5]),
          "+r"(even[6]), "+r"(even[7])
        : "r"(odd[1]), "r"(odd[2]), "r"(odd[3]), "r"(odd[4]), "r"(odd[5]), "r"(odd[6]),
          "r"(odd[7]));
    fp_reduce_once<W, SPARE>(r, even, 0u, f);
  } else {
    uint32_t t[W + 2];
#pragma unroll
    for (int i = 0; i < W + 2; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t c = 0;  // t += a * b[i]
#pragma unroll
      for (int j = 0; j < W; ++j) {
        uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
        t[j] = (uint32_t)s;
        c = s >> 32;
      }
      uint64_t s = (uint64_t)t[W] + c;
      t[W] = (uint32_t)s;
      t[W + 1] = (uint32_t)(s >> 32);
      uint32_t m = t[0] * f.n0inv;
      c = ((uint64_t)m * f.p[0] + t[0]) >> 32;
#pragma unroll
      for (int j = 1; j < W; ++j) {
        uint64_t u = (uint64_t)m * f.p[j] + t[j] + c;
        t[j - 1] = (uint32_t)u;
        c = u >> 32;
      }
      s = (uint64_t)t[W] + c;
      t[W - 1] = (uint32_t)s;
      t[W] = t[W + 1] + (uint32_t)(s >> 32);
    }
    fp_reduce_once<W, SPARE>(r, t, t[W], f);
  }
}

template <int W, bool SPARE>
__device__ __forceinline__ void fp_sq(uint32_t r[W], const uint32_t a[W], const FieldConst<W, SPARE>& f) {
  fp_mul<W, SPARE>(r, a, a, f);
}

// ---- strided loads/stores: element k of a (W, n) word-major array --------------
template <int W>
__device__ __forceinline__ void fp_load(uint32_t r[W], const uint32_t* base, int64_t n,
                                        int64_t k) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = base[i * n + k];
}

template <int W>
__device__ __forceinline__ void fp_store(uint32_t* base, int64_t n, int64_t k,
                                         const uint32_t a[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) base[i * n + k] = a[i];
}
