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
// The multiply is CIOS on 32-bit words with 64-bit products and two words
// above the top word, so it stays right for moduli up to 2^(32 W) - 1
// (secp256k1's p is a full 256 bits).
#pragma once

#include <cstdint>

template <int W>
struct FieldConst {
  uint32_t p[W];    // modulus words
  uint32_t one[W];  // mont(1) = R mod p
  uint32_t n0inv;   // -p^-1 mod 2^32
};

// Launchers receive the constants as a host array [p | one | n0inv].
template <int W>
inline FieldConst<W> load_consts(const uint32_t* host) {
  FieldConst<W> f;
  for (int i = 0; i < W; ++i) f.p[i] = host[i];
  for (int i = 0; i < W; ++i) f.one[i] = host[W + i];
  f.n0inv = host[2 * W];
  return f;
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
template <int W>
__device__ __forceinline__ void fp_reduce_once(uint32_t r[W], const uint32_t t[W], uint32_t top,
                                               const FieldConst<W>& f) {
  uint32_t d[W];
  d[0] = sub_cc(t[0], f.p[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) d[i] = subc_cc(t[i], f.p[i]);
  uint32_t borrow = subc(top, 0u);  // 0xffffffff when (top:t) < p
  bool keep = borrow != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = keep ? t[i] : d[i];
}

template <int W>
__device__ __forceinline__ void fp_add(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                                       const FieldConst<W>& f) {
  uint32_t s[W];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) s[i] = addc_cc(a[i], b[i]);
  uint32_t top = addc(0u, 0u);
  fp_reduce_once<W>(r, s, top, f);
}

template <int W>
__device__ __forceinline__ void fp_dbl(uint32_t r[W], const uint32_t a[W], const FieldConst<W>& f) {
  fp_add<W>(r, a, a, f);
}

template <int W>
__device__ __forceinline__ void fp_sub(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                                       const FieldConst<W>& f) {
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

// CIOS Montgomery product r = a * b * R^-1 mod p, canonical.  r may alias a or b.
// Each round adds a * b[i], then m * p with m = t[0] * n0inv so that the low
// word cancels, and shifts t down one word; t < 2p after every round, so the
// two words above the top (t[W], t[W+1]) never overflow.  The products are
// plain 64-bit C++ (IMAD.WIDE): the same CIOS on volatile PTX mad.lo.cc /
// madc.hi.cc chains measured 17% slower on the 2^22 MSM (volatile asm likely
// keeps ptxas from interleaving the rows).
template <int W>
__device__ __forceinline__ void fp_mul(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                                       const FieldConst<W>& f) {
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
  fp_reduce_once<W>(r, t, t[W], f);
}

template <int W>
__device__ __forceinline__ void fp_sq(uint32_t r[W], const uint32_t a[W], const FieldConst<W>& f) {
  fp_mul<W>(r, a, a, f);
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
