// K1: elementwise Montgomery multiply, one thread per element.
// Replaces tachyon_tpu/ops/pallas_mont.py _mul_call (pl.pallas_call at :90).
// Layout: a, b, out are (W, n) word-major int32 arrays holding uint32 words.
//
// Bound: bytes at large n (96 bytes moved per element against 136 word
// products at W = 8; 144 against 300 at W = 12), the launch at small n.
// The launcher picks the multiply's form from p's top word, as every
// launcher does (TT_DISPATCH, field.cuh): the even/odd PTX chains at W = 8
// when p has a spare bit (BN254's, Pallas's and Vesta's Fq and Fr), the
// 64-bit CIOS for a full-width p (secp256k1's Fq and Fr) and at W = 12
// (BLS12-381's Fq).
//
// tt_mont_mul1 is K1 at one word (W = 1: BabyBear, KoalaBear, Mersenne-31,
// whose R = 2^32 is the JAX package's R at L = 2): t = a b in 64 bits,
// m = lo(t) n0inv mod 2^32, u = (t + m p) >> 32 < 2p, minus p once.  With
// p < 2^31, t + m p < 2^62 + 2^63 never wraps.  It is bound by bytes (12 an
// element: 8 with a broadcast b, which stays in L1/L2) against 3 word
// products, so the kernel is a grid-stride loop of coalesced 4-byte loads.
// A b broadcast along the batch (a round constant per state lane, an NTT
// stage's twiddles, a column's weight) is read in place, at index
// (k / inner) % period, instead of being expanded to a's size first.
//
// tt_mont_mul2 is K1 at two words (W = 2: Goldilocks, p = 2^64 - 2^32 + 1,
// the JAX package's L = 4).  It is a kernel of its own, kept out of
// TT_DISPATCH so that no point or sweep kernel is built at W = 2, and it
// takes an element as one uint64 rather than the generic W-word CIOS:
// t = a b as 128 bits (a 64-bit product and __umul64hi), one 64-bit
// Montgomery round m = lo(t) n0inv64 mod 2^64, u = (t + m p) / 2^64, one
// conditional subtract.  p has no spare bit (its top word is 0xFFFFFFFF),
// so t + m p < p^2 + 2^64 p < 2^129 and u < 2p can exceed 2^64: the carry
// into bit 64 is kept (`top`), as the extra limb of pallas_mont.py's
// _mul_body keeps it, and a set carry forces the subtract.  The low halves
// of t and m p sum to 0 mod 2^64 by the choice of m, so their carry is 1
// exactly when lo(t) != 0.  n0inv64 = -p^-1 mod 2^64 is lifted on the host
// from the consts' n0inv32 by one Newton step.  Words stay word-major
// ((2, n): the low words, then the high), two coalesced 4-byte loads an
// operand.  Bound: bytes, 24 an element (16 with a broadcast b) against 10
// word products (2 W^2 + W); the b of an NTT stage (its twiddles) or of a
// Poseidon2 round (its constants, the internal diagonal) is read in place
// as at W = 1.
#include <cuda_runtime.h>

#include "field.cuh"

template <int W, bool SPARE>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n, FieldConst<W, SPARE> f) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t x[W], y[W];
  fp_load<W>(x, a, n, k);
  fp_load<W>(y, b, n, k);
  fp_mul<W, SPARE>(x, x, y, f);
  fp_store<W>(out, n, k, x);
}

template <bool BCAST>
__global__ void mont_mul1_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t n, uint32_t inner,
                                 uint32_t period, uint32_t p, uint32_t n0inv) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * blockDim.x) {
    // BCAST only for n < 2^32 (the launcher's rule), so k fits 32 bits there
    const uint32_t j = BCAST ? ((uint32_t)k / inner) % period : 0;
    const uint64_t t = (uint64_t)a[k] * (BCAST ? b[j] : b[k]);
    const uint32_t m = (uint32_t)t * n0inv;
    const uint32_t u = (uint32_t)((t + (uint64_t)m * p) >> 32);
    out[k] = u >= p ? u - p : u;
  }
}

// consts: [p, mont(1), n0inv] as for W = 1 in field_consts; b is read at
// (k / inner) % period, or at k where period == n (no broadcast)
extern "C" cudaError_t tt_mont_mul1(const void* a, const void* b, void* out, int64_t n,
                                    int64_t inner, int64_t period, const uint32_t* consts,
                                    void* stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks of 256 an SM, then the loop
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *a_ = (const uint32_t*)a, *b_ = (const uint32_t*)b;
  uint32_t* out_ = (uint32_t*)out;
  if (period == n) {
    mont_mul1_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(a_, b_, out_, n, 1, 1, consts[0],
                                                                 consts[2]);
  } else {
    if (n >= (int64_t)1 << 32 || inner < 1 || period < 1) return cudaErrorInvalidValue;
    mont_mul1_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        a_, b_, out_, n, (uint32_t)inner, (uint32_t)period, consts[0], consts[2]);
  }
  return cudaGetLastError();
}

template <bool BCAST>
__global__ void mont_mul2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t n, uint32_t inner,
                                 uint32_t period, uint64_t p, uint64_t n0inv) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * blockDim.x) {
    // BCAST only for n < 2^32 (the launcher's rule); b's words are period apart
    const int64_t j = BCAST ? (int64_t)(((uint32_t)k / inner) % period) : k;
    const uint64_t x = (uint64_t)a[k] | ((uint64_t)a[n + k] << 32);
    const uint64_t y = (uint64_t)b[j] | ((uint64_t)b[(BCAST ? (int64_t)period : n) + j] << 32);
    const uint64_t lo = x * y, hi = __umul64hi(x, y);
    const uint64_t m = lo * n0inv;
    const uint64_t mp_hi = __umul64hi(m, p);
    const uint64_t s = hi + mp_hi;
    const uint64_t u = s + (lo != 0 ? 1u : 0u);
    const bool top = (s < hi) || (u < s);  // bit 64 of (t + m p) / 2^64
    const uint64_t r = (top || u >= p) ? u - p : u;
    out[k] = (uint32_t)r;
    out[n + k] = (uint32_t)(r >> 32);
  }
}

// consts: [p lo, p hi, mont(1) lo, mont(1) hi, n0inv32] as for W = 2 in
// field_consts; b is (2, period) words read at (k / inner) % period, or
// (2, n) at k where period == n (no broadcast)
extern "C" cudaError_t tt_mont_mul2(const void* a, const void* b, void* out, int64_t n,
                                    int64_t inner, int64_t period, const uint32_t* consts,
                                    void* stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks of 256 an SM, then the loop
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const uint64_t p = (uint64_t)consts[0] | ((uint64_t)consts[1] << 32);
  uint64_t pinv = (uint32_t)(0u - consts[4]);  // p^-1 mod 2^32
  pinv *= 2 - p * pinv;                        // Newton: p^-1 mod 2^64
  const uint64_t n0inv = 0 - pinv;
  const uint32_t *a_ = (const uint32_t*)a, *b_ = (const uint32_t*)b;
  uint32_t* out_ = (uint32_t*)out;
  if (period == n) {
    mont_mul2_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(a_, b_, out_, n, 1, 1, p, n0inv);
  } else {
    if (n >= (int64_t)1 << 32 || inner < 1 || period < 1) return cudaErrorInvalidValue;
    mont_mul2_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        a_, b_, out_, n, (uint32_t)inner, (uint32_t)period, p, n0inv);
  }
  return cudaGetLastError();
}

extern "C" cudaError_t tt_mont_mul(const void* a, const void* b, void* out, int64_t n,
                                   const uint32_t* consts, int W, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *a_ = (const uint32_t*)a, *b_ = (const uint32_t*)b;
  uint32_t* out_ = (uint32_t*)out;
  TT_DISPATCH(W, consts, [&] {
    mont_mul_kernel<kW, kS><<<blocks, threads, 0, s>>>(a_, b_, out_, n, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
