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
