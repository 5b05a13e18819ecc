// K1: elementwise Montgomery multiply, one thread per element.
// Replaces tachyon_tpu/ops/pallas_mont.py _mul_call (pl.pallas_call at :90).
// Layout: a, b, out are (W, n) word-major int32 arrays holding uint32 words.
//
// Bound: bytes at large n (96 bytes moved per element against 136 word
// products), the launch at small n.  The launcher picks the multiply's form
// from p's top word (field.cuh): the even/odd PTX chains when p has a spare
// bit (BN254's Fq and Fr), the 64-bit CIOS for a full-width p (secp256k1).
#include <cuda_runtime.h>

#include "field.cuh"

template <int W, bool SPARE>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n, FieldConst<W> f) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t x[W], y[W];
  fp_load<W>(x, a, n, k);
  fp_load<W>(y, b, n, k);
  fp_mul<W, SPARE>(x, x, y, f);
  fp_store<W>(out, n, k, x);
}

extern "C" cudaError_t tt_mont_mul(const void* a, const void* b, void* out, int64_t n,
                                   const uint32_t* consts, int W, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *a_ = (const uint32_t*)a, *b_ = (const uint32_t*)b;
  uint32_t* out_ = (uint32_t*)out;
  switch (W) {
    case 8:
      if (has_spare_bit<8>(consts)) {
        mont_mul_kernel<8, true><<<blocks, threads, 0, s>>>(a_, b_, out_, n, load_consts<8>(consts));
      } else {
        mont_mul_kernel<8, false><<<blocks, threads, 0, s>>>(a_, b_, out_, n, load_consts<8>(consts));
      }
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
