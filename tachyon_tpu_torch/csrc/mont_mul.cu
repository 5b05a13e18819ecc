// K1: elementwise Montgomery multiply, one thread per element.
// Replaces tachyon_tpu/ops/pallas_mont.py _mul_call (pl.pallas_call at :90).
// Layout: a, b, out are (W, n) word-major int32 arrays holding uint32 words.
#include <cuda_runtime.h>

#include "field.cuh"

template <int W>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n, FieldConst<W> f) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t x[W], y[W];
  fp_load<W>(x, a, n, k);
  fp_load<W>(y, b, n, k);
  fp_mul<W>(x, x, y, f);
  fp_store<W>(out, n, k, x);
}

extern "C" cudaError_t tt_mont_mul(const void* a, const void* b, void* out, int64_t n,
                                   const uint32_t* consts, int W, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 8:
      mont_mul_kernel<8><<<(unsigned)blocks, threads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, load_consts<8>(consts));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
