// K5 (suffix sweep) and K6 (reduce sweep) of the Pippenger bucket phase.
// Replace tachyon_tpu/ops/pallas_msm.py _suffix_sweep_call (pl.pallas_call at
// :147) and _reduce_sweep_call (pl.pallas_call at :201).
//
// The TPU kernels walk the rows in a sequential grid and carry the lane
// accumulators in VMEM scratch.  Here one thread owns one lane c: its
// accumulator lives in registers, and the row loop runs inside the thread.
// Row-major layouts as in JAX: points (R, W, C), flags (R, 1, C), blinds (W, C).
#include <cuda_runtime.h>

#include "xyzz.cuh"

// suffix[r, :, c] = D[c] + sum_{r' >= r} P[r', c], emitted every row.
template <int W>
__global__ void suffix_sweep_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                                    const uint32_t* __restrict__ inf,
                                    const uint32_t* __restrict__ dx, const uint32_t* __restrict__ dy,
                                    const uint32_t* __restrict__ dzz,
                                    const uint32_t* __restrict__ dzzz, uint32_t* sx, uint32_t* sy,
                                    uint32_t* szz, uint32_t* szzz, int64_t R, int64_t C,
                                    FieldConst<W> f) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Xyzz<W> acc;
  xyzz_load<W>(acc, dx, dy, dzz, dzzz, C, c);
  for (int64_t r = R - 1; r >= 0; --r) {
    const int64_t row = r * W * C;
    uint32_t qx[W], qy[W];
    fp_load<W>(qx, x + row, C, c);
    fp_load<W>(qy, y + row, C, c);
    xyzz_madd_blinded<W>(acc, qx, qy, inf[r * C + c] != 0, f);
    xyzz_store<W>(sx + row, sy + row, szz + row, szzz + row, C, c, acc);
  }
}

// out[:, c] = D[c] + sum_r Q[r, c] over XYZZ rows (infinity rows skipped).
template <int W>
__global__ void reduce_sweep_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                                    const uint32_t* __restrict__ zz,
                                    const uint32_t* __restrict__ zzz,
                                    const uint32_t* __restrict__ dx, const uint32_t* __restrict__ dy,
                                    const uint32_t* __restrict__ dzz,
                                    const uint32_t* __restrict__ dzzz, uint32_t* ox, uint32_t* oy,
                                    uint32_t* ozz, uint32_t* ozzz, int64_t R, int64_t C,
                                    FieldConst<W> f) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Xyzz<W> acc;
  xyzz_load<W>(acc, dx, dy, dzz, dzzz, C, c);
  for (int64_t r = 0; r < R; ++r) {
    const int64_t row = r * W * C;
    Xyzz<W> q;
    xyzz_load<W>(q, x + row, y + row, zz + row, zzz + row, C, c);
    xyzz_add_blinded<W>(acc, q, f);
  }
  xyzz_store<W>(ox, oy, ozz, ozzz, C, c, acc);
}

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

extern "C" cudaError_t tt_suffix_sweep(const void* x, const void* y, const void* inf,
                                       const void* dx, const void* dy, const void* dzz,
                                       const void* dzzz, void* sx, void* sy, void* szz,
                                       void* szzz, int64_t R, int64_t C, const uint32_t* consts,
                                       int W, void* stream) {
  const int threads = 64;
  const int64_t blocks = (C + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 8:
      suffix_sweep_kernel<8><<<(unsigned)blocks, threads, 0, s>>>(
          U32C(x), U32C(y), U32C(inf), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz), U32(sx),
          U32(sy), U32(szz), U32(szzz), R, C, load_consts<8>(consts));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" cudaError_t tt_reduce_sweep(const void* x, const void* y, const void* zz,
                                       const void* zzz, const void* dx, const void* dy,
                                       const void* dzz, const void* dzzz, void* ox, void* oy,
                                       void* ozz, void* ozzz, int64_t R, int64_t C,
                                       const uint32_t* consts, int W, void* stream) {
  const int threads = 64;
  const int64_t blocks = (C + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 8:
      reduce_sweep_kernel<8><<<(unsigned)blocks, threads, 0, s>>>(
          U32C(x), U32C(y), U32C(zz), U32C(zzz), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz),
          U32(ox), U32(oy), U32(ozz), U32(ozzz), R, C, load_consts<8>(consts));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
