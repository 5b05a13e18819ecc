// The fused double-and-add ladder: [s]P for one point per thread, the whole
// of SWCurve.scalar_mul in one launch.  Replaces the TPU kernels that the
// JAX scalar_mul scan (tachyon_tpu/math/ec.py:313-338) launches at every
// bit, tachyon_tpu/ops/pallas_ec.py _madd_call (pl.pallas_call at :257)
// and _dbl_call (:232), together with the scan's select on the bit.
//
// Layout: P's affine x, y as (W, n) word-major arrays, its (n,) int32
// infinity flags, the scalars as (Ws, n) plain int32 words; the result is
// 4 x (W, n) XYZZ.  One thread holds P, the current scalar word and the
// accumulator in registers for all Ws x 32 steps, MSB first, from the
// all-zero infinity: acc = dbl(acc), then acc = madd(acc, P) on a 1 bit.
// The device functions are those of xyzz.cuh (the JAX order of case
// selects), and skipping the madd on a 0 bit leaves the words that the
// scan's compute-then-select leaves, so the result equals the JAX words.
// No bit is skipped: leading zeros double infinity into infinity.
//
// Bound: integer multiplies, 9 field multiplies per double and 10 per
// madd, against ~230 bytes moved per lane.  On the card's path before this
// kernel, each step was a K3 launch, a K4 launch and four selects over the
// whole batch, so the accumulator went through device memory three times
// per bit and the host issued ~17 operations per bit.  Here it never leaves
// registers.  The lanes of a warp take the madd on different bits, so a
// warp pays for a madd on nearly every step; the bound counts only the
// madds the bits need.
#include <cuda_runtime.h>

#include "xyzz.cuh"

constexpr int LADDER_THREADS = 128;

template <int W, bool SPARE>
__global__ void __launch_bounds__(LADDER_THREADS)
    scalar_mul_xyzz_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                           const int32_t* __restrict__ pinf, const uint32_t* __restrict__ sc,
                           uint32_t* ox, uint32_t* oy, uint32_t* ozz, uint32_t* ozzz, int64_t n,
                           int Ws, FieldConst<W, SPARE> f) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t ax[W], ay[W];
  fp_load<W>(ax, px, n, k);
  fp_load<W>(ay, py, n, k);
  const bool p_inf = pinf[k] != 0;
  Xyzz<W> acc;
  fp_zero<W>(acc.x);
  fp_zero<W>(acc.y);
  fp_zero<W>(acc.zz);
  fp_zero<W>(acc.zzz);
#pragma unroll 1
  for (int w = Ws - 1; w >= 0; --w) {
    const uint32_t word = sc[w * n + k];
#pragma unroll 1
    for (int j = 31; j >= 0; --j) {
      acc = xyzz_dbl<W, SPARE>(acc, f);
      if ((word >> j) & 1u) acc = xyzz_madd<W, SPARE>(acc, ax, ay, p_inf, f);
    }
  }
  xyzz_store<W>(ox, oy, ozz, ozzz, n, k, acc);
}

extern "C" cudaError_t tt_scalar_mul_xyzz(const void* px, const void* py, const void* pinf,
                                          const void* scalars, void* ox, void* oy, void* ozz,
                                          void* ozzz, int64_t n, int Ws, const uint32_t* consts,
                                          int W, void* stream) {
  const int64_t blocks = (n + LADDER_THREADS - 1) / LADDER_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    scalar_mul_xyzz_kernel<kW, kS><<<(unsigned)blocks, LADDER_THREADS, 0, s>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)pinf, (const uint32_t*)scalars,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)ozz, (uint32_t*)ozzz, n, Ws,
        load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
