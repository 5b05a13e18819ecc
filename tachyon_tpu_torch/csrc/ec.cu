// K2 (complete XYZZ add), K3 (XYZZ double) and K4 (complete mixed add XYZZ +
// affine), one thread per point.  Replace tachyon_tpu/ops/pallas_ec.py
// _add_call (pl.pallas_call at :209), _dbl_call (pl.pallas_call at :232) and
// _madd_call (pl.pallas_call at :257).  Each coordinate is a (W, n)
// word-major int32 array holding uint32 words.
//
// K4 is bound by integer multiplies: a madd is 10 field multiplies (19 on
// the lanes that double), each 2W^2 + W = 136 word products at W = 8 (300
// at W = 12, BLS12-381),
// against 6 x 32 + 4 bytes read and 4 x 32 written per point.  One thread
// keeps a point in registers, as in K2.  The TPU kernel pads the batch to
// whole blocks with q_inf = 1; here a bounds check ends the ragged block.
#include <cuda_runtime.h>

#include "xyzz.cuh"

// K2 asks ptxas for ADD_MIN_BLOCKS blocks of 128 per SM, a register cap:
// 128 registers (84 bytes of spills), where it takes 172 with no bounds and
// 196 at one block.  At the MSM's former T-gather width, 4 x (8, 131071), it
// ran 13-20% faster in turns on the H100 than with no bounds or at one
// block, and faster than at 3 or 5 blocks (PERF.md).  The MSM window no
// longer launches K2 (csrc/buckets.cu and csrc/lanes.cu take its adds); the
// naive MSM's tree reduce and Pedersen's last add do, on 1 to 32 points.
// The cap is per (W, form): the 64-bit CIOS needs more registers than the
// chains, so at W = 8 on a full-width p (secp256k1) and at W = 12
// (BLS12-381, 48 words a point) the kernel asks for one block, ptxas's 255
// registers a thread (untuned first instantiations).
template <int W, bool SPARE>
constexpr int ADD_MIN_BLOCKS = W == 8 && SPARE ? 4 : 1;

template <int W, bool SPARE>
__global__ void __launch_bounds__(128, ADD_MIN_BLOCKS<W, SPARE>)
    add_xyzz_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                const uint32_t* __restrict__ pzz, const uint32_t* __restrict__ pzzz,
                                const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                                const uint32_t* __restrict__ qzz, const uint32_t* __restrict__ qzzz,
                                uint32_t* ox, uint32_t* oy, uint32_t* ozz, uint32_t* ozzz,
                                int64_t n, FieldConst<W, SPARE> f) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Xyzz<W> p, q;
  xyzz_load<W>(p, px, py, pzz, pzzz, n, k);
  xyzz_load<W>(q, qx, qy, qzz, qzzz, n, k);
  Xyzz<W> o = xyzz_add<W, SPARE>(p, q, f);
  xyzz_store<W>(ox, oy, ozz, ozzz, n, k, o);
}

template <int W, bool SPARE>
__global__ void dbl_xyzz_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                const uint32_t* __restrict__ pzz, const uint32_t* __restrict__ pzzz,
                                uint32_t* ox, uint32_t* oy, uint32_t* ozz, uint32_t* ozzz,
                                int64_t n, FieldConst<W, SPARE> f) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Xyzz<W> p;
  xyzz_load<W>(p, px, py, pzz, pzzz, n, k);
  Xyzz<W> o = xyzz_dbl<W, SPARE>(p, f);
  xyzz_store<W>(ox, oy, ozz, ozzz, n, k, o);
}

template <int W, bool SPARE>
__global__ void madd_xyzz_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pzz,
                                 const uint32_t* __restrict__ pzzz,
                                 const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                                 const int32_t* __restrict__ qinf, uint32_t* ox, uint32_t* oy,
                                 uint32_t* ozz, uint32_t* ozzz, int64_t n, FieldConst<W, SPARE> f) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Xyzz<W> p;
  uint32_t ax[W], ay[W];
  xyzz_load<W>(p, px, py, pzz, pzzz, n, k);
  fp_load<W>(ax, qx, n, k);
  fp_load<W>(ay, qy, n, k);
  Xyzz<W> o = xyzz_madd<W, SPARE>(p, ax, ay, qinf[k] != 0, f);
  xyzz_store<W>(ox, oy, ozz, ozzz, n, k, o);
}

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

extern "C" cudaError_t tt_add_xyzz(const void* px, const void* py, const void* pzz,
                                   const void* pzzz, const void* qx, const void* qy,
                                   const void* qzz, const void* qzzz, void* ox, void* oy,
                                   void* ozz, void* ozzz, int64_t n, const uint32_t* consts,
                                   int W, void* stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    add_xyzz_kernel<kW, kS><<<(unsigned)blocks, threads, 0, s>>>(
        U32C(px), U32C(py), U32C(pzz), U32C(pzzz), U32C(qx), U32C(qy), U32C(qzz), U32C(qzzz),
        U32(ox), U32(oy), U32(ozz), U32(ozzz), n, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}

extern "C" cudaError_t tt_dbl_xyzz(const void* px, const void* py, const void* pzz,
                                   const void* pzzz, void* ox, void* oy, void* ozz, void* ozzz,
                                   int64_t n, const uint32_t* consts, int W, void* stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    dbl_xyzz_kernel<kW, kS><<<(unsigned)blocks, threads, 0, s>>>(
        U32C(px), U32C(py), U32C(pzz), U32C(pzzz), U32(ox), U32(oy), U32(ozz), U32(ozzz), n,
        load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}

extern "C" cudaError_t tt_madd_xyzz(const void* px, const void* py, const void* pzz,
                                    const void* pzzz, const void* qx, const void* qy,
                                    const void* qinf, void* ox, void* oy, void* ozz, void* ozzz,
                                    int64_t n, const uint32_t* consts, int W, void* stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    madd_xyzz_kernel<kW, kS><<<(unsigned)blocks, threads, 0, s>>>(
        U32C(px), U32C(py), U32C(pzz), U32C(pzzz), U32C(qx), U32C(qy), (const int32_t*)qinf,
        U32(ox), U32(oy), U32(ozz), U32(ozzz), n, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
