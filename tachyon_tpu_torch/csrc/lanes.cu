// The MSM window's two lane reductions, each one launch of K2's complete
// add (xyzz_add).  They replace the JAX package's fori_loops over the K2
// Pallas kernel (tachyon_tpu/ops/pallas_ec.py _add_call, pl.pallas_call at
// :209): _suffix_scan_lanes (tachyon_tpu/math/msm.py:196-206) and
// _fold_reduce_lanes (:209-222), where every step is a K2 launch over the
// whole lane axis plus the lane shift.
//
// Bound: neither is bound by multiplies or bytes.  A step is at most C
// complete adds (C = 4096 lanes in the scan, 512 in the fold) and the
// chain of steps is serial, so each is bound by log2(C) adds of latency
// in a row, ~12 and ~9.  On the card's path before these kernels each
// step was a K2 launch and a lane shift of 8 PyTorch kernels, so the
// host's launch rate, not the card, set their pace (~197 launches a
// window).  Here each reduction is one launch: the steps run back to back
// on the card, with the order of adds, and so the words, of the JAX loops.
//
// lane_suffix_scan: out[c] = sum_{c' > c} u[c'] (exclusive), Hillis-Steele.
// wk_0[c] = u[c + 1]; step i: wk_{i+1}[c] = wk_i[c] + wk_i[c + 2^i], with
// infinity past the end (an add of infinity keeps the words, so those
// lanes skip it).  One thread per lane, the steps separated by a grid-wide
// barrier: a cooperative launch (cudaLaunchCooperativeKernel), which the
// runtime refuses unless every block is resident at once (32 blocks at
// C = 4096).  The steps ping-pong between two (4, W, C) scratch buffers
// that the wrapper allocates (512 KB at C = 4096: they stay in L2).
//
// lane_fold: the sum of a power-of-two lane axis, lane 0 of the fixed-width
// fold acc[c] += acc[c + C / 2^(i+1)].  Lane 0 depends only on the lanes
// below the half at every step, so one block of C / 2 threads computes
// exactly those, the first step from device memory and the rest through
// shared memory (32 KB at C = 512), with the same pairs in the same order.
// The sum's W words go out ostride apart, so the MSM writes each window's
// sum straight into column k of the (W, nwin) array that Horner reads.
//
// Both take an optional bias point nd (one point, null pointers for none),
// the MSM window's blind adds of tachyon_tpu/math/msm.py:340-344 and :363,
// each a K2 launch over the lanes before: the scan runs on u[c] + nd and
// writes wk[c] + nd, the fold adds nd to every lane at its first load.  In
// the scan each thread adds nd to its own lane into the scratch buffer the
// first step reads, behind one more grid barrier, so the u values cost one
// add of latency, not two (on the H100, 0.119 against 0.126 ms at C = 4096
// for each thread adding nd to both lanes it reads; PERF.md); nd is the
// second operand, as in JAX.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xyzz.cuh"

namespace cg = cooperative_groups;

constexpr int SCAN_THREADS = 128;
// C / 2 at most: at the fold's 186 registers a block of 512 would need
// 95k of the SM's 64k.  Its shared memory, 4 W FOLD_THREADS words, is
// 48 KiB at W = 12 (BLS12-381), the static limit; 256 threads at ptxas's
// 255 registers fit the 64k register file.
constexpr int FOLD_THREADS = 256;

template <int W>
__device__ __forceinline__ void lanes_load(Xyzz<W>& p, const uint32_t* base, int64_t C,
                                           int64_t c) {
  xyzz_load<W>(p, base, base + W * C, base + 2 * W * C, base + 3 * W * C, C, c);
}

template <int W>
__device__ __forceinline__ void lanes_store(uint32_t* base, int64_t C, int64_t c,
                                            const Xyzz<W>& p) {
  xyzz_store<W>(base, base + W * C, base + 2 * W * C, base + 3 * W * C, C, c, p);
}

// The bias point nd, or false when its pointers are null (one (W,) array a
// coordinate).
template <int W>
__device__ __forceinline__ bool bias_load(Xyzz<W>& nd, const uint32_t* bx, const uint32_t* by,
                                          const uint32_t* bzz, const uint32_t* bzzz) {
  if (bx == nullptr) return false;
  xyzz_load<W>(nd, bx, by, bzz, bzzz, 1, 0);
  return true;
}

// Lane k of a 4 x (W, C) input, plus nd when biased (the fold's loads).
template <int W, bool SPARE>
__device__ __forceinline__ void lane_in(Xyzz<W>& a, const uint32_t* x, const uint32_t* y,
                                        const uint32_t* zz, const uint32_t* zzz, int64_t C,
                                        int64_t k, bool biased, const Xyzz<W>& nd,
                                        const FieldConst<W, SPARE>& f) {
  xyzz_load<W>(a, x, y, zz, zzz, C, k);
  if (biased) a = xyzz_add<W, SPARE>(a, nd, f);
}

// u and out: 4 x (W, C); buf: (2, 4, W, C) scratch; b*: the bias or null.
// With a bias, u is redirected into buf, so it is not __restrict__.
template <int W, bool SPARE>
__global__ void __launch_bounds__(SCAN_THREADS)
    lane_suffix_scan_kernel(const uint32_t* ux, const uint32_t* uy, const uint32_t* uzz,
                            const uint32_t* uzzz, const uint32_t* bx, const uint32_t* by,
                            const uint32_t* bzz, const uint32_t* bzzz, uint32_t* buf,
                            uint32_t* ox, uint32_t* oy, uint32_t* ozz, uint32_t* ozzz,
                            int64_t C, int steps, FieldConst<W, SPARE> f) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < C;
  Xyzz<W> a, nd;
  const bool biased = bias_load<W>(nd, bx, by, bzz, bzzz);
  if (biased) {
    // u + nd into buf[1], which step 0 reads while it writes buf[0]
    uint32_t* ub = buf + 4 * W * C;
    if (live) {
      xyzz_load<W>(a, ux, uy, uzz, uzzz, C, c);
      lanes_store<W>(ub, C, c, xyzz_add<W, SPARE>(a, nd, f));
    }
    cg::this_grid().sync();
    ux = ub;
    uy = ub + W * C;
    uzz = ub + 2 * W * C;
    uzzz = ub + 3 * W * C;
  }
  if (live) {
    if (c + 1 < C) {
      xyzz_load<W>(a, ux, uy, uzz, uzzz, C, c + 1);
    } else {
      fp_zero<W>(a.x);
      fp_zero<W>(a.y);
      fp_zero<W>(a.zz);
      fp_zero<W>(a.zzz);
    }
  }
  for (int i = 0; i < steps; ++i) {
    // wk_i[c + 2^i]: u[c + 2] at step 0, else the buffer step i - 1 wrote
    const int64_t k = c + ((int64_t)1 << i) + (i == 0);
    if (live && k < C) {
      Xyzz<W> b;
      if (i == 0) {
        xyzz_load<W>(b, ux, uy, uzz, uzzz, C, k);
      } else {
        lanes_load<W>(b, buf + ((i - 1) & 1) * 4 * W * C, C, k);
      }
      a = xyzz_add<W, SPARE>(a, b, f);
    }
    if (i + 1 < steps) {
      if (live) lanes_store<W>(buf + (i & 1) * 4 * W * C, C, c, a);
      cg::this_grid().sync();
    }
  }
  if (live) {
    if (biased) a = xyzz_add<W, SPARE>(a, nd, f);
    xyzz_store<W>(ox, oy, ozz, ozzz, C, c, a);
  }
}

// p: 4 x (W, C) with C a power of two, 1 <= C <= 2 FOLD_THREADS; one block
// of max(C / 2, 1) threads; b*: the bias or null; out: 4 x W words, word i
// at o[i * ostride].
template <int W, bool SPARE>
__global__ void __launch_bounds__(FOLD_THREADS)
    lane_fold_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                     const uint32_t* __restrict__ pzz, const uint32_t* __restrict__ pzzz,
                     const uint32_t* bx, const uint32_t* by, const uint32_t* bzz,
                     const uint32_t* bzzz, uint32_t* ox, uint32_t* oy, uint32_t* ozz,
                     uint32_t* ozzz, int64_t ostride, int64_t C, FieldConst<W, SPARE> f) {
  __shared__ uint32_t sh[4 * W * FOLD_THREADS];
  const int t = threadIdx.x, half = (int)(C / 2);
  Xyzz<W> a, b, nd;
  const bool biased = bias_load<W>(nd, bx, by, bzz, bzzz);
  lane_in<W, SPARE>(a, px, py, pzz, pzzz, C, t, biased, nd, f);
  if (half > 0) {
    lane_in<W, SPARE>(b, px, py, pzz, pzzz, C, t + half, biased, nd, f);
    a = xyzz_add<W, SPARE>(a, b, f);
  }
  for (int h = half / 2; h >= 1; h /= 2) {
    if (t >= h && t < 2 * h) lanes_store<W>(sh, FOLD_THREADS, t, a);
    __syncthreads();
    if (t < h) {
      lanes_load<W>(b, sh, FOLD_THREADS, t + h);
      a = xyzz_add<W, SPARE>(a, b, f);
    }
    __syncthreads();
  }
  if (t == 0) xyzz_store<W>(ox, oy, ozz, ozzz, ostride, 0, a);
}

static int bit_length(int64_t v) {
  int n = 0;
  while (v > 0) {
    ++n;
    v >>= 1;
  }
  return n;
}

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

extern "C" cudaError_t tt_lane_suffix_scan(const void* ux, const void* uy, const void* uzz,
                                           const void* uzzz, const void* bx, const void* by,
                                           const void* bzz, const void* bzzz, void* buf,
                                           void* ox, void* oy, void* ozz, void* ozzz, int64_t C,
                                           const uint32_t* consts, int W, void* stream) {
  if (C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((C + SCAN_THREADS - 1) / SCAN_THREADS);
  int steps = bit_length(C - 1);
  const uint32_t *ux_ = U32C(ux), *uy_ = U32C(uy), *uzz_ = U32C(uzz), *uzzz_ = U32C(uzzz);
  const uint32_t *bx_ = U32C(bx), *by_ = U32C(by), *bzz_ = U32C(bzz), *bzzz_ = U32C(bzzz);
  uint32_t *buf_ = U32(buf), *ox_ = U32(ox), *oy_ = U32(oy), *ozz_ = U32(ozz), *ozzz_ = U32(ozzz);
  TT_DISPATCH(W, consts, [&] {
    FieldConst<kW, kS> f = load_consts<kW, kS>(consts);
    void* args[] = {&ux_, &uy_, &uzz_, &uzzz_, &bx_, &by_, &bzz_, &bzzz_, &buf_,
                    &ox_, &oy_,  &ozz_, &ozzz_, &C,     &steps, &f};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)lane_suffix_scan_kernel<kW, kS>,
                                                  dim3(blocks), dim3(SCAN_THREADS), args, 0, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  });
}

extern "C" cudaError_t tt_lane_fold(const void* px, const void* py, const void* pzz,
                                    const void* pzzz, const void* bx, const void* by,
                                    const void* bzz, const void* bzzz, void* ox, void* oy,
                                    void* ozz, void* ozzz, int64_t ostride, int64_t C,
                                    const uint32_t* consts, int W, void* stream) {
  if (C < 1 || C > 2 * FOLD_THREADS || (C & (C - 1)) != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    lane_fold_kernel<kW, kS><<<1, (unsigned)(C > 1 ? C / 2 : 1), 0, s>>>(
        U32C(px), U32C(py), U32C(pzz), U32C(pzzz), U32C(bx), U32C(by), U32C(bzz), U32C(bzzz),
        U32(ox), U32(oy), U32(ozz), U32(ozzz), ostride, C, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
