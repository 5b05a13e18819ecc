// The MSM window's T-gather add: K2's complete add (xyzz_add) at every bucket
// start, with its gathers, its mask and its reshape into K6's rows, in one
// launch.  Replaces, for the MSM window, the K2 Pallas kernel
// (tachyon_tpu/ops/pallas_ec.py _add_call, pl.pallas_call at :209) and the
// XLA glue around it in tachyon_tpu/math/msm.py:348-361: pos -> valid and
// posc, the take of T at (posc % R, posc // R) and of W'' at posc // R, the
// add, the where, the pad to B and the reshape to (R2, C2).
//
// Bucket j in [0, B) (digit j + 1) reads k = pos[j], the first sorted index
// of its digit, and writes
//   out[j / C2, :, j % C2] = T[k % R, :, k / R] + W''[:, k / R]
// with T in the (R, W, C) layout K5 emits and W'' the (W, C) output of the
// biased lane scan; a bucket with k >= n_pad = R C (its digit is absent) and
// the pad bucket j = B - 1 are infinity (all-zero words).  The operands are
// in the JAX order, so the words equal K2's on the gathered points.
//
// Bound: per bucket 14 field multiplies (1904 word products) against 132
// bytes read (its pos and T point; W'' is 128 bytes a lane, read once) and
// 128 written, so at B = 2^17 buckets of generic adds the function is bound
// by multiplies (~15 us on the H100) over bytes (~10 us).  But the T loads
// are scattered: neighbouring buckets mostly share the lane k / R and differ
// in the row, so each of a thread's 32 words lies in its own 32-byte sector
// (chip_smoke.py counts the sectors: ~120 MB of them, ~36 us at the card's
// memory rate if every sector came at that rate).  One thread per bucket
// keeps the point in registers; its stores into K6's rows coalesce (j % C2
// is the lane).
#include <cuda_runtime.h>

#include "xyzz.cuh"

// The bucket kernel asks ptxas for BUCKET_MIN_BLOCKS blocks of
// BUCKET_THREADS per SM: 168 registers and 4 bytes of spills, 3 waves of
// blocks over 2^17 buckets on 132 SMs.  On the H100 it ran 8-9% faster in
// turns than at K2's cap (4 blocks of 128, or 8 of 64: 128 registers, 164
// bytes of spills) and 21% faster than at 5 blocks (96 registers, 500
// bytes); the spills' local loads queue behind the scattered T loads
// (PERF.md).  The cap is per (W, form): on the 64-bit CIOS, at W = 8 on a
// full-width p (secp256k1) and at W = 12 (BLS12-381, 48 words a point),
// one block, ptxas's 255 registers a thread (untuned).
constexpr int BUCKET_THREADS = 128;
template <int W, bool SPARE>
constexpr int BUCKET_MIN_BLOCKS = W == 8 && SPARE ? 3 : 1;

template <int W, bool SPARE>
__global__ void __launch_bounds__(BUCKET_THREADS, BUCKET_MIN_BLOCKS<W, SPARE>)
    bucket_add_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                      const uint32_t* __restrict__ tzz, const uint32_t* __restrict__ tzzz,
                      const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
                      const uint32_t* __restrict__ wzz, const uint32_t* __restrict__ wzzz,
                      const int32_t* __restrict__ pos, uint32_t* ox, uint32_t* oy, uint32_t* ozz,
                      uint32_t* ozzz, int64_t R, int64_t C, int64_t B, int64_t C2,
                      FieldConst<W, SPARE> f) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const int64_t n_pad = R * C;
  const int64_t k = j + 1 < B ? (int64_t)pos[j] : n_pad;
  Xyzz<W> o;
  if (k < n_pad) {
    const int64_t c = k / R, row = (k % R) * W * C;
    Xyzz<W> t, w;
    xyzz_load<W>(t, tx + row, ty + row, tzz + row, tzzz + row, C, c);
    xyzz_load<W>(w, wx, wy, wzz, wzzz, C, c);
    o = xyzz_add<W, SPARE>(t, w, f);
  } else {
    fp_zero<W>(o.x);
    fp_zero<W>(o.y);
    fp_zero<W>(o.zz);
    fp_zero<W>(o.zzz);
  }
  const int64_t orow = (j / C2) * W * C2;
  xyzz_store<W>(ox + orow, oy + orow, ozz + orow, ozzz + orow, C2, j % C2, o);
}

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

// t*: 4 x (R, W, C); w*: 4 x (W, C); pos: (B - 1,) int32 in [0, R C];
// o*: 4 x (B / C2, W, C2).
extern "C" cudaError_t tt_bucket_add(const void* tx, const void* ty, const void* tzz,
                                     const void* tzzz, const void* wx, const void* wy,
                                     const void* wzz, const void* wzzz, const void* pos, void* ox,
                                     void* oy, void* ozz, void* ozzz, int64_t R, int64_t C,
                                     int64_t B, int64_t C2, const uint32_t* consts, int W,
                                     void* stream) {
  if (B < 1 || C2 < 1 || B % C2 != 0) return cudaErrorInvalidValue;
  const int64_t blocks = (B + BUCKET_THREADS - 1) / BUCKET_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    bucket_add_kernel<kW, kS><<<(unsigned)blocks, BUCKET_THREADS, 0, s>>>(
        U32C(tx), U32C(ty), U32C(tzz), U32C(tzzz), U32C(wx), U32C(wy), U32C(wzz), U32C(wzzz),
        (const int32_t*)pos, U32(ox), U32(oy), U32(ozz), U32(ozzz), R, C, B, C2,
        load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
