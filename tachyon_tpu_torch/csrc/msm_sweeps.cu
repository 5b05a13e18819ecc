// K5 (suffix sweep) and K6 (reduce sweep) of the Pippenger bucket phase.
// Replace tachyon_tpu/ops/pallas_msm.py _suffix_sweep_call (pl.pallas_call at
// :147) and _reduce_sweep_call (pl.pallas_call at :201).
// Row-major layouts as in JAX: points (R, W, C), flags (R, 1, C), blinds (W, C).
//
// K5 is bound by integer multiplies: a blinded mixed add is 10 field
// multiplies per live point against 68 bytes read and 128 written.  The TPU
// walks the rows in a sequential grid; one thread per lane with the row loop
// inside it gives only C threads (4096 at 2^22, on 132 SMs), each a serial
// chain of R adds with nothing to hide their latency.  So here a lane's rows
// are cut into S segments of L = ceil(R / S) rows (the top one ragged), and
// the sweep is a two-level suffix scan in three launches:
//
//   1. totals:  thread (s, c), s >= 1, sweeps segment s bottom-up from D with
//               the blinded madd and writes T[s] = D + sum_{r in s} P[r, c];
//   2. carries: one thread per lane, from the top: Cin[S-1] = D, then
//               Cin[s] = (Cin[s+1] + T[s+1]) + (-D) with the complete add,
//               since an empty segment gives T = D and two equal segment sums
//               make the operands equal, cases the blinded add does not take;
//   3. emit:    thread (s, c) sweeps segment s bottom-up from Cin[s] and
//               stores every row.  The accumulator is the same point as in
//               the sequential sweep, so the blinded madd stays safe.
//
// Phases 1 and 3 run S x C threads with c fastest, so a warp's loads of one
// row coalesce.  Phase 1 skips segment 0, whose total nothing reads.  The
// work is about twice the sequential sweep's, in exchange for S times the
// threads; each segment also adds two complete adds to the serial chain of
// phase 2.  The wrapper (ops/cuda_msm.py segments) picks S from R, C, the
// SM count and SWEEP_THREADS, which it reads from tt_suffix_sweep_threads.
// Rows outside the top segment get other XYZZ words than the sequential
// sweep for the same points.
//
// Prefetch: the next row's x, y and flag are loaded into registers before
// the current row's add (a register double buffer).  Chosen over cp.async
// into shared memory because each thread reads its own words, C apart, so
// shared memory would only stage what registers hold anyway, with a fence
// per row.  On the H100 it gained 0-4% over loading each row when its add
// starts: other warps hide most of the loads.  Phases 1 and 3 ask ptxas
// for SWEEP_MIN_BLOCKS = 5 blocks per SM, which caps them at 96 registers
// with 72-88 bytes of spills; they ran 11% faster at (1024, 8, 4096) than
// with the 148-154 registers ptxas takes uncapped (PERF.md).  The cap is
// per (W, form): on the 64-bit CIOS, at W = 8 on a full-width p
// (secp256k1) and at W = 12 (BLS12-381, 48 words a point), they ask for one
// block, ptxas's 255 registers a thread (untuned).
//
// K6 (the reduce sweep, tachyon_tpu/ops/pallas_msm.py _reduce_sweep_call,
// body _add_blinded; JAX twin reduce_sweep_jnp) sums a lane's R XYZZ rows
// from D.  Its work is small (R x C blinded adds: 256 x 512 in the 2^22
// MSM's windows), so on this card it is bound by the latency of one
// thread's chain of adds, not by multiplies or bytes: one thread per lane
// gave C = 512 threads on 132 SMs, each a chain of R adds (~9 us each).
// It is a plain sum, so no row needs a carry in: phase 1 cuts a lane's
// rows into S segments of L = ceil(R / S) (the top one ragged) and thread
// (s, c) sums its segment from D into T[s] = D + partial; phase 2 adds the
// S partials of a lane, T[a] + T[b] + (-D) with the complete add, in a
// tree of ceil(log2 S) levels through shared memory (or, as a rival that
// chip_smoke.py times, a serial chain).  The wrapper (ops/cuda_msm.py
// reduce_segments) picks S; at S = 1 phase 1 alone writes the output, with
// the sequential sweep's words.  For S > 1 the total is the same point in
// other XYZZ words.
#include <cuda_runtime.h>

#include "xyzz.cuh"

constexpr int SWEEP_THREADS = 128;   // phases 1 and 3
template <int W, bool SPARE>
constexpr int SWEEP_MIN_BLOCKS = W == 8 && SPARE ? 5 : 1;  // per SM, asked of ptxas for phases 1, 3
constexpr int CARRY_THREADS = 32;   // phase 2: one warp per block spreads C lanes over SMs
constexpr int REDUCE_THREADS = 128;  // K6 phase 1
constexpr int COMBINE_THREADS = 64;  // K6 phase 2: lanes x F threads per block

// Point k (0..3) of scratch slot j in an (S - 1, 4, W, C) array.
template <int W>
__device__ __forceinline__ const uint32_t* slot(const uint32_t* base, int64_t j, int k,
                                                int64_t C) {
  return base + (j * 4 + k) * W * C;
}

template <int W>
__device__ __forceinline__ void slot_load(Xyzz<W>& p, const uint32_t* base, int64_t j, int64_t C,
                                          int64_t c) {
  xyzz_load<W>(p, slot<W>(base, j, 0, C), slot<W>(base, j, 1, C), slot<W>(base, j, 2, C),
               slot<W>(base, j, 3, C), C, c);
}

template <int W>
__device__ __forceinline__ void slot_store(uint32_t* base, int64_t j, int64_t C, int64_t c,
                                           const Xyzz<W>& p) {
  xyzz_store<W>(base + (j * 4) * W * C, base + (j * 4 + 1) * W * C, base + (j * 4 + 2) * W * C,
                base + (j * 4 + 3) * W * C, C, c, p);
}

template <int W>
__device__ __forceinline__ void row_load(uint32_t qx[W], uint32_t qy[W], bool& qinf,
                                         const uint32_t* __restrict__ x,
                                         const uint32_t* __restrict__ y,
                                         const uint32_t* __restrict__ inf, int64_t r, int64_t C,
                                         int64_t c) {
  fp_load<W>(qx, x + r * W * C, C, c);
  fp_load<W>(qy, y + r * W * C, C, c);
  qinf = inf[r * C + c] != 0;
}

// Blinded madds of rows hi - 1 down to lo of lane c into acc; with EMIT,
// every row's accumulator is stored.  The next row is loaded before the
// current row's add (the last step reloads row lo, which stays in cache).
template <int W, bool SPARE, bool EMIT>
__device__ __forceinline__ void sweep_rows(Xyzz<W>& acc, const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ y,
                                           const uint32_t* __restrict__ inf, uint32_t* sx,
                                           uint32_t* sy, uint32_t* szz, uint32_t* szzz,
                                           int64_t lo, int64_t hi, int64_t C, int64_t c,
                                           const FieldConst<W, SPARE>& f) {
  if (hi <= lo) return;
  uint32_t qx[W], qy[W];
  bool qinf;
  row_load<W>(qx, qy, qinf, x, y, inf, hi - 1, C, c);
  for (int64_t r = hi - 1; r >= lo; --r) {
    uint32_t nx[W], ny[W];
    bool ninf;
    row_load<W>(nx, ny, ninf, x, y, inf, r > lo ? r - 1 : r, C, c);
    xyzz_madd_blinded<W, SPARE>(acc, qx, qy, qinf, f);
    if (EMIT) {
      const int64_t row = r * W * C;
      xyzz_store<W>(sx + row, sy + row, szz + row, szzz + row, C, c, acc);
    }
    fp_copy<W>(qx, nx);
    fp_copy<W>(qy, ny);
    qinf = ninf;
  }
}

// Phase 1: T[s] = D + sum of segment s, for s = 1 .. S - 1, into slot s - 1.
template <int W, bool SPARE>
__global__ void __launch_bounds__(SWEEP_THREADS, SWEEP_MIN_BLOCKS<W, SPARE>)
    suffix_totals_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                         const uint32_t* __restrict__ inf, const uint32_t* __restrict__ dx,
                         const uint32_t* __restrict__ dy, const uint32_t* __restrict__ dzz,
                         const uint32_t* __restrict__ dzzz, uint32_t* tot, int64_t R, int64_t C,
                         int64_t L, int64_t S, FieldConst<W, SPARE> f) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (S - 1) * C) return;
  const int64_t s = t / C + 1, c = t % C;
  Xyzz<W> acc;
  xyzz_load<W>(acc, dx, dy, dzz, dzzz, C, c);
  const int64_t lo = s * L, hi = lo + L < R ? lo + L : R;
  sweep_rows<W, SPARE, false>(acc, x, y, inf, nullptr, nullptr, nullptr, nullptr, lo, hi, C, c, f);
  slot_store<W>(tot, s - 1, C, c, acc);
}

// Phase 2: Cin[s] for s = S - 2 .. 0 into slot s (Cin[S - 1] = D is not stored).
template <int W, bool SPARE>
__global__ void __launch_bounds__(CARRY_THREADS)
    suffix_carries_kernel(const uint32_t* __restrict__ tot, const uint32_t* __restrict__ dx,
                          const uint32_t* __restrict__ dy, const uint32_t* __restrict__ dzz,
                          const uint32_t* __restrict__ dzzz, uint32_t* cin, int64_t C, int64_t S,
                          FieldConst<W, SPARE> f) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Xyzz<W> acc, nd;
  xyzz_load<W>(acc, dx, dy, dzz, dzzz, C, c);
  nd = acc;
  uint32_t zero[W];
  fp_zero<W>(zero);
  fp_sub<W, SPARE>(nd.y, zero, acc.y, f);  // -D
  for (int64_t s = S - 2; s >= 0; --s) {
    Xyzz<W> t;
    slot_load<W>(t, tot, s, C, c);  // T[s + 1]
    acc = xyzz_add<W, SPARE>(acc, t, f);
    acc = xyzz_add<W, SPARE>(acc, nd, f);
    slot_store<W>(cin, s, C, c, acc);
  }
}

// Phase 3: every row of segment s from Cin[s] (D for the top segment).
template <int W, bool SPARE>
__global__ void __launch_bounds__(SWEEP_THREADS, SWEEP_MIN_BLOCKS<W, SPARE>)
    suffix_emit_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ inf, const uint32_t* __restrict__ dx,
                       const uint32_t* __restrict__ dy, const uint32_t* __restrict__ dzz,
                       const uint32_t* __restrict__ dzzz, const uint32_t* __restrict__ cin,
                       uint32_t* sx, uint32_t* sy, uint32_t* szz, uint32_t* szzz, int64_t R,
                       int64_t C, int64_t L, int64_t S, FieldConst<W, SPARE> f) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * C) return;
  const int64_t s = t / C, c = t % C;
  Xyzz<W> acc;
  if (s == S - 1) {
    xyzz_load<W>(acc, dx, dy, dzz, dzzz, C, c);
  } else {
    slot_load<W>(acc, cin, s, C, c);
  }
  const int64_t lo = s * L, hi = lo + L < R ? lo + L : R;
  sweep_rows<W, SPARE, true>(acc, x, y, inf, sx, sy, szz, szzz, lo, hi, C, c, f);
}

// K6, phase 1: thread (s, c), c fastest, T[s] = D + sum of rows
// [s L, min((s + 1) L, R)) of lane c with the blinded add (infinity rows
// skipped), into slot s of tot.  With S = 1, tot is the output.  The next
// row is loaded before the current row's add.
template <int W, bool SPARE>
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_partials_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                           const uint32_t* __restrict__ zz, const uint32_t* __restrict__ zzz,
                           const uint32_t* __restrict__ dx, const uint32_t* __restrict__ dy,
                           const uint32_t* __restrict__ dzz, const uint32_t* __restrict__ dzzz,
                           uint32_t* tot, int64_t R, int64_t C, int64_t L, int64_t S,
                           FieldConst<W, SPARE> f) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * C) return;
  const int64_t s = t / C, c = t % C;
  const int64_t lo = s * L, hi = lo + L < R ? lo + L : R;
  Xyzz<W> acc, q;
  xyzz_load<W>(acc, dx, dy, dzz, dzzz, C, c);
  xyzz_load<W>(q, x + lo * W * C, y + lo * W * C, zz + lo * W * C, zzz + lo * W * C, C, c);
  for (int64_t r = lo; r < hi; ++r) {
    const int64_t row = (r + 1 < hi ? r + 1 : r) * W * C;
    Xyzz<W> nq;
    xyzz_load<W>(nq, x + row, y + row, zz + row, zzz + row, C, c);
    xyzz_add_blinded<W, SPARE>(acc, q, f);
    q = nq;
  }
  slot_store<W>(tot, s, C, c, acc);
}

// K6, phase 2: F threads per lane.  Thread g chains partials
// [g G, min((g + 1) G, S)) serially, u = (u + T[j]) + (-D); then a tree over
// the nG = ceil(S / G) chain results through shared memory,
// u[g] = (u[g] + u[g + h]) + (-D) for g % 2h == 0 and g + h < nG, h = 1, 2, ...
// Every operand is D + a partial sum, so D + sum stays the form of every
// result; the complete add takes the operands that are equal (equal
// partial sums, or two segments all at infinity, T = D).  F = 1 is a
// serial chain of 2 (S - 1) adds; G = 2 a tree of 2 ceil(log2 S) adds.
// A block holds lpb lanes x F threads, lane fastest; the shared memory is
// one point per thread, word-major.
template <int W, bool SPARE>
__global__ void __launch_bounds__(COMBINE_THREADS)
    reduce_combine_kernel(const uint32_t* __restrict__ tot, const uint32_t* __restrict__ dx,
                          const uint32_t* __restrict__ dy, const uint32_t* __restrict__ dzz,
                          const uint32_t* __restrict__ dzzz, uint32_t* out, int64_t C, int64_t S,
                          int64_t G, int F, FieldConst<W, SPARE> f) {
  extern __shared__ uint32_t sh[];  // (4, W, blockDim.x)
  const int n = blockDim.x, lpb = n / F;
  const int g = threadIdx.x / lpb;
  const int64_t c = (int64_t)blockIdx.x * lpb + threadIdx.x % lpb;
  const int64_t nG = (S + G - 1) / G, j0 = g * G;
  const bool live = c < C && g < nG;
  int levels = 0;
  while (((int64_t)1 << levels) < nG) ++levels;
  Xyzz<W> acc, nd;
  if (live) {
    xyzz_load<W>(nd, dx, dy, dzz, dzzz, C, c);
    uint32_t zero[W];
    fp_zero<W>(zero);
    fp_sub<W, SPARE>(nd.y, zero, nd.y, f);  // -D
    slot_load<W>(acc, tot, j0, C, c);
  }
  // Steps 1 .. G - 1 walk the chain, then one step per tree level; a
  // thread adds only where it has an operand.  One add site keeps the
  // kernel's code and registers to those of one complete add pair.
  for (int64_t k = 1; k < G + levels; ++k) {
    Xyzz<W> t;
    bool take;
    if (k < G) {
      take = live && j0 + k < S;
      if (take) slot_load<W>(t, tot, j0 + k, C, c);
    } else {
      const int64_t h = (int64_t)1 << (k - G);
      if (live && g % (2 * h) == h) {
        xyzz_store<W>(sh, sh + W * n, sh + 2 * W * n, sh + 3 * W * n, n, threadIdx.x, acc);
      }
      __syncthreads();
      take = live && g % (2 * h) == 0 && g + h < nG;
      if (take) {
        xyzz_load<W>(t, sh, sh + W * n, sh + 2 * W * n, sh + 3 * W * n, n,
                     threadIdx.x + h * lpb);
      }
      __syncthreads();
    }
    if (take) {
      acc = xyzz_add<W, SPARE>(acc, t, f);
      acc = xyzz_add<W, SPARE>(acc, nd, f);
    }
  }
  if (live && g == 0) xyzz_store<W>(out, out + W * C, out + 2 * W * C, out + 3 * W * C, C, c, acc);
}

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

static unsigned blocks_for(int64_t threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

// Threads per block of phases 1 and 3, for the wrapper's segment count.
extern "C" int tt_suffix_sweep_threads() { return SWEEP_THREADS; }

extern "C" cudaError_t tt_suffix_totals(const void* x, const void* y, const void* inf,
                                        const void* dx, const void* dy, const void* dzz,
                                        const void* dzzz, void* tot, int64_t R, int64_t C,
                                        int64_t L, int64_t S, const uint32_t* consts, int W,
                                        void* stream) {
  if (S < 2) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    suffix_totals_kernel<kW, kS><<<blocks_for((S - 1) * C, SWEEP_THREADS), SWEEP_THREADS, 0, s>>>(
        U32C(x), U32C(y), U32C(inf), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz), U32(tot), R, C,
        L, S, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}

extern "C" cudaError_t tt_suffix_carries(const void* tot, const void* dx, const void* dy,
                                         const void* dzz, const void* dzzz, void* cin, int64_t C,
                                         int64_t S, const uint32_t* consts, int W, void* stream) {
  if (S < 2) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    suffix_carries_kernel<kW, kS><<<blocks_for(C, CARRY_THREADS), CARRY_THREADS, 0, s>>>(
        U32C(tot), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz), U32(cin), C, S,
        load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}

extern "C" cudaError_t tt_suffix_emit(const void* x, const void* y, const void* inf,
                                      const void* dx, const void* dy, const void* dzz,
                                      const void* dzzz, const void* cin, void* sx, void* sy,
                                      void* szz, void* szzz, int64_t R, int64_t C, int64_t L,
                                      int64_t S, const uint32_t* consts, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    suffix_emit_kernel<kW, kS><<<blocks_for(S * C, SWEEP_THREADS), SWEEP_THREADS, 0, s>>>(
        U32C(x), U32C(y), U32C(inf), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz), U32C(cin),
        U32(sx), U32(sy), U32(szz), U32(szzz), R, C, L, S, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}

// Threads per block of K6's phase 1, for the wrapper's segment count.
extern "C" int tt_reduce_sweep_threads() { return REDUCE_THREADS; }

// K6 phase 1 into tot, an (S, 4, W, C) array (the output when S = 1).
extern "C" cudaError_t tt_reduce_partials(const void* x, const void* y, const void* zz,
                                          const void* zzz, const void* dx, const void* dy,
                                          const void* dzz, const void* dzzz, void* tot, int64_t R,
                                          int64_t C, int64_t L, int64_t S, const uint32_t* consts,
                                          int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    reduce_partials_kernel<kW, kS><<<blocks_for(S * C, REDUCE_THREADS), REDUCE_THREADS, 0, s>>>(
        U32C(x), U32C(y), U32C(zz), U32C(zzz), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz),
        U32(tot), R, C, L, S, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}

// Threads per block of K6's phase 2, the most threads per lane it takes.
extern "C" int tt_reduce_combine_threads() { return COMBINE_THREADS; }

// K6 phase 2 into out, a (4, W, C) array: F threads per lane (a power of
// two, at most COMBINE_THREADS), each on a chain of G = ceil(S / F) partials.
extern "C" cudaError_t tt_reduce_combine(const void* tot, const void* dx, const void* dy,
                                         const void* dzz, const void* dzzz, void* out, int64_t C,
                                         int64_t S, int F, const uint32_t* consts, int W,
                                         void* stream) {
  if (F < 1 || F > COMBINE_THREADS || (F & (F - 1)) != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int lpb = COMBINE_THREADS / F, n = lpb * F;
  TT_DISPATCH(W, consts, [&] {
    reduce_combine_kernel<kW, kS><<<blocks_for(C, lpb), n, 4 * kW * n * sizeof(uint32_t), s>>>(
        U32C(tot), U32C(dx), U32C(dy), U32C(dzz), U32C(dzzz), U32(out), C, S, (S + F - 1) / F,
        F, load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
