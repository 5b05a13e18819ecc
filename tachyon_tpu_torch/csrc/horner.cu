// Horner's step of the Pippenger MSM in one launch: acc = 2^c acc + win[k]
// for k = nwin - 1 down to 0, from infinity.  Replaces the JAX package's
// Horner loop (tachyon_tpu/math/msm.py:418-428: a fori_loop of c K3
// doublings, tachyon_tpu/ops/pallas_ec.py _dbl_call, pl.pallas_call at
// :232, then one K2 add, _add_call at :209, inside the window scan), which
// launched c + 1 kernels a window on one point.
//
// Bound: neither bytes nor multiplies.  The c * nwin doublings and nwin adds
// are one serial chain (255 doublings and 15 adds at 2^22, c = 17), so the
// floor is one thread's latency through ~2500 field multiplies in a row.
// One thread runs the chain with the point in registers; the c + 1 launches
// a window it replaces each cost more in launch and host issue than their
// work.  xyzz_dbl and xyzz_add are K3's and K2's device functions, in the
// JAX order of operands, so the words equal those of the loop.
#include <cuda_runtime.h>

#include "xyzz.cuh"

// wins: 4 x (W, nwin) window sums, column k = window k; out: 4 x (W,).
template <int W, bool SPARE>
__global__ void __launch_bounds__(1)
    horner_xyzz_kernel(const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
                       const uint32_t* __restrict__ wzz, const uint32_t* __restrict__ wzzz,
                       uint32_t* ox, uint32_t* oy, uint32_t* ozz, uint32_t* ozzz, int64_t nwin,
                       int c, FieldConst<W, SPARE> f) {
  Xyzz<W> acc;
  fp_zero<W>(acc.x);
  fp_zero<W>(acc.y);
  fp_zero<W>(acc.zz);
  fp_zero<W>(acc.zzz);
  for (int64_t k = nwin - 1; k >= 0; --k) {
    for (int i = 0; i < c; ++i) acc = xyzz_dbl<W, SPARE>(acc, f);
    Xyzz<W> w;
    xyzz_load<W>(w, wx, wy, wzz, wzzz, nwin, k);
    acc = xyzz_add<W, SPARE>(acc, w, f);
  }
  xyzz_store<W>(ox, oy, ozz, ozzz, 1, 0, acc);
}

#define U32C(p) ((const uint32_t*)(p))
#define U32(p) ((uint32_t*)(p))

extern "C" cudaError_t tt_horner_xyzz(const void* wx, const void* wy, const void* wzz,
                                      const void* wzzz, void* ox, void* oy, void* ozz, void* ozzz,
                                      int64_t nwin, int c, const uint32_t* consts, int W,
                                      void* stream) {
  if (nwin < 1 || c < 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TT_DISPATCH(W, consts, [&] {
    horner_xyzz_kernel<kW, kS><<<1, 1, 0, s>>>(U32C(wx), U32C(wy), U32C(wzz), U32C(wzzz), U32(ox),
                                            U32(oy), U32(ozz), U32(ozzz), nwin, c,
                                            load_consts<kW, kS>(consts));
    return cudaGetLastError();
  });
}
