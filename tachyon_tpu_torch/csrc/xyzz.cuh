// XYZZ point formulas (short Weierstrass, a = 0) for one point per thread.
//
// Port of the bodies in tachyon_tpu/ops/pallas_ec.py (_dbl_body, _add_body,
// _madd_body) and tachyon_tpu/ops/pallas_msm.py (_madd_blinded, _add_blinded), with the
// same formulas and the same order of case selection, so that results are
// bit-identical to the JAX package's.  Infinity is zz == 0 (all-zero
// coordinates).  Every formula that multiplies takes the multiply's form SPARE
// beside W (field.cuh), from the FieldConst<W, SPARE> its kernel was given.
#pragma once

#include "field.cuh"

template <int W>
struct Xyzz {
  uint32_t x[W], y[W], zz[W], zzz[W];
};

template <int W>
__device__ __forceinline__ void xyzz_load(Xyzz<W>& p, const uint32_t* x, const uint32_t* y,
                                          const uint32_t* zz, const uint32_t* zzz, int64_t n,
                                          int64_t k) {
  fp_load<W>(p.x, x, n, k);
  fp_load<W>(p.y, y, n, k);
  fp_load<W>(p.zz, zz, n, k);
  fp_load<W>(p.zzz, zzz, n, k);
}

template <int W>
__device__ __forceinline__ void xyzz_store(uint32_t* x, uint32_t* y, uint32_t* zz, uint32_t* zzz,
                                           int64_t n, int64_t k, const Xyzz<W>& p) {
  fp_store<W>(x, n, k, p.x);
  fp_store<W>(y, n, k, p.y);
  fp_store<W>(zz, n, k, p.zz);
  fp_store<W>(zzz, n, k, p.zzz);
}

template <int W>
__device__ __forceinline__ void xyzz_select(Xyzz<W>& r, bool mask, const Xyzz<W>& a) {
  if (mask) r = a;
}

// dbl-2008-s-1 (a = 0); infinity (zz = 0) propagates through the products.
template <int W, bool SPARE>
__device__ __forceinline__ Xyzz<W> xyzz_dbl(const Xyzz<W>& p, const FieldConst<W, SPARE>& f) {
  uint32_t u[W], v[W], w[W], s[W], x2[W], m[W], t[W];
  Xyzz<W> r;
  fp_dbl<W, SPARE>(u, p.y, f);
  fp_sq<W, SPARE>(v, u, f);
  fp_mul<W, SPARE>(w, u, v, f);
  fp_mul<W, SPARE>(s, p.x, v, f);
  fp_sq<W, SPARE>(x2, p.x, f);
  fp_dbl<W, SPARE>(m, x2, f);
  fp_add<W, SPARE>(m, m, x2, f);  // 3 x^2
  fp_sq<W, SPARE>(r.x, m, f);
  fp_dbl<W, SPARE>(t, s, f);
  fp_sub<W, SPARE>(r.x, r.x, t, f);
  fp_sub<W, SPARE>(t, s, r.x, f);
  fp_mul<W, SPARE>(t, m, t, f);
  fp_mul<W, SPARE>(r.y, w, p.y, f);
  fp_sub<W, SPARE>(r.y, t, r.y, f);
  fp_mul<W, SPARE>(r.zz, v, p.zz, f);
  fp_mul<W, SPARE>(r.zzz, w, p.zzz, f);
  return r;
}

// Shared tail of add-2008-s / madd-2008-s: given u1 (or x), s1 (or y), pp, r
// and the zz/zzz products, x3 = r^2 - ppp - 2 qq, y3 = r (qq - x3) - s1 ppp.
template <int W, bool SPARE>
__device__ __forceinline__ void xyzz_add_tail(Xyzz<W>& o, const uint32_t u1[W],
                                              const uint32_t s1[W], const uint32_t pp[W],
                                              const uint32_t r[W], uint32_t pp2[W],
                                              uint32_t ppp[W], const FieldConst<W, SPARE>& f) {
  uint32_t qq[W], t[W];
  fp_sq<W, SPARE>(pp2, pp, f);
  fp_mul<W, SPARE>(ppp, pp, pp2, f);
  fp_mul<W, SPARE>(qq, u1, pp2, f);
  fp_sq<W, SPARE>(o.x, r, f);
  fp_sub<W, SPARE>(o.x, o.x, ppp, f);
  fp_dbl<W, SPARE>(t, qq, f);
  fp_sub<W, SPARE>(o.x, o.x, t, f);
  fp_sub<W, SPARE>(t, qq, o.x, f);
  fp_mul<W, SPARE>(t, r, t, f);
  fp_mul<W, SPARE>(o.y, s1, ppp, f);
  fp_sub<W, SPARE>(o.y, t, o.y, f);
}

// Complete add-2008-s: P = Q -> dbl, P = -Q -> infinity, infinity inputs pass.
template <int W, bool SPARE>
__device__ __forceinline__ Xyzz<W> xyzz_add(const Xyzz<W>& p, const Xyzz<W>& q,
                                            const FieldConst<W, SPARE>& f) {
  uint32_t u1[W], u2[W], s1[W], s2[W], pp[W], r[W], pp2[W], ppp[W];
  Xyzz<W> o;
  fp_mul<W, SPARE>(u1, p.x, q.zz, f);
  fp_mul<W, SPARE>(u2, q.x, p.zz, f);
  fp_mul<W, SPARE>(s1, p.y, q.zzz, f);
  fp_mul<W, SPARE>(s2, q.y, p.zzz, f);
  fp_sub<W, SPARE>(pp, u2, u1, f);
  fp_sub<W, SPARE>(r, s2, s1, f);
  bool same_x = fp_is_zero<W>(pp);
  bool same_y = fp_is_zero<W>(r);
  xyzz_add_tail<W, SPARE>(o, u1, s1, pp, r, pp2, ppp, f);
  fp_mul<W, SPARE>(o.zz, p.zz, q.zz, f);
  fp_mul<W, SPARE>(o.zz, o.zz, pp2, f);
  fp_mul<W, SPARE>(o.zzz, p.zzz, q.zzz, f);
  fp_mul<W, SPARE>(o.zzz, o.zzz, ppp, f);

  bool p_inf = fp_is_zero<W>(p.zz);
  bool q_inf = fp_is_zero<W>(q.zz);
  bool is_dbl = same_x && same_y && !p_inf && !q_inf;
  bool is_inf = same_x && !same_y && !p_inf && !q_inf;
  if (is_inf) {
    fp_zero<W>(o.x);
    fp_zero<W>(o.y);
    fp_zero<W>(o.zz);
    fp_zero<W>(o.zzz);
  }
  if (is_dbl) o = xyzz_dbl<W, SPARE>(p, f);
  xyzz_select<W>(o, q_inf, p);
  xyzz_select<W>(o, p_inf, q);
  return o;
}

// Complete madd-2008-s (q affine, q_inf its flag).  The selects run in the
// JAX order: P = -Q -> infinity, P = Q -> dbl, q = inf -> p, and last p = inf
// -> q lifted with zz = zzz = mont(1), all-zero when q is infinity as well.
// The double is computed only on the lanes that take it.
template <int W, bool SPARE>
__device__ __forceinline__ Xyzz<W> xyzz_madd(const Xyzz<W>& p, const uint32_t qx[W],
                                             const uint32_t qy[W], bool q_inf,
                                             const FieldConst<W, SPARE>& f) {
  uint32_t u2[W], s2[W], pp[W], r[W], pp2[W], ppp[W];
  Xyzz<W> o;
  fp_mul<W, SPARE>(u2, qx, p.zz, f);
  fp_mul<W, SPARE>(s2, qy, p.zzz, f);
  fp_sub<W, SPARE>(pp, u2, p.x, f);
  fp_sub<W, SPARE>(r, s2, p.y, f);
  bool same_x = fp_is_zero<W>(pp);
  bool same_y = fp_is_zero<W>(r);
  xyzz_add_tail<W, SPARE>(o, p.x, p.y, pp, r, pp2, ppp, f);
  fp_mul<W, SPARE>(o.zz, p.zz, pp2, f);
  fp_mul<W, SPARE>(o.zzz, p.zzz, ppp, f);

  bool p_inf = fp_is_zero<W>(p.zz);
  bool is_dbl = same_x && same_y && !p_inf && !q_inf;
  bool is_inf = same_x && !same_y && !p_inf && !q_inf;
  if (is_inf) {
    fp_zero<W>(o.x);
    fp_zero<W>(o.y);
    fp_zero<W>(o.zz);
    fp_zero<W>(o.zzz);
  }
  if (is_dbl) o = xyzz_dbl<W, SPARE>(p, f);
  if (q_inf) o = p;
  if (p_inf) {
    if (q_inf) {
      fp_zero<W>(o.x);
      fp_zero<W>(o.y);
      fp_zero<W>(o.zz);
      fp_zero<W>(o.zzz);
    } else {
      fp_copy<W>(o.x, qx);
      fp_copy<W>(o.y, qy);
      fp_copy<W>(o.zz, f.one);
      fp_copy<W>(o.zzz, f.one);
    }
  }
  return o;
}

// madd-2008-s without the doubling/infinity branches: the accumulator is
// blinded (starts at a random point D), so it is never infinity and never
// +-Q except with negligible probability.  q_inf lanes keep the accumulator.
template <int W, bool SPARE>
__device__ __forceinline__ void xyzz_madd_blinded(Xyzz<W>& acc, const uint32_t qx[W],
                                                  const uint32_t qy[W], bool q_inf,
                                                  const FieldConst<W, SPARE>& f) {
  if (q_inf) return;
  uint32_t u2[W], s2[W], pp[W], r[W], pp2[W], ppp[W];
  Xyzz<W> o;
  fp_mul<W, SPARE>(u2, qx, acc.zz, f);
  fp_mul<W, SPARE>(s2, qy, acc.zzz, f);
  fp_sub<W, SPARE>(pp, u2, acc.x, f);
  fp_sub<W, SPARE>(r, s2, acc.y, f);
  xyzz_add_tail<W, SPARE>(o, acc.x, acc.y, pp, r, pp2, ppp, f);
  fp_mul<W, SPARE>(o.zz, acc.zz, pp2, f);
  fp_mul<W, SPARE>(o.zzz, acc.zzz, ppp, f);
  acc = o;
}

// add-2008-s with only the q-at-infinity branch (the accumulator is blinded).
template <int W, bool SPARE>
__device__ __forceinline__ void xyzz_add_blinded(Xyzz<W>& acc, const Xyzz<W>& q,
                                                 const FieldConst<W, SPARE>& f) {
  if (fp_is_zero<W>(q.zz)) return;
  uint32_t u1[W], u2[W], s1[W], s2[W], pp[W], r[W], pp2[W], ppp[W];
  Xyzz<W> o;
  fp_mul<W, SPARE>(u1, acc.x, q.zz, f);
  fp_mul<W, SPARE>(u2, q.x, acc.zz, f);
  fp_mul<W, SPARE>(s1, acc.y, q.zzz, f);
  fp_mul<W, SPARE>(s2, q.y, acc.zzz, f);
  fp_sub<W, SPARE>(pp, u2, u1, f);
  fp_sub<W, SPARE>(r, s2, s1, f);
  xyzz_add_tail<W, SPARE>(o, u1, s1, pp, r, pp2, ppp, f);
  fp_mul<W, SPARE>(o.zz, acc.zz, q.zz, f);
  fp_mul<W, SPARE>(o.zz, o.zz, pp2, f);
  fp_mul<W, SPARE>(o.zzz, acc.zzz, q.zzz, f);
  fp_mul<W, SPARE>(o.zzz, o.zzz, ppp, f);
  acc = o;
}
