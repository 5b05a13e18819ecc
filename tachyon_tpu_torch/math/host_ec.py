"""Exact Python-int short-Weierstrass arithmetic on the host (no torch, no jax).

The port's counterpart of the JAX package's test helpers
(``tests/test_ec.py`` ``py_add``/``py_mul``, ``math/msm.py``
``_host_point_mul``/``msm_host_reference``): affine add, scalar multiple,
an exact MSM, the MSM of a tiled point set (what ``chip_smoke.py`` checks
the 2^22 MSM and the 2^18 G2 MSM against), and the blind-point derivation
of the sweeps (any a = 0 curve: bls12_381 G1 takes the JAX package's
draws, as bn254 G1 does);
and the G2 add, scalar multiple and MSM that KZG's ``verify`` and the
Groth16 provers take (the JAX package's ``zk/groth16/r1cs.py``
``g2_add``/``g2_mul``), over the Fq2 of a pairing module: BN254's by
default, ``pairing_bls12_381`` for the bls12_381 family.
A point is an ``(x, y)`` tuple of ints (of Fq2 pairs for G2), or None for
infinity.
"""
from __future__ import annotations

import numpy as np

from tachyon_tpu_torch.math import pairing_bn254 as pairing

BLIND_SEED = b"tachyon-tpu-msm-blind-0001"  # the JAX package's _blind_points seed


def affine_add(p, q, a: int, mod: int):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % mod == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def scalar_mul(p, k: int, a: int, mod: int):
    """[k]P by double-and-add."""
    acc, add = None, p
    while k:
        if k & 1:
            acc = affine_add(acc, add, a, mod)
        add = affine_add(add, add, a, mod)
        k >>= 1
    return acc


def _shared_msm(points, scalars, add):
    """Exact sum_i [s_i] P_i (s_i >= 0, None points skipped) with one
    doubling chain for all points, MSB first: a doubling a bit and an add
    a set bit (about a third of the adds of one double-and-add a point)."""
    pairs = [(pt, int(s)) for pt, s in zip(points, scalars) if pt is not None and int(s)]
    acc = None
    for b in range(max((s.bit_length() for _, s in pairs), default=0) - 1, -1, -1):
        acc = add(acc, acc)
        for pt, s in pairs:
            if s >> b & 1:
                acc = add(acc, pt)
    return acc


def _jac_dbl(p, a: int, mod: int):
    """2P of a Jacobian point (X, Y, Z), x = X / Z^2, y = Y / Z^3 (None at
    infinity)."""
    if p is None or p[1] == 0:
        return None
    x, y, z = p
    yy = y * y % mod
    s = 4 * x * yy % mod
    m = (3 * x * x + a * pow(z, 4, mod)) % mod
    x3 = (m * m - 2 * s) % mod
    return x3, (m * (s - x3) - 8 * yy * yy) % mod, 2 * y * z % mod


def _jac_madd(p, q, a: int, mod: int):
    """Jacobian P (None at infinity) plus affine Q."""
    if p is None:
        return q[0], q[1], 1
    x, y, z = p
    zz = z * z % mod
    h = (q[0] * zz - x) % mod
    r = (q[1] * zz * z - y) % mod
    if h == 0:
        return _jac_dbl(p, a, mod) if r == 0 else None
    hh = h * h % mod
    hhh, v = h * hh % mod, x * hh % mod
    x3 = (r * r - hhh - 2 * v) % mod
    return x3, (r * (v - x3) - y * hhh) % mod, z * h % mod


def msm(points, scalars, a: int, mod: int):
    """Exact sum_i [s_i] P_i (points may hold None for infinity): the shared
    chain in Jacobian coordinates, with one inversion at the end where an
    affine add takes one each."""
    acc = _shared_msm(points, scalars, lambda p, q: _jac_dbl(p, a, mod) if q is p
                      else _jac_madd(p, q, a, mod))
    if acc is None:
        return None
    zi = pow(acc[2], -1, mod)
    return acc[0] * zi * zi % mod, acc[1] * zi * zi * zi % mod


def tiled_scalar(ks, scalar_limbs: np.ndarray, order: int) -> int:
    """The scalar k_total = sum_j ks[j] * (sum_{i = j mod m} s_i) mod order of
    an MSM of points P_i = [ks[i mod m]] G with 16-bit-limb scalars (Ls, n),
    n a multiple of m = len(ks): the MSM is [k_total] G.  Per-class limb
    sums in numpy: milliseconds at n = 2^22."""
    m = len(ks)
    Ls, n = scalar_limbs.shape
    sums = scalar_limbs.reshape(Ls, n // m, m).sum(axis=1, dtype=np.uint64)
    k_total = 0
    for j in range(m):
        s_j = sum(int(sums[l, j]) << (16 * l) for l in range(Ls))
        k_total += int(ks[j]) * s_j
    return k_total % order


def msm_tiled(gen, ks, scalar_limbs: np.ndarray, a: int, mod: int, order: int):
    """MSM of points P_i = [ks[i mod m]] G with 16-bit-limb scalars: one
    scalar multiple of G (``tiled_scalar``)."""
    return scalar_mul(gen, tiled_scalar(ks, scalar_limbs, order), a, mod)


def blind_points(gen, a: int, mod: int, order: int):
    """The two sweep blind points [k]G, k from the same seeded generator as
    the JAX package's ``_blind_points`` (so both packages blind alike)."""
    rng = np.random.default_rng(np.frombuffer(BLIND_SEED, dtype=np.uint8))
    pts = []
    for _ in range(2):
        k = int.from_bytes(rng.bytes(40), "little") % order
        pts.append(scalar_mul(gen, k, a, mod))
    return pts


def g2_add(p, q, f=pairing):
    """Affine add on G2 (coordinates in the Fq2 of the pairing module f)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and f.f2_add(y1, y2) == (0, 0):
        return None
    if p == q:
        lam = f.f2_mul(f.f2_muls(f.f2_sq(x1), 3), f.f2_inv(f.f2_muls(y1, 2)))
    else:
        lam = f.f2_mul(f.f2_sub(y2, y1), f.f2_inv(f.f2_sub(x2, x1)))
    x3 = f.f2_sub(f.f2_sub(f.f2_sq(lam), x1), x2)
    return (x3, f.f2_sub(f.f2_mul(lam, f.f2_sub(x1, x3)), y1))


def g2_mul(p, k: int, f=pairing):
    """[k]P on G2 (over the pairing module f's Fq2) by double-and-add."""
    acc, add = None, p
    while k:
        if k & 1:
            acc = g2_add(acc, add, f)
        add = g2_add(add, add, f)
        k >>= 1
    return acc


def g2_msm(points, scalars, f=pairing):
    """Exact sum_i [s_i] P_i on G2 over the pairing module f's Fq2
    (points may hold None)."""
    return _shared_msm(points, scalars, lambda p, q: g2_add(p, q, f))
