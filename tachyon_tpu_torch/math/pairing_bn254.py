"""BN254 optimal ate pairing — exact host-side implementation (python ints).

The port's own copy of ``tachyon_tpu/math/pairing_bn254.py`` (host ints,
no torch), for ``crypto/kzg.verify``.

TPU-native analog of the reference's pairing layer
(reference: tachyon/math/elliptic_curves/pairing/pairing.h, bn/bn_curve.h).
The pairing only runs in Groth16 *verification* (4 pairings per proof), so a
host implementation is the right engineering choice; the prover's MSMs/FFTs
stay on TPU.  Verified by bilinearity tests against the curve generators.
"""
from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x: p(x) = 36x^4 + 36x^3 + 24x^2 + 6x + 1
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2


# ---- Fq2 = Fq[u]/(u^2+1): represented as (a, b) = a + b u --------------------
def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def f2_mul(x, y):
    a = x[0] * y[0] % P
    b = x[1] * y[1] % P
    c = (x[0] + x[1]) * (y[0] + y[1]) % P
    return ((a - b) % P, (c - a - b) % P)


def f2_sq(x):
    return f2_mul(x, x)


def f2_muls(x, s):
    return (x[0] * s % P, x[1] * s % P)


def f2_inv(x):
    norm = (x[0] * x[0] + x[1] * x[1]) % P
    ninv = pow(norm, P - 2, P)
    return (x[0] * ninv % P, (-x[1]) * ninv % P)


def f2_conj(x):
    return (x[0], (-x[1]) % P)


F2_ONE = (1, 0)
F2_ZERO = (0, 0)
XI = (9, 1)  # Fq6 non-residue xi = 9 + u


# ---- Fq6 = Fq2[v]/(v^3 - xi): (c0, c1, c2) ----------------------------------
def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    v0, v1, v2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(v0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(v1, v2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(v0, v1)), f2_mul(XI, v2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(v0, v2)), v1)
    return (c0, c1, c2)


def f6_sq(x):
    return f6_mul(x, x)


def f6_mul_by_xi(x):
    # multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)
    return (f2_mul(XI, x[2]), x[0], x[1])


def f6_inv(x):
    a0, a1, a2 = x
    t0, t1, t2 = f2_sq(a0), f2_sq(a1), f2_sq(a2)
    t3, t4, t5 = f2_mul(a0, a1), f2_mul(a0, a2), f2_mul(a1, a2)
    c0 = f2_sub(t0, f2_mul(XI, t5))
    c1 = f2_sub(f2_mul(XI, t2), t3)
    c2 = f2_sub(t1, t4)
    norm = f2_add(f2_mul(a0, c0), f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))))
    ninv = f2_inv(norm)
    return (f2_mul(c0, ninv), f2_mul(c1, ninv), f2_mul(c2, ninv))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


# ---- Fq12 = Fq6[w]/(w^2 - v): (c0, c1) ---------------------------------------
def f12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    v0 = f6_mul(a0, b0)
    v1 = f6_mul(a1, b1)
    c0 = f6_add(v0, f6_mul_by_xi(v1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), v0), v1)
    return (c0, c1)


def f12_sq(x):
    return f12_mul(x, x)


def f12_inv(x):
    a0, a1 = x
    norm = f6_sub(f6_sq(a0), f6_mul_by_xi(f6_sq(a1)))
    ninv = f6_inv(norm)
    return (f6_mul(a0, ninv), f6_neg(f6_mul(a1, ninv)))


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_pow(x, e):
    out = F12_ONE
    for bit in bin(e)[2:]:
        out = f12_sq(out)
        if bit == "1":
            out = f12_mul(out, x)
    return out


F12_ONE = (F6_ONE, F6_ZERO)


# Frobenius coefficients for Fq2 coefficients of Fq6/Fq12 (gamma values)
def _frob_coeffs():
    # xi^((p^k - 1) / 6) etc., computed once
    # Fq2 frobenius: conj. Fq6: c1 *= xi^((p-1)/3), c2 *= xi^((2p-2)/3) ...
    def xi_pow(e_num, e_den, k):
        # xi^((p^k - 1) * e_num / e_den) in Fq2 via exponent arithmetic
        e = (P**k - 1) * e_num // e_den
        # compute xi^e in Fq2 by square-multiply
        out = F2_ONE
        base = XI
        while e:
            if e & 1:
                out = f2_mul(out, base)
            base = f2_sq(base)
            e >>= 1
        return out

    g6_1 = [xi_pow(j, 3, 1) for j in range(3)]  # for Fq6 frob^1 on c_j
    g12_1 = xi_pow(1, 6, 1)  # for Fq12 frob^1 on the w coefficient
    return g6_1, g12_1


_G6_1, _G12_1 = _frob_coeffs()


def f6_frob(x):
    return tuple(f2_mul(f2_conj(c), _G6_1[j]) for j, c in enumerate(x))


def f12_frob(x):
    c0 = f6_frob(x[0])
    c1 = f6_frob(x[1])
    c1 = tuple(f2_mul(c, _G12_1) for c in c1)
    return (c0, c1)


# ---- G2 (twist) point ops over Fq2, Jacobian not needed: use affine ----------
def g2_neg(q):
    return (q[0], f2_neg(q[1]))


def _line_double(q, p):
    """Doubling step: returns (2q, line_eval at p). q affine Fq2, p affine Fq.

    Line evaluated in Fq12 sparse form (we build the full Fq12 element).
    """
    x, y = q
    # lambda = 3x^2 / 2y
    lam = f2_mul(f2_muls(f2_sq(x), 3), f2_inv(f2_muls(y, 2)))
    x3 = f2_sub(f2_sq(lam), f2_muls(x, 2))
    y3 = f2_sub(f2_mul(lam, f2_sub(x, x3)), y)
    # line: l(P) = (-lam * xp, yp, lam*x - y) in twisted coordinates
    return (x3, y3), _line_eval(lam, q, p)


def _line_add(q1, q2, p):
    """Addition step: q1 + q2 and line through them evaluated at p."""
    x1, y1 = q1
    x2, y2 = q2
    lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3), _line_eval(lam, q1, p)


def _line_eval(lam, q, p):
    """l(P) for line with slope lam through q (on twist): embed into Fq12.

    Using D-twist embedding (arkworks/halo2 convention for BN254):
    line = yp - lam * xp * w + (lam*xq - yq) * w^3 ... we use the standard
    sparse element: c0 = (yp scaled), via coefficients in Fq12 basis
    1, w, w^2, w^3=v, ...: Fq12 = Fq6[w], Fq6 = Fq2[v], w^2 = v.
    Sparse line for BN254 (twist type M? D?): we use:
      l = (yp)*1  +  (-lam*xp)*w  +  (lam*xq - yq)*w^3
    w^3 = v*w, so in (c0=(a0,a1,a2), c1=(b0,b1,b2)) coords:
      c0 = ((yp,0), 0, 0);  c1 = ((-lam*xp..)?, ...)
    We place: c1.b0 = -lam*xp (as Fq2 scalar mult of xp in Fq),
              c1.b1 = lam*xq - yq.
    """
    xp, yp = p
    t1 = f2_muls(f2_neg(lam), xp)  # Fq2 * scalar xp
    t2 = f2_sub(f2_mul(lam, q[0]), q[1])
    c0 = ((yp % P, 0), F2_ZERO, F2_ZERO)
    c1 = (t1, t2, F2_ZERO)
    return (c0, c1)


def miller_loop(p, q):
    """p: G1 affine (x, y) ints; q: G2 affine ((x0,x1),(y0,y1))."""
    if p is None or q is None:
        return F12_ONE
    t = q
    f = F12_ONE
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip leading 1
    for b in bits:
        f = f12_sq(f)
        t, l = _line_double(t, p)
        f = f12_mul(f, l)
        if b == "1":
            t, l = _line_add(t, q, p)
            f = f12_mul(f, l)
    # frobenius end steps: q1 = pi(q), q2 = -pi^2(q)
    q1 = (
        f2_mul(f2_conj(q[0]), _FROB_TWIST_X),
        f2_mul(f2_conj(q[1]), _FROB_TWIST_Y),
    )
    q2x = f2_mul(f2_conj(q1[0]), _FROB_TWIST_X)
    q2y = f2_mul(f2_conj(q1[1]), _FROB_TWIST_Y)
    q2 = (q2x, f2_neg(q2y))
    t, l = _line_add(t, q1, p)
    f = f12_mul(f, l)
    _, l = _line_add(t, q2, p)
    f = f12_mul(f, l)
    return f


def _twist_frob_coeffs():
    e_x = (P - 1) // 3
    e_y = (P - 1) // 2

    def xi_pow(e):
        out = F2_ONE
        base = XI
        while e:
            if e & 1:
                out = f2_mul(out, base)
            base = f2_sq(base)
            e >>= 1
        return out

    return xi_pow(e_x), xi_pow(e_y)


_FROB_TWIST_X, _FROB_TWIST_Y = _twist_frob_coeffs()


def final_exponentiation(f):
    """f^((p^12 - 1) / r)."""
    # easy part: f^(p^6 - 1) * ... = (conj(f) * f^-1)^(p^2 + 1)
    f1 = f12_conj(f)
    f2 = f12_inv(f)
    r = f12_mul(f1, f2)  # f^(p^6 - 1)
    r = f12_mul(f12_frob(f12_frob(r)), r)  # ^(p^2 + 1)
    # hard part: exponent (p^4 - p^2 + 1)/r — do it the straightforward way
    e = (P**4 - P**2 + 1) // R
    return f12_pow(r, e)


def pairing(p, q):
    """Full pairing e(p, q) -> Fq12 element."""
    return final_exponentiation(miller_loop(p, q))


def pairing_product_is_one(pairs) -> bool:
    """prod e(p_i, q_i) == 1 (single shared final exponentiation)."""
    f = F12_ONE
    for (p, q) in pairs:
        f = f12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == F12_ONE
