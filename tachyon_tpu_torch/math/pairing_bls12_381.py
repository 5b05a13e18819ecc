"""BLS12-381 optimal ate pairing — exact host-side implementation.

The port's own copy of ``tachyon_tpu/math/pairing_bls12_381.py`` (host
ints, no torch), for the Groth16 verifier over ``bls12_381``.

Analog of the reference's BLS12-381 pairing instantiation
(reference: tachyon/math/elliptic_curves/pairing/pairing.h,
bls12/bls12_curve.h, bls12/bls12_381/).  Like the BN254 module
(pairing_bn254.py), this runs on host ints: pairings appear only on the
verify side (Groth16/KZG), a handful per proof.

Design: instead of twist-specific sparse line formulas, G2 points are
mapped through the untwist isomorphism into E(Fq12) once and the Miller
loop runs with generic Fq12 affine line functions — simple, obviously
correct, and fast enough for verification workloads.

Tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - (u+1));
Fq12 = Fq6[w]/(w^2 - v).  M-twist E': y^2 = x^3 + 4(u+1);
untwist (x', y') -> (x'/w^2, y'/w^3).
BLS parameter x = -0xd201000000010000 (Miller loop over |x|, conjugate at
the end because x < 0).
"""
from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = 0xD201000000010000  # |x|; x itself is negative


# ---- Fq2 = Fq[u]/(u^2+1) ----------------------------------------------------
def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def f2_mul(x, y):
    a = x[0] * y[0] % P
    b = x[1] * y[1] % P
    t = (x[0] + x[1]) * (y[0] + y[1]) % P
    return ((a - b) % P, (t - a - b) % P)


def f2_sq(x):
    return f2_mul(x, x)


def f2_muls(x, s):
    return (x[0] * s % P, x[1] * s % P)


def f2_inv(x):
    d = pow((x[0] * x[0] + x[1] * x[1]) % P, P - 2, P)
    return (x[0] * d % P, (-x[1]) * d % P)


XI = (1, 1)  # Fq6 non-residue u + 1


def f2_mul_xi(x):
    return ((x[0] - x[1]) % P, (x[0] + x[1]) % P)


# ---- Fq6 = Fq2[v]/(v^3 - xi): triples of Fq2 -------------------------------
F6_ZERO = (((0, 0),) * 3)


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sq(x):
    return f6_mul(x, x)


def f6_mul_v(x):
    return (f2_mul_xi(x[2]), x[0], x[1])


def f6_inv(x):
    a0, a1, a2 = x
    c0 = f2_sub(f2_sq(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))), f2_mul(a0, c0))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


# ---- Fq12 = Fq6[w]/(w^2 - v): pairs of Fq6 ---------------------------------
F12_ONE = ((((1, 0), (0, 0), (0, 0)), ((0, 0), (0, 0), (0, 0))))


def f12_add(x, y):
    return (f6_add(x[0], y[0]), f6_add(x[1], y[1]))


def f12_sub(x, y):
    return (f6_sub(x[0], y[0]), f6_sub(x[1], y[1]))


def f12_mul(x, y):
    a = f6_mul(x[0], y[0])
    b = f6_mul(x[1], y[1])
    t = f6_mul(f6_add(x[0], x[1]), f6_add(y[0], y[1]))
    return (f6_add(a, f6_mul_v(b)), f6_sub(t, f6_add(a, b)))


def f12_sq(x):
    return f12_mul(x, x)


def f12_muls(x, s: int):
    return (
        tuple(f2_muls(c, s) for c in x[0]),
        tuple(f2_muls(c, s) for c in x[1]),
    )


def f12_inv(x):
    d = f6_sub(f6_sq(x[0]), f6_mul_v(f6_sq(x[1])))
    dinv = f6_inv(d)
    return (f6_mul(x[0], dinv), f6_neg(f6_mul(x[1], dinv)))


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_pow(x, e: int):
    r = F12_ONE
    b = x
    while e:
        if e & 1:
            r = f12_mul(r, b)
        b = f12_sq(b)
        e >>= 1
    return r


def f12_frob(x):
    """x^p via coefficient conjugation + per-coefficient xi powers."""
    out = []
    for i, half in enumerate(x):
        row = []
        for j, c in enumerate(half):
            cc = (c[0], (-c[1]) % P)  # Fq2 frobenius: conjugate
            # coefficient of w^(i) v^(j) -> multiply by xi^((p-1)*(3i+... ))
            k = 2 * j + i  # power of w^... : element = sum c_ij v^j w^i; w^(6?)...
            row.append(cc)
        out.append(tuple(row))
    # multiply each (i, j) coefficient by gamma_{2j+i} = (u+1)^((p-1)(2j+i)/6)
    gammas = _frob_gammas()
    res = []
    for i in range(2):
        row = []
        for j in range(3):
            row.append(f2_mul(out[i][j], gammas[2 * j + i]))
        res.append(tuple(row))
    return (res[0], res[1])


def _frob_gammas():
    global _GAMMAS
    try:
        return _GAMMAS
    except NameError:
        pass
    # gamma_k = (u+1)^((p-1) k / 6) in Fq2, k = 0..5
    e = (P - 1) // 6
    base = XI
    gs = []
    for k in range(6):
        g = _f2_pow(base, e * k)
        gs.append(g)
    _GAMMAS = gs
    return gs


def _f2_pow(x, e: int):
    r = (1, 0)
    b = x
    while e:
        if e & 1:
            r = f2_mul(r, b)
        b = f2_sq(b)
        e >>= 1
    return r


# ---- untwist + generic Miller loop ------------------------------------------
def _embed_fq(a: int):
    return (((a % P, 0), (0, 0), (0, 0)), ((0, 0), (0, 0), (0, 0)))


def _embed_fq2_at(c, j: int, i: int):
    """c * v^j * w^i as an Fq12 element."""
    rows = [[(0, 0), (0, 0), (0, 0)], [(0, 0), (0, 0), (0, 0)]]
    rows[i][j] = c
    return (tuple(rows[0]), tuple(rows[1]))


def untwist(q):
    """G2 affine (x', y') over Fq2 -> E(Fq12) affine (x'/w^2, y'/w^3)."""
    x2, y2 = q
    xw = _embed_fq2_at(x2, 0, 0)  # x' as Fq12
    yw = _embed_fq2_at(y2, 0, 0)
    w2 = _embed_fq2_at((1, 0), 1, 0)  # w^2 = v
    w3 = _embed_fq2_at((1, 0), 1, 1)  # w^3 = v w
    return (f12_mul(xw, f12_inv(w2)), f12_mul(yw, f12_inv(w3)))


def _pt_double(t, xp, yp):
    """double T in E(Fq12); return (2T, line_{T,T}(P))."""
    x, y = t
    lam = f12_mul(
        f12_muls(f12_sq(x), 3), f12_inv(f12_muls(y, 2))
    )
    x3 = f12_sub(f12_sq(lam), f12_muls(x, 2))
    y3 = f12_sub(f12_mul(lam, f12_sub(x, x3)), y)
    line = f12_sub(
        f12_sub(_embed_fq(yp), y), f12_mul(lam, f12_sub(_embed_fq(xp), x))
    )
    return (x3, y3), line


def _pt_add(t, q, xp, yp):
    x1, y1 = t
    x2, y2 = q
    lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sq(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    line = f12_sub(
        f12_sub(_embed_fq(yp), y1), f12_mul(lam, f12_sub(_embed_fq(xp), x1))
    )
    return (x3, y3), line


def miller_loop(p, q):
    """p: G1 affine ints (x, y); q: G2 affine Fq2 pairs."""
    xp, yp = p
    qe = untwist(q)
    t = qe
    f = F12_ONE
    bits = bin(BLS_X)[3:]  # skip msb
    for b in bits:
        t, l = _pt_double(t, xp, yp)
        f = f12_mul(f12_sq(f), l)
        if b == "1":
            t, l = _pt_add(t, qe, xp, yp)
            f = f12_mul(f, l)
    # x < 0: f_{x,Q} = conj(f_{|x|,Q}) after final exp; fold in now
    return f12_conj(f)


def final_exponentiation(f):
    # easy part: f^((p^6-1)(p^2+1))
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6 - 1)
    f = f12_mul(f12_frob(f12_frob(f)), f)  # ^(p^2 + 1)
    # hard part: ^((p^4 - p^2 + 1)/r) — generic pow (verify-side cost OK)
    e = (P ** 4 - P ** 2 + 1) // R
    return f12_pow(f, e)


def pairing(p, q):
    """e(P, Q): P in G1 (affine ints or None), Q in G2 (Fq2 pairs or None)."""
    if p is None or q is None:
        return F12_ONE
    return final_exponentiation(miller_loop(p, q))


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 with a single shared final exponentiation."""
    f = F12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == F12_ONE


# ---- G2 generator / scalar ops (host, test support) -------------------------
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or y1 == (0, 0):
            return None
        lam = f2_mul(f2_muls(f2_sq(x1), 3), f2_inv(f2_muls(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k: int):
    acc = None
    add = p
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or y1 == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(p, k: int):
    acc = None
    add = p
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc
