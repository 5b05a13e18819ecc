"""Native R1CS, the Groth16 toxic-waste setup and the Groth16 prover over
BN254 and BLS12-381.

Port of ``tachyon_tpu/zk/groth16/r1cs.py``: build a circuit natively, run
the setup, prove (the witness map's NTTs and the five MSMs on the device)
and verify (the exact host pairing).  A point is an ``(x, y)`` tuple of
ints, a G2 point ``((x0, x1), (y0, y1))``, None at infinity, as in the JAX
package, whose params cross over with ``params_from_jax``.

Where the JAX package works on host ints point by point, the port goes to
the device in bulk:

* ``setup`` keeps every scalar host-exact (u, v, w at tau, the Lagrange
  values, the gamma^-1 and delta^-1 factors) but makes the points on the
  device: all G1 points of the key in one ``scalar_mul`` over a batch of
  the generator (one launch of the fused ladder on the card), all G2 points
  in one generic ``scalar_mul`` over Fq2 (K1 for every base multiply), then
  one ``to_affine`` each and a bulk decode to ints.
* ``prove`` keeps the JAX flow and its ``MSM_HOST_THRESHOLD`` dispatch;
  above it, the A, B1, B2, L and H sums are device MSMs (B1 is a host loop
  of ``g1_mul`` in the JAX package: the same point).  The witness map runs
  on the port's ``Radix2Domain`` with the three polynomials as one batch.
* ``verify`` and ``rerandomize`` are host-exact, over the family's pairing
  module (``math/pairing_bn254``, ``math/pairing_bls12_381``).

Both families of the JAX package are supported: ``bn254`` (Fq of 8 words)
and ``bls12_381`` (Fq of 12 words; the kernels are instantiated for both).
The host point ops take the family's pairing module (BN254's by default).
"""
from __future__ import annotations

import contextlib
import dataclasses
import secrets
from typing import NamedTuple

import numpy as np
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import pairing_bls12_381
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ, SWCurve
from tachyon_tpu_torch.math.msm import msm
from tachyon_tpu_torch.math.ntt import Radix2Domain

# at or below this many points an MSM runs on the host, as in the JAX
# package (tests lower it to send every MSM to the device)
MSM_HOST_THRESHOLD = 1024

CURVE_FAMILIES = {
    "bn254": dict(g1=curves.bn254_g1, g2=curves.bn254_g2, pairing=pairing),
    "bls12_381": dict(g1=curves.bls12_381_g1, g2=curves.bls12_381_g2,
                      pairing=pairing_bls12_381),
}


def _family(name: str) -> dict:
    if name not in CURVE_FAMILIES:
        raise ValueError(f"unknown curve family {name!r}")
    return CURVE_FAMILIES[name]


# --- host exact point ops, over the pairing module f (BN254's by default) ---
def g1_add(p, q, f=pairing):
    return host_ec.affine_add(p, q, 0, f.P)


def g1_mul(p, k: int, f=pairing):
    return host_ec.scalar_mul(p, k, 0, f.P)


def g2_add(p, q, f=pairing):
    return host_ec.g2_add(p, q, f)


def g2_mul(p, k: int, f=pairing):
    return host_ec.g2_mul(p, k, f)


# --- R1CS ---------------------------------------------------------------------
class LinearCombination(dict):
    """var index -> coefficient.  Var 0 is the constant ONE."""


@dataclasses.dataclass
class R1CS:
    """a(w) * b(w) = c(w) constraints over the witness vector
    w = (1, public..., private...)."""

    num_public: int  # public inputs, excluding the leading ONE
    num_private: int = 0
    constraints: list = dataclasses.field(default_factory=list)

    @property
    def num_vars(self) -> int:
        return 1 + self.num_public + self.num_private

    def new_private(self) -> int:
        self.num_private += 1
        return self.num_vars - 1

    def constrain(self, a: dict, b: dict, c: dict):
        """a, b, c: {var: coeff} linear combinations."""
        self.constraints.append(
            (LinearCombination(a), LinearCombination(b), LinearCombination(c)))


class Groth16Proof(NamedTuple):
    a: tuple | None
    b: tuple | None
    c: tuple | None


class Groth16Params(NamedTuple):
    family: str
    r1cs: R1CS
    n: int  # QAP domain size
    # proving key (host int points)
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: list  # [u_j(tau)]_1 per variable
    b1_query: list
    b2_query: list
    l_query: list  # private-var C terms / delta
    h_query: list  # [tau^i Z(tau)/delta]_1
    # verifying key
    gamma2: tuple
    ic: list  # public-var C terms / gamma


def _batch_inv(xs: list, p: int) -> list:
    """Inverses mod p of a list of ints (zeros -> 0), one pow for all."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        if x:
            acc = acc * x % p
    inv = pow(acc, p - 2, p)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i]:
            out[i] = inv * prefix[i] % p
            inv = inv * xs[i] % p
    return out


def _lagrange_at_tau(Fr_p: int, n: int, omega: int, tau: int) -> list[int]:
    """L_i(tau) = Z(tau) * w^i / (n (tau - w^i)) for the radix-2 domain (0
    where tau = w^i, as the JAX package's Fermat inverse of 0 gives), with
    the n denominators inverted in one batch."""
    z_tau = (pow(tau, n, Fr_p) - 1) % Fr_p
    ws, wi = [], 1
    for _ in range(n):
        ws.append(wi)
        wi = wi * omega % Fr_p
    dinv = _batch_inv([n * (tau - w) % Fr_p for w in ws], Fr_p)
    return [z_tau * w % Fr_p * d % Fr_p for w, d in zip(ws, dinv)]


def host_points(curve: SWCurve, aff: AffinePoint) -> list:
    """(..., k) affine device points -> k host points (ints, None at infinity)."""
    F = curve.F
    inf = aff.inf.reshape(-1).tolist()
    if hasattr(F, "D"):
        xs = [c.reshape(-1) for c in F.decode(aff.x)]
        ys = [c.reshape(-1) for c in F.decode(aff.y)]
        return [None if i else ((int(xs[0][k]), int(xs[1][k])), (int(ys[0][k]), int(ys[1][k])))
                for k, i in enumerate(inf)]
    xs, ys = F.decode(aff.x).reshape(-1), F.decode(aff.y).reshape(-1)
    return [None if i else (int(x), int(y)) for x, y, i in zip(xs, ys, inf)]


def host_point(curve: SWCurve, acc: PointXYZZ):
    """One XYZZ device point -> its affine host point (ints, None at infinity)."""
    aff = curve.to_affine(acc)
    return host_points(curve, AffinePoint(aff.x[..., None], aff.y[..., None], aff.inf[None]))[0]


def _generator_multiples(curve: SWCurve, scalars: list) -> list:
    """[s]G for every s as host points: one ``scalar_mul`` over a batch of
    the generator, one ``to_affine``, one decode."""
    SF = curve.SF
    sw = limbs.from_ints([s % SF.p for s in scalars], SF.W, curve.device)
    acc = curve.scalar_mul(curve.generator((len(scalars),)), sw)
    return host_points(curve, curve.to_affine(acc))


def setup(r1cs: R1CS, family: str = "bn254", rng=None,
          device=torch.device("cuda")) -> Groth16Params:
    """Toxic-waste setup (test/dev only: a production SRS comes from a
    ceremony).  ``rng``: a callable giving the five secrets tau, alpha,
    beta, gamma, delta in turn (the JAX package's argument)."""
    fam = _family(family)
    g1c, g2c = fam["g1"](device), fam["g2"](device)
    rp = fam["pairing"].R  # scalar field order
    rand = rng if rng is not None else (lambda: secrets.randbelow(rp - 1) + 1)
    tau, alpha, beta, gamma, delta = (rand() for _ in range(5))

    n = 1
    while n < max(len(r1cs.constraints), 2):
        n *= 2
    omega = Radix2Domain(g1c.SF, n).omega_int
    lag = _lagrange_at_tau(rp, n, omega, tau)

    nv = r1cs.num_vars
    u, v, w = [0] * nv, [0] * nv, [0] * nv  # u_j(tau), v_j(tau), w_j(tau)
    for i, (a, b, c) in enumerate(r1cs.constraints):
        li = lag[i]
        for j, coef in a.items():
            u[j] = (u[j] + coef * li) % rp
        for j, coef in b.items():
            v[j] = (v[j] + coef * li) % rp
        for j, coef in c.items():
            w[j] = (w[j] + coef * li) % rp

    ginv = pow(gamma, rp - 2, rp)
    dinv = pow(delta, rp - 2, rp)
    npub1 = 1 + r1cs.num_public
    k = [(beta * u[j] + alpha * v[j] + w[j]) % rp for j in range(nv)]
    z_tau = (pow(tau, n, rp) - 1) % rp
    h_s, t = [], z_tau * dinv % rp
    for _ in range(n - 1):
        h_s.append(t)
        t = t * tau % rp
    g1_scalars = (u + v + [x * ginv % rp for x in k[:npub1]]
                  + [x * dinv % rp for x in k[npub1:]] + h_s + [alpha, beta, delta])
    g1 = _generator_multiples(g1c, g1_scalars)
    g2 = _generator_multiples(g2c, v + [beta, delta, gamma])
    cut = np.cumsum([nv, nv, npub1, nv - npub1, n - 1]).tolist()
    a_query, b1_query, ic, l_query, h_query = (g1[i:j] for i, j in zip([0] + cut, cut))
    alpha1, beta1, delta1 = g1[cut[-1]:]
    beta2, delta2, gamma2 = g2[nv:]
    return Groth16Params(
        family=family, r1cs=r1cs, n=n,
        alpha1=alpha1, beta1=beta1, beta2=beta2, delta1=delta1, delta2=delta2,
        a_query=a_query, b1_query=b1_query, b2_query=g2[:nv],
        l_query=l_query, h_query=h_query, gamma2=gamma2, ic=ic,
    )


def params_from_jax(pp) -> Groth16Params:
    """The JAX package's ``Groth16Params`` (a NamedTuple of plain Python
    values and its ``R1CS``) over either family rebuilt as the port's, so
    that both packages prove from one key.  Reads attributes only: imports
    nothing; raises on an unknown family."""
    _family(str(pp.family))

    def g1(pt):
        return None if pt is None else (int(pt[0]), int(pt[1]))

    def g2(pt):
        return None if pt is None else tuple((int(c[0]), int(c[1])) for c in pt)

    src = pp.r1cs
    r1cs = R1CS(num_public=int(src.num_public), num_private=int(src.num_private),
                constraints=[tuple(LinearCombination({int(j): int(c) for j, c in lc.items()})
                                   for lc in con) for con in src.constraints])
    return Groth16Params(
        family=str(pp.family), r1cs=r1cs, n=int(pp.n),
        alpha1=g1(pp.alpha1), beta1=g1(pp.beta1), beta2=g2(pp.beta2),
        delta1=g1(pp.delta1), delta2=g2(pp.delta2),
        a_query=[g1(p) for p in pp.a_query], b1_query=[g1(p) for p in pp.b1_query],
        b2_query=[g2(p) for p in pp.b2_query], l_query=[g1(p) for p in pp.l_query],
        h_query=[g1(p) for p in pp.h_query], gamma2=g2(pp.gamma2),
        ic=[g1(p) for p in pp.ic],
    )


def _dev_points(curve: SWCurve, pts: list) -> AffinePoint:
    """Host points -> device AffinePoint ((W, n) coords, (D, W, n) over an
    extension field; zero coordinates at infinity)."""
    F = curve.F
    inf = torch.tensor([p is None for p in pts], dtype=torch.bool, device=curve.device)
    if hasattr(F, "D"):
        zero = (0,) * F.D
        xs = [[(zero if p is None else p[0])[d] for p in pts] for d in range(F.D)]
        ys = [[(zero if p is None else p[1])[d] for p in pts] for d in range(F.D)]
    else:
        xs = [0 if p is None else p[0] for p in pts]
        ys = [0 if p is None else p[1] for p in pts]
    return AffinePoint(F.encode(xs), F.encode(ys), inf)


def _scalar_limbs(Fr, vals: list) -> torch.Tensor:
    """Host scalars -> (Ws, n) plain scalar words on Fr's device."""
    return limbs.from_ints([v % Fr.p for v in vals], Fr.W, Fr.device)


class Groth16:
    """Prover and verifier over a Groth16Params: the witness map on the
    device domain and the 5-MSM prove of the JAX package."""

    def __init__(self, params: Groth16Params, device=torch.device("cuda")):
        self.pp = params
        fam = _family(params.family)
        self.f = fam["pairing"]
        self.g1, self.g2 = fam["g1"](device), fam["g2"](device)
        self.Fr = self.g1.SF
        self.dom = Radix2Domain(self.Fr, params.n)

        def upload(curve, query):
            return _dev_points(curve, query) if len(query) > MSM_HOST_THRESHOLD else None

        self._a_pts = upload(self.g1, params.a_query)
        self._b1_pts = upload(self.g1, params.b1_query)
        self._b2_pts = upload(self.g2, params.b2_query)
        self._l_pts = upload(self.g1, params.l_query)
        self._h_pts = upload(self.g1, params.h_query)

    # --- witness map (QAP) ------------------------------------------------------
    def _h_scalars(self, witness: list[int]) -> list[int]:
        """h coefficients: (A.B - C)/Z evaluated via coset FFTs on the device
        (3 iFFT, 3 coset FFTs, pointwise, the coset iFFT)."""
        Fr, dom, n, rp = self.Fr, self.dom, self.pp.n, self.Fr.p
        rows = np.zeros((3, n), dtype=object)
        for i, con in enumerate(self.pp.r1cs.constraints):
            for k, lc in enumerate(con):
                rows[k, i] = sum(coef * witness[j] for j, coef in lc.items()) % rp
        shift = Fr.spec.generator
        abc = dom.coset_fft(dom.ifft(Fr.encode(rows.T)), shift)  # (W, n, 3)
        a_c, b_c, c_c = abc.unbind(-1)
        q_c = Fr.sub(Fr.mul(a_c, b_c), c_c)
        # divide by Z on the coset: Z(shift w^i) = shift^n - 1 (constant)
        zinv = pow((pow(shift, n, rp) - 1) % rp, rp - 2, rp)
        q_c = Fr.mul(q_c, Fr.full((), zinv)[:, None])
        return [int(v) for v in Fr.decode(dom.coset_ifft(q_c, shift))]

    def _msm_out(self, curve: SWCurve, dev_pts, query: list, scalars: list):
        """sum_j [s_j] query_j as a host point: on the host at or below
        MSM_HOST_THRESHOLD points, else a device MSM and ``to_affine``."""
        if len(query) != len(scalars):
            raise ValueError(f"{len(query)} points vs {len(scalars)} scalars")
        if len(query) <= MSM_HOST_THRESHOLD or dev_pts is None:
            ks = [int(k) % self.f.R for k in scalars]
            if hasattr(curve.F, "D"):
                return host_ec.g2_msm(query, ks, self.f)
            return host_ec.msm(query, ks, 0, self.f.P)
        return host_point(curve, msm(curve, dev_pts, _scalar_limbs(self.Fr, scalars)))

    def prove(self, public: list[int], private: list[int], r: int | None = None,
              s: int | None = None, timer=None) -> Groth16Proof:
        """A proof for the witness (1, public, private); r and s are drawn
        when not given.  ``timer(name)``, when given, is a context manager
        entered around each step (the witness map, each MSM, the host
        combination)."""
        pp, f, rp = self.pp, self.f, self.f.R
        step = timer or (lambda name: contextlib.nullcontext())
        witness = [1] + [v % rp for v in public] + [v % rp for v in private]
        if len(witness) != pp.r1cs.num_vars:
            raise ValueError(f"{len(witness)} witness values for {pp.r1cs.num_vars} variables")
        if r is None:
            r = secrets.randbelow(rp)
        if s is None:
            s = secrets.randbelow(rp)

        with step("witness_map"):
            h = self._h_scalars(witness)
        npub1 = 1 + pp.r1cs.num_public
        priv = witness[npub1:]
        hq = h[:len(pp.h_query)]
        with step("msm_a"):
            a_acc = self._msm_out(self.g1, self._a_pts, pp.a_query, witness)
        with step("msm_b2_g2"):
            b2_acc = self._msm_out(self.g2, self._b2_pts, pp.b2_query, witness)
        with step("msm_b1"):
            b1_acc = self._msm_out(self.g1, self._b1_pts, pp.b1_query, witness)
        with step("msm_l"):
            c_l = self._msm_out(self.g1, self._l_pts, pp.l_query, priv) if priv else None
        with step("msm_h"):
            c_h = self._msm_out(self.g1, self._h_pts, pp.h_query, hq) if hq else None

        with step("host"):
            A = g1_add(a_acc, g1_add(pp.alpha1, g1_mul(pp.delta1, r, f), f), f)
            B = g2_add(b2_acc, g2_add(pp.beta2, g2_mul(pp.delta2, s, f), f), f)
            B1 = g1_add(b1_acc, g1_add(pp.beta1, g1_mul(pp.delta1, s, f), f), f)
            C = g1_add(c_l, c_h, f)
            C = g1_add(C, g1_mul(A, s, f), f)
            C = g1_add(C, g1_mul(B1, r, f), f)
            C = g1_add(C, g1_mul(pp.delta1, (-r * s) % rp, f), f)
        return Groth16Proof(A, B, C)

    def rerandomize(self, proof: Groth16Proof) -> Groth16Proof:
        """Fresh-randomness rerandomization: the same statement, an
        unlinkable proof."""
        f, rp = self.f, self.f.R
        r1 = secrets.randbelow(rp - 1) + 1
        r2 = secrets.randbelow(rp)
        a = g1_mul(proof.a, r1, f)
        b = g2_add(g2_mul(proof.b, pow(r1, rp - 2, rp), f), g2_mul(self.pp.delta2, r2, f), f)
        c = g1_add(proof.c, g1_mul(a, r2, f), f)
        return Groth16Proof(a, b, c)

    def verify(self, proof: Groth16Proof, public: list[int]) -> bool:
        """e(A, B) == e(alpha, beta) e(vk_x, gamma) e(C, delta), on the host."""
        pp, f, rp = self.pp, self.f, self.f.R
        if proof.a is None or proof.b is None:
            return False
        vk_x = pp.ic[0]
        for i, v in enumerate(public):
            vk_x = g1_add(vk_x, g1_mul(pp.ic[i + 1], v % rp, f), f)
        neg_a = (proof.a[0], (-proof.a[1]) % f.P)
        return f.pairing_product_is_one([
            (neg_a, proof.b),
            (pp.alpha1, pp.beta2),
            (vk_x, pp.gamma2),
            (proof.c, pp.delta2),
        ])
