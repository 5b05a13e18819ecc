"""SHPlonk (BDFG20) and GWC19 multi-point KZG opening schemes.

Port of ``tachyon_tpu/crypto/multiopen.py`` over the port's ``crypto/kzg.py``
and ``math/poly.py``: the prover's polynomial algebra (evaluations, linear
combinations, the divisions by (X - z)) runs on the params' device (K1 on
the card, the port's add and sub), each commitment is the port's MSM; the
challenges and the verifier's few point combinations are exact host
arithmetic (``math/host_ec.py``, where the JAX package takes its Groth16
prover's ``_py_g1_add``/``_py_g1_mul``; the same points).

Analog of the reference's kzg family
(reference: tachyon/crypto/commitments/kzg/shplonk.h DoCreateOpeningProof/
DoVerifyOpeningProof, gwc.h, polynomial_openings.h).

API: an opening request is (poly_or_commitment, points, values).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tachyon_tpu_torch.crypto import kzg as kzg_mod
from tachyon_tpu_torch.crypto.transcript import TranscriptReader, TranscriptWriter
from tachyon_tpu_torch.math import curves, host_ec, poly as poly_mod
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.ops import mont


class ProverOpening(NamedTuple):
    coeffs: torch.Tensor  # (W, n) Montgomery coefficient form
    points: tuple  # python ints


class VerifierOpening(NamedTuple):
    commitment: tuple | None  # G1 int point
    points: tuple
    values: tuple  # claimed evals, python ints


def _g1_add(p, q):
    return host_ec.affine_add(p, q, 0, pairing.P)


def _g1_mul(p, k: int):
    return host_ec.msm([p], [k], 0, pairing.P)


def _lagrange_interp(points, values, p):
    """host exact Lagrange interpolation -> coefficient list (ints)."""
    k = len(points)
    coeffs = [0] * k
    for i, (xi, yi) in enumerate(zip(points, values)):
        # basis poly: prod_{j!=i} (X - xj) / (xi - xj)
        basis = [1]
        denom = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            denom = denom * (xi - xj) % p
            new = [0] * (len(basis) + 1)
            for t, c in enumerate(basis):
                new[t] = (new[t] - c * xj) % p
                new[t + 1] = (new[t + 1] + c) % p
            basis = new
        scale = yi * pow(denom, p - 2, p) % p
        for t in range(len(basis)):
            coeffs[t] = (coeffs[t] + basis[t] * scale) % p
    return coeffs


def _eval_host(coeffs_ints, x, p):
    acc = 0
    for c in reversed(coeffs_ints):
        acc = (acc * x + c) % p
    return acc


def _vanishing_eval(roots, x, p):
    acc = 1
    for r in roots:
        acc = acc * (x - r) % p
    return acc


def _commit(params, Fr, coeffs):
    std = mont.mont_reduce(Fr.spec, coeffs)
    return kzg_mod.to_int_point(kzg_mod.commit(params, std))


class SHPlonk:
    """reference: shplonk.h:85."""

    def __init__(self, params: kzg_mod.KZGParams):
        self.params = params
        self.Fr = curves.bn254_fr(params.g1_powers.x.device)

    # ---------------------------------------------------------------- prove
    def create_opening_proof(
        self, openings: Sequence[ProverOpening], w: TranscriptWriter
    ):
        Fr = self.Fr
        p = Fr.p
        # group by point set
        groups: dict[tuple, list[int]] = {}
        for i, o in enumerate(openings):
            groups.setdefault(tuple(o.points), []).append(i)
        group_list = list(groups.items())
        super_points = sorted({pt for o in openings for pt in o.points})

        y = w.squeeze_challenge()
        # H_i = sum_j y^j (p_j - R_j) / Z_points
        h_polys = []
        r_polys = []  # per group: list of R_j coefficient int lists
        for points, idxs in group_list:
            acc = None
            rs = []
            for k, idx in enumerate(idxs):
                coeffs = openings[idx].coeffs
                vals = [
                    int(Fr.decode(poly_mod.eval_at_fast(Fr, coeffs, pt)))
                    for pt in points
                ]
                r = _lagrange_interp(list(points), vals, p)
                rs.append(r)
                # term = coeffs - R (R padded)
                term = Fr.sub(coeffs, Fr.encode(r + [0] * (coeffs.shape[1] - len(r))))
                if k > 0:
                    term = Fr.mul(term, Fr.encode(pow(y, k, p))[:, None])
                acc = term if acc is None else Fr.add(acc, term)
            # divide by Z = prod (X - pt); each remainder is 0
            q = acc
            for pt in points:
                q, _rem = poly_mod.divide_by_linear(Fr, q, Fr.encode(pt))
            h_polys.append(q)
            r_polys.append(rs)

        v = w.squeeze_challenge()
        # H = sum v^i H_i
        h = None
        for i, hp in enumerate(h_polys):
            t = hp
            if i > 0:
                t = Fr.mul(t, Fr.encode(pow(v, i, p))[:, None])
            h = t if h is None else poly_mod.add(Fr, h, t)
        w.write_point(_commit(self.params, Fr, h))

        u = w.squeeze_challenge()
        # L = sum_i v^i z_diff_i (sum_j y^j (p_j - R_j(u))) - Z_T(u) H
        l = None
        first_z_diff = None
        for gi, (points, idxs) in enumerate(group_list):
            diffs = [pt for pt in super_points if pt not in points]
            z_diff = _vanishing_eval(diffs, u, p)
            if gi == 0:
                first_z_diff = z_diff
            acc = None
            for k, idx in enumerate(idxs):
                coeffs = openings[idx].coeffs
                ru = _eval_host(r_polys[gi][k], u, p)
                c0 = Fr.encode(ru)
                term = torch.cat([Fr.sub(coeffs[:, :1], c0[:, None]), coeffs[:, 1:]], dim=1)
                if k > 0:
                    term = Fr.mul(term, Fr.encode(pow(y, k, p))[:, None])
                acc = term if acc is None else Fr.add(acc, term)
            scale = pow(v, gi, p) * z_diff % p
            acc = Fr.mul(acc, Fr.encode(scale)[:, None])
            l = acc if l is None else poly_mod.add(Fr, l, acc)
        zt_u = _vanishing_eval(super_points, u, p)
        l = poly_mod.add(Fr, l, Fr.neg(Fr.mul(h, Fr.encode(zt_u)[:, None])))
        # Q = L / (X - u) / first_z_diff
        q, _rem = poly_mod.divide_by_linear(Fr, l, Fr.encode(u))
        inv_fzd = pow(first_z_diff, p - 2, p)
        q = Fr.mul(q, Fr.encode(inv_fzd)[:, None])
        w.write_point(_commit(self.params, Fr, q))

    # ---------------------------------------------------------------- verify
    def verify_opening_proof(
        self, openings: Sequence[VerifierOpening], r: TranscriptReader
    ) -> bool:
        params = self.params
        p = self.Fr.p
        groups: dict[tuple, list[int]] = {}
        for i, o in enumerate(openings):
            groups.setdefault(tuple(o.points), []).append(i)
        group_list = list(groups.items())
        super_points = sorted({pt for o in openings for pt in o.points})

        y = r.squeeze_challenge()
        v = r.squeeze_challenge()
        h_cm = r.read_point()
        u = r.squeeze_challenge()
        q_cm = r.read_point()

        G1 = (1, 2)
        first_z_diff_inv = None
        first_z = None
        normalized_l = []
        for gi, (points, idxs) in enumerate(group_list):
            diffs = [pt for pt in super_points if pt not in points]
            z_diff = _vanishing_eval(diffs, u, p)
            if gi == 0:
                first_z = _vanishing_eval(list(points), u, p)
                first_z_diff_inv = pow(z_diff, p - 2, p)
                norm = 1
            else:
                norm = z_diff * first_z_diff_inv % p
            lc = None
            for idx in reversed(idxs):
                o = openings[idx]
                ru = _eval_host(
                    _lagrange_interp(list(o.points), list(o.values), p), u, p
                )
                delta = _g1_add(
                    o.commitment, _g1_mul((G1[0], (-G1[1]) % pairing.P), ru)
                )
                lc = delta if lc is None else _g1_add(_g1_mul(lc, y), delta)
            lc = _g1_mul(lc, norm)
            normalized_l.append(lc)
        # P = sum v^i L_i - first_z * H + u * Q
        acc = None
        for lc in reversed(normalized_l):
            acc = lc if acc is None else _g1_add(_g1_mul(acc, v), lc)
        acc = _g1_add(acc, _g1_mul(_neg(h_cm), first_z))
        acc = _g1_add(acc, _g1_mul(q_cm, u))
        # e(Q, [tau]_2) * e(P, -G2) == 1
        return pairing.pairing_product_is_one(
            [(q_cm, params.g2_tau), (acc, pairing.g2_neg(params.g2_gen))]
        )


class GWC:
    """reference: gwc.h:84."""

    def __init__(self, params: kzg_mod.KZGParams):
        self.params = params
        self.Fr = curves.bn254_fr(params.g1_powers.x.device)

    def create_opening_proof(
        self, openings: Sequence[ProverOpening], w: TranscriptWriter
    ):
        Fr = self.Fr
        p = Fr.p
        v = w.squeeze_challenge()
        # group by single point
        groups: dict[int, list[int]] = {}
        for i, o in enumerate(openings):
            for pt in o.points:
                groups.setdefault(pt, []).append(i)
        for pt, idxs in groups.items():
            acc = None
            for k, idx in enumerate(idxs):
                term = openings[idx].coeffs
                if k > 0:
                    term = Fr.mul(term, Fr.encode(pow(v, k, p))[:, None])
                acc = term if acc is None else Fr.add(acc, term)
            q, _rem = poly_mod.divide_by_linear(Fr, acc, Fr.encode(pt))
            w.write_point(_commit(self.params, Fr, q))

    def verify_opening_proof(
        self, openings: Sequence[VerifierOpening], r: TranscriptReader
    ) -> bool:
        params = self.params
        p = self.Fr.p
        v = r.squeeze_challenge()
        groups: dict[int, list[int]] = {}
        for i, o in enumerate(openings):
            for j, pt in enumerate(o.points):
                groups.setdefault(pt, []).append((i, j))
        witnesses = [r.read_point() for _ in groups]
        u = r.squeeze_challenge()

        G1 = (1, 2)
        opening_multi = 0
        commitment_multi = None
        witness_with_aux = None
        witness = None
        pow_u = 1
        for gi, (pt, pairs) in enumerate(groups.items()):
            ob = 0
            cb = None
            for (i, j) in reversed(pairs):
                o = openings[i]
                ob = (ob * v + o.values[j]) % p
                cb = (
                    o.commitment
                    if cb is None
                    else _g1_add(_g1_mul(cb, v), o.commitment)
                )
            commitment_multi = _g1_add(commitment_multi, _g1_mul(cb, pow_u))
            opening_multi = (opening_multi + ob * pow_u) % p
            witness_with_aux = _g1_add(
                witness_with_aux, _g1_mul(witnesses[gi], pow_u * pt % p)
            )
            witness = _g1_add(witness, _g1_mul(witnesses[gi], pow_u))
            pow_u = pow_u * u % p
        rhs = _g1_add(
            _g1_add(witness_with_aux, commitment_multi),
            _g1_mul((G1[0], (-G1[1]) % pairing.P), opening_multi),
        )
        return pairing.pairing_product_is_one(
            [(witness, params.g2_tau), (rhs, pairing.g2_neg(params.g2_gen))]
        )


def _neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % pairing.P)
