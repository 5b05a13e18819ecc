"""Torch backend of the halo2 bit-compatible prover: the card's MSMs, NTTs
and quotient build under the byte-exact pipeline of ``zk/plonk/halo2.py``.

Port of ``tachyon_tpu/zk/plonk/halo2_device.py`` (``DeviceBackend``).  The
prover's control flow, transcript and identity logic stay host-exact; the
backend owns the asymptotically dominant work:

* KZG commitments: the port's MSM (``math/msm.py``: the sweep path's K5,
  K6, bucket, lane and Horner kernels above 128 points, the ladder and K2
  at or below), over the KZG setup that ``keygen`` made and
  kept in the key (the JAX package builds it twice);
* IFFTs and coset FFTs: ``Radix2Domain`` (K1 for the twiddle products);
* ``build_h_coeffs``: h(X) over the extended coset, run eagerly: every AST
  node of every identity is a whole-column field op (K1 for a product, the
  port's add and sub), a rotation is ``torch.roll``, one extended-coset
  part at a time (the JAX package jits one part's graph); the zeta^-i
  table is ``shift_powers`` on the device, not a host loop over ext_n.

Values cross to the host as Python ints, as in the JAX package: the
prover's grand products, lookup permutations and openings are host loops.
Every function runs on the backend's device: the card unless the caller
passes another (``device="cpu"`` for the plain PyTorch twins).
"""
from __future__ import annotations

import numpy as np
import torch

from tachyon_tpu_torch.crypto import kzg as kzg_mod
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.math.ntt import Radix2Domain
from tachyon_tpu_torch.ops import mont


def _encode(Fr, ints):
    return Fr.encode(np.array([int(v) for v in ints], dtype=object))


def _decode(Fr, words) -> list:
    return [int(v) for v in Fr.decode(words)]


def device_ifft_fn(n: int, omega: int, device=torch.device("cuda")):
    """Radix2 IFFT over the halo2 domain on ``device`` for keygen
    (bit-exact; reference: proving_key.h DoLoad's batch IFFTs)."""
    Fr = curves.bn254_fr(device)
    dom = Radix2Domain(Fr, n, omega_int=omega)

    def ifft(evals):
        cf = [int(v) for v in evals] + [0] * (n - len(evals))
        return _decode(Fr, dom.ifft(_encode(Fr, cf)))

    return ifft


def device_committer(params: kzg_mod.KZGParams):
    """KZG committer for keygen over ``params`` on their device
    (fixed/permutation commitments run through the same MSM as proving —
    reference: zk/plonk/halo2/proving_key.h commits via kzg.h:218-240).
    Returns commit(coeffs: list[int]) -> (x, y) | None."""
    Fr = curves.bn254_fr(params.g1_powers.x.device)

    def commit(coeffs):
        cf = [int(v) for v in coeffs] + [0] * (params.n - len(coeffs))
        std = mont.mont_reduce(Fr.spec, _encode(Fr, cf))
        return kzg_mod.to_int_point(kzg_mod.commit(params, std))

    return commit


class TorchBackend:
    """The JAX ``HostBackend``'s primitive surface plus
    ``make_compressor``, on the port's kernels: over the key's KZG setup
    where keygen left one on this device, else a new one of (n, tau)."""

    def __init__(self, pk, device=torch.device("cuda")):
        self.pk = pk
        self.device = torch.device(device)
        self.Fr = curves.bn254_fr(self.device)
        srs = pk.srs
        if srs is None or srs.g1_powers.x.device != torch.empty(0, device=self.device).device:
            srs = kzg_mod.unsafe_setup(pk.n, pk.kzg.tau, self.device)
        self.params = srs
        self.dom = Radix2Domain(self.Fr, pk.n, omega_int=pk.omega)

    # --- helpers ------------------------------------------------------------
    def _encode(self, ints):
        return _encode(self.Fr, ints)

    def _decode(self, words):
        return _decode(self.Fr, words)

    def _const(self, v):
        """(W, 1) Montgomery constant for broadcasting against (W, n)."""
        return self._encode([int(v) % self.Fr.p])

    def _encode_poly(self, coeffs):
        n = self.pk.n
        return self._encode([int(v) for v in coeffs] + [0] * (n - len(coeffs)))

    # --- primitive surface ----------------------------------------------------
    def commit_lagrange(self, evals):
        return self._commit_enc(self.dom.ifft(self._encode(evals)))

    def commit(self, coeffs):
        return self._commit_enc(self._encode(coeffs))

    def _commit_enc(self, coeffs_enc):
        std = mont.mont_reduce(self.Fr.spec, coeffs_enc)
        return kzg_mod.to_int_point(kzg_mod.commit(self.params, std))

    def ifft(self, evals):
        return self._decode(self.dom.ifft(self._encode(evals)))

    def make_compressor(self, table, challenges):
        """Vectorized lookup/shuffle compress over the Lagrange domain: the
        device analog of the prover's per-row python Horner
        (reference: lookup/halo2/prover_impl.h CompressExpressions — one
        expression-DAG evaluation over all n rows at once; rotations are
        rolls).  Returns fn(exprs, theta) -> list[int]."""
        from tachyon_tpu_torch.zk.plonk import expressions as ex_mod

        F = self.Fr
        ev = ex_mod.Evaluator(
            F, [self._encode(c) for c in table["fixed"]],
            [self._encode(c) for c in table["advice"]],
            [self._encode(c) for c in table["instance"]],
            challenges=dict(challenges),
        )

        def compress(exprs, theta):
            theta_c = self._const(theta)
            acc = None
            for e in exprs:
                v = ev.eval(e)
                acc = v if acc is None else F.add(F.mul(acc, theta_c), v)
            return self._decode(acc)

        return compress

    def coset_evals(self, coeffs, shift):
        return self._decode(self.dom.coset_fft(self._encode_poly(coeffs), int(shift)))

    # --- the quotient build (GraphEvaluator analog) ---------------------------
    def build_h_coeffs(self, *, challenges, theta, beta, gamma, y, t_blind,
                       chunks, log_derivative, advice_polys_vec,
                       instance_polys_vec, perm_zp_vec, lookup_zp_vec,
                       lookup_permuted_polys_vec, lookup_mp_vec,
                       shuffle_zp_vec):
        """h(X) on the device: coset FFTs, the identities over each
        extended-coset part as whole-column field ops, the extended iFFT.

        Bit-exact against the JAX package's exact-int oracle
        (``HostBackend``, whose proofs ``tests/fixtures/torch_halo2_jax.json``
        records) by construction — same identity order, same Horner-in-y folding
        (reference: zk/plonk/vanishing/graph_evaluator.h:52,
        circuit_polynomial_builder.h:132-199)."""
        from tachyon_tpu_torch.zk.plonk import expressions as ex
        from tachyon_tpu_torch.zk.plonk.halo2 import (
            FR, HALO2_GENERATOR, TWO_ADICITY, halo2_omega, halo2_zeta,
        )

        pk, F = self.pk, self.Fr
        cs, n, omega = pk.cs, pk.n, pk.omega
        num_circuits = len(advice_polys_vec)
        ext_k = pk.extended_k
        ext_n = 1 << ext_k
        num_parts = ext_n // n
        omega_ext = halo2_omega(ext_k)
        zeta = halo2_zeta(pk.vendor)
        delta = pow(HALO2_GENERATOR, 1 << TWO_ADICITY, FR)

        # --- encode every coefficient poly once -------------------------------
        enc = self._encode_poly
        fixed_p = [enc(po) for po in pk.fixed_polys]
        lf_p, ll_p, la_p = enc(pk.l_first), enc(pk.l_last), enc(pk.l_active_row)
        sig_p = [enc(po) for po in pk.permutation_polys]
        adv_p = [[enc(po) for po in advice_polys_vec[ci]]
                 for ci in range(num_circuits)]
        inst_p = [[enc(po) for po in instance_polys_vec[ci]]
                  for ci in range(num_circuits)]
        z_p = [[enc(po) for po in perm_zp_vec[ci]] for ci in range(num_circuits)]
        lkz_p = [[enc(po) for po in lookup_zp_vec[ci]]
                 for ci in range(num_circuits)]
        lkap_p = [[enc(pa) for pa, _ in lookup_permuted_polys_vec[ci]]
                  for ci in range(num_circuits)]
        lksp_p = [[enc(ps) for _, ps in lookup_permuted_polys_vec[ci]]
                  for ci in range(num_circuits)]
        lkm_p = [[enc(mp) for mp in lookup_mp_vec[ci]]
                 for ci in range(num_circuits)]
        shz_p = [[enc(po) for po in shuffle_zp_vec[ci]]
                 for ci in range(num_circuits)]

        y_c = self._const(y)
        beta_c = self._const(beta)
        gamma_c = self._const(gamma)
        theta_c = self._const(theta)
        delta_c = self._const(delta)
        one_v = F.ones((n,))
        ch_enc = {k: self._const(v) for k, v in (challenges or {}).items()}
        t1 = t_blind + 1
        omega_pows = self.dom.shift_powers(omega)  # (W, n)

        def part_values(shift: int, t_inv: int):
            """acc (W, n) for one extended-coset part, divided by t(X)."""
            shift_pows = self.dom.shift_powers(shift)
            shift_c = self._const(shift)

            def coset(po):
                return self.dom.fft(F.mul(po, shift_pows))

            fixed_c = [coset(po) for po in fixed_p]
            lfv = coset(lf_p)
            llv = coset(ll_p)
            lav = coset(la_p)
            sig_c = [coset(po) for po in sig_p]
            x_coset = F.mul(omega_pows, shift_c)
            acc = F.zeros((n,))

            def fold(v, term):
                return F.add(F.mul(v, y_c), term)

            for ci in range(num_circuits):
                adv_c = [coset(po) for po in adv_p[ci]]
                inst_c = [coset(po) for po in inst_p[ci]]
                z_c = [coset(po) for po in z_p[ci]]
                lk_z_c = [coset(po) for po in lkz_p[ci]]
                lk_ap_c = [coset(po) for po in lkap_p[ci]]
                lk_sp_c = [coset(po) for po in lksp_p[ci]]
                lk_m_c = [coset(po) for po in lkm_p[ci]]
                sh_z_c = [coset(po) for po in shz_p[ci]]

                def expr(e):
                    if isinstance(e, ex.Constant):
                        return F.full((n,), e.value % FR)
                    if isinstance(e, ex.Challenge):
                        return ch_enc[e.index].expand(F.W, n)
                    if isinstance(e, ex.Fixed):
                        return torch.roll(fixed_c[e.column], -e.rotation, dims=1)
                    if isinstance(e, ex.Advice):
                        return torch.roll(adv_c[e.column], -e.rotation, dims=1)
                    if isinstance(e, ex.Instance):
                        return torch.roll(inst_c[e.column], -e.rotation, dims=1)
                    if isinstance(e, ex.Negated):
                        return F.neg(expr(e.expr))
                    if isinstance(e, ex.Scaled):
                        return F.mul(expr(e.expr), self._const(e.scale))
                    if isinstance(e, ex.Sum):
                        return F.add(expr(e.left), expr(e.right))
                    if isinstance(e, ex.Product):
                        return F.mul(expr(e.left), expr(e.right))
                    raise TypeError(e)

                def comp_at(exprs):
                    a = F.zeros((n,))
                    for e in exprs:
                        a = F.add(F.mul(a, theta_c), expr(e))
                    return a

                for g in cs.gates:
                    for poly in g.polys:
                        acc = fold(acc, expr(poly))
                if z_c:
                    # part 1: l_first * (1 - z_0); l_last * (z_l^2 - z_l)
                    acc = fold(acc, F.mul(F.sub(one_v, z_c[0]), lfv))
                    zl = z_c[-1]
                    acc = fold(acc, F.mul(llv, F.sub(F.square(zl), zl)))
                    # part 2: chunk stitches at r_last = idx - (t_blind+1)
                    for jj in range(1, len(z_c)):
                        prev_last = torch.roll(z_c[jj - 1], t1, dims=1)
                        acc = fold(acc, F.mul(lfv, F.sub(z_c[jj], prev_last)))
                    # part 3: transitions
                    cur_delta = F.mul(beta_c, x_coset)
                    jcol = 0
                    for jj, chunk in enumerate(chunks):
                        left = torch.roll(z_c[jj], -1, dims=1)
                        right = z_c[jj]
                        for cidx, col in enumerate(chunk):
                            cv = {"fixed": fixed_c, "advice": adv_c,
                                  "instance": inst_c}[col.kind][col.index]
                            left = F.mul(left, F.add(
                                F.add(cv, F.mul(beta_c, sig_c[jcol + cidx])),
                                gamma_c))
                            right = F.mul(right, F.add(
                                F.add(cv, cur_delta), gamma_c))
                            cur_delta = F.mul(cur_delta, delta_c)
                        jcol += len(chunk)
                        acc = fold(acc, F.mul(F.sub(left, right), lav))
                for li, lk in enumerate(cs.lookups):
                    zv = lk_z_c[li]
                    z_next = torch.roll(zv, -1, dims=1)
                    if log_derivative:
                        phis = [F.add(comp_at(inputs), beta_c)
                                for inputs in lk.inputs_list]
                        tau = F.add(comp_at(lk.table_exprs), beta_c)
                        prod = phis[0]
                        for p_v in phis[1:]:
                            prod = F.mul(prod, p_v)
                        lhs = F.mul(F.mul(tau, prod), F.sub(z_next, zv))
                        excl = F.zeros((n,))
                        for i2 in range(len(phis)):
                            t2 = None
                            for j2, p_v in enumerate(phis):
                                if j2 != i2:
                                    t2 = p_v if t2 is None else F.mul(t2, p_v)
                            excl = F.add(excl,
                                         t2 if t2 is not None else one_v)
                        rhs = F.sub(F.mul(tau, excl), F.mul(prod, lk_m_c[li]))
                        acc = fold(acc, F.mul(lfv, zv))
                        acc = fold(acc, F.mul(llv, zv))
                        acc = fold(acc, F.mul(F.sub(lhs, rhs), lav))
                        continue
                    a_comp = comp_at(lk.input_exprs)
                    s_comp = comp_at(lk.table_exprs)
                    av = lk_ap_c[li]
                    a_prev = torch.roll(av, 1, dims=1)
                    sv = lk_sp_c[li]
                    a_minus_s = F.sub(av, sv)
                    acc = fold(acc, F.mul(lfv, F.sub(one_v, zv)))
                    acc = fold(acc, F.mul(llv, F.sub(F.square(zv), zv)))
                    acc = fold(acc, F.mul(lav, F.sub(
                        F.mul(F.mul(z_next, F.add(av, beta_c)),
                              F.add(sv, gamma_c)),
                        F.mul(F.mul(zv, F.add(a_comp, beta_c)),
                              F.add(s_comp, gamma_c)))))
                    acc = fold(acc, F.mul(lfv, a_minus_s))
                    acc = fold(acc, F.mul(F.mul(lav, a_minus_s),
                                          F.sub(av, a_prev)))
                for si, sh in enumerate(cs.shuffles):
                    zv = sh_z_c[si]
                    z_next = torch.roll(zv, -1, dims=1)
                    a_comp = comp_at(sh.input_exprs)
                    s_comp = comp_at(sh.shuffle_exprs)
                    acc = fold(acc, F.mul(lfv, F.sub(one_v, zv)))
                    acc = fold(acc, F.mul(llv, F.sub(F.square(zv), zv)))
                    acc = fold(acc, F.mul(lav, F.sub(
                        F.mul(z_next, F.add(s_comp, gamma_c)),
                        F.mul(zv, F.add(a_comp, gamma_c)))))
            return F.mul(acc, self._const(t_inv))

        parts = []
        for part in range(num_parts):
            shift = zeta * pow(omega_ext, part, FR) % FR
            t_eval = (pow(shift, n, FR) - 1) % FR
            parts.append(part_values(shift, pow(t_eval, FR - 2, FR)))
        # h_ext[part + idx*num_parts] = parts[part][idx]
        h_ext = torch.stack(parts, dim=-1).reshape(F.W, ext_n)
        del parts
        dom_ext = Radix2Domain(F, ext_n, omega_int=omega_ext)
        h_scaled = dom_ext.ifft(h_ext)
        zeta_inv = pow(zeta, FR - 2, FR)
        h = F.mul(h_scaled, dom_ext.shift_powers(zeta_inv, ext_n))
        return self._decode(h)

