"""Uni-STARK prover and verifier over TwoAdicFRI (the Plonky3/SP1 design).

Port of ``tachyon_tpu/zk/air/stark.py`` (reference: tachyon/c/zk/air/sp1/
baby_bear_poseidon2_two_adic_fri.cc, the PCS objects the SP1 uni-STARK
drives; the constraint layer zk/air/).  The flow:

  prove:  commit(trace) -> alpha -> quotient Q = fold_alpha(C) / Z_H over an
          extended coset -> commit(Q's chunks) -> zeta -> the PCS opens the
          trace at {zeta, zeta w} and Q at {zeta}
  verify: replay the challenges, verify the PCS opening, then check
          fold_alpha(C)(zeta) == Q(zeta) Z_H(zeta) (exact host ints)

Every column op (trace LDE, constraint evaluation, the division by Z_H,
the chunks' FFTs) is a batched tensor op on the device (its multiplies K1
at W = 1 on the card); the transcript is host-exact.  The trace may be a
numpy array of Python ints or, for large traces, an integer tensor of
canonical values, encoded on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.crypto.fri import FRIProof, TwoAdicFRIPCS
from tachyon_tpu_torch.math.extfield import HostExt
from tachyon_tpu_torch.math.ntt import Radix2Domain
from tachyon_tpu_torch.zk.air import expressions as ax


class STARKProof(NamedTuple):
    trace_root: torch.Tensor  # (W, DIGEST) MMCS commitment
    quotient_root: torch.Tensor
    opened_values: tuple  # [round][matrix][point]: (D, W, C) claimed values
    fri: FRIProof
    n: int  # trace height


def _observe_root(F, challenger, root):
    challenger.observe_many(int(v) for v in F.decode(root))  # one transfer a root


class UniStark:
    def __init__(self, pcs: TwoAdicFRIPCS, air: ax.AirBuilder):
        self.pcs = pcs
        self.air = air
        self.F = pcs.F
        self.ext = pcs.ext
        self.hx = HostExt(pcs.ext)

    # degree bookkeeping: Main/First/Last/Transition count as degree n
    def _max_degree(self) -> int:
        return max((ax.degree(c) for c in self.air.constraints), default=2)

    def _ext_factor(self) -> int:
        return 1 << max(1, (max(self._max_degree(), 2) - 1).bit_length())

    def _num_chunks(self) -> int:
        return max(self._max_degree() - 1, 1)

    # ------------------------------------------------------------------ prove
    def prove(self, trace_ints, public_values: list[int],
              challenger: DuplexChallenger) -> STARKProof:
        """trace_ints: (n, width) numpy array of Python ints, or an integer
        tensor of canonical values (encoded on the device)."""
        F, ext, pcs, hx = self.F, self.ext, self.pcs, self.hx
        D = ext.D
        n, width = trace_ints.shape
        if width != self.air.width:
            raise ValueError(f"trace width {width}, the AIR's {self.air.width}")
        p = F.p
        dom = Radix2Domain(F, n)
        omega = dom.omega_int

        challenger.observe(n)
        for v in public_values:
            challenger.observe(int(v) % p)

        if isinstance(trace_ints, torch.Tensor):
            trace = F.encode_canonical(trace_ints)  # (1, n, width)
        else:
            trace = F.encode(np.asarray(trace_ints, dtype=object))  # (W, n, width)
        trace_data = pcs.commit([trace])
        _observe_root(F, challenger, trace_data.root())
        alpha = ext.encode([int(c) for c in challenger.sample_ext(D)])

        # the quotient over the extended coset
        ext_factor = self._ext_factor()
        big_n = n * ext_factor
        big = Radix2Domain(F, big_n)
        shift = F.spec.generator

        def lde(cf):  # coefficients (W, n, ...) -> values on shift H_big_n
            pad = torch.zeros((cf.shape[0], big_n - n) + cf.shape[2:], dtype=cf.dtype,
                              device=cf.device)
            return big.coset_fft(torch.cat([cf, pad], dim=1), shift)

        trace_ext = lde(trace_data.coeffs[0])  # (W, big_n, width): the commit's ifft

        def indicator_ext(row: int):  # the selector L_row, an exact polynomial LDE
            e = F.zeros((n,))
            e[:, row] = F.ones(())
            return lde(dom.ifft(e))

        l0_ext = indicator_ext(0)
        llast_ext = indicator_ext(n - 1)
        xs = F.mul(big.shift_powers(big.omega_int, big_n), F.full((), shift)[:, None])
        trans_ext = F.sub(xs, F.full((big_n,), pow(omega, n - 1, p)))

        evaluator = _ColumnEvaluator(F, trace_ext, ext_factor, l0_ext, llast_ext, trans_ext,
                                     public_values, big_n)
        acc = None
        for c in self.air.constraints:
            v = ext.embed(evaluator.eval(c))  # (D, W, big_n)
            acc = v if acc is None else ext.add(ext.mul(acc, alpha[..., None]), v)
        if acc is None:
            acc = ext.zeros((big_n,))

        # divide by Z_H on the coset: its values repeat with period ext_factor
        sn = pow(shift, n, p)
        wn = pow(big.omega_int, n, p)
        zh_inv = F.encode([pow((sn * pow(wn, i, p) - 1) % p, p - 2, p)
                           for i in range(ext_factor)]).repeat(1, n)
        q_ext = ext.mul_base(acc, zh_inv)  # (D, W, big_n)
        q_coeffs = torch.stack([big.coset_ifft(q_ext[d], shift) for d in range(D)])
        cols = []
        for k in range(self._num_chunks()):
            chunk = q_coeffs[:, :, k * n:(k + 1) * n]
            cols.extend(dom.fft(chunk[d]) for d in range(D))  # (W, n) values on H_n
        q_data = pcs.commit([torch.stack(cols, dim=-1)])  # (W, n, num_chunks D)
        _observe_root(F, challenger, q_data.root())

        zeta = challenger.sample_ext(D)
        zeta_next = hx.mul(zeta, omega)
        opened_values, fri = pcs.create_opening_proof(
            [trace_data, q_data], [[[zeta, zeta_next]], [[zeta]]], challenger)
        return STARKProof(trace_data.root(), q_data.root(), opened_values, fri, n)

    # ----------------------------------------------------------------- verify
    def verify(self, proof: STARKProof, public_values: list[int],
               challenger: DuplexChallenger) -> bool:
        F, ext, pcs, hx = self.F, self.ext, self.pcs, self.hx
        D = ext.D
        n = proof.n
        p = F.p
        omega = Radix2Domain(F, n).omega_int
        width = self.air.width
        num_chunks = self._num_chunks()

        challenger.observe(n)
        for v in public_values:
            challenger.observe(int(v) % p)
        _observe_root(F, challenger, proof.trace_root)
        alpha = challenger.sample_ext(D)
        _observe_root(F, challenger, proof.quotient_root)
        zeta = challenger.sample_ext(D)
        zeta_next = hx.mul(zeta, omega)

        if not pcs.verify_opening_proof(
                [proof.trace_root, proof.quotient_root],
                [[(n, width)], [(n, num_chunks * D)]],
                [[[zeta, zeta_next]], [[zeta]]],
                proof.opened_values, proof.fri, challenger):
            return False

        def ext_rows(ov, C):  # (D, W, C) -> C host extension values
            coeffs = [F.decode(ov[d]) for d in range(D)]
            return [[int(coeffs[d][c]) for d in range(D)] for c in range(C)]

        local = ext_rows(proof.opened_values[0][0][0], width)
        nxt = ext_rows(proof.opened_values[0][0][1], width)
        q_open = ext_rows(proof.opened_values[1][0][0], num_chunks * D)

        # the selectors at zeta (exact)
        zeta_n = hx.pow(zeta, n)
        zh = hx.sub(zeta_n, 1)
        ninv = pow(n, p - 2, p)
        l0 = hx.mul(hx.mul(zh, hx.inv(hx.sub(zeta, 1))), ninv)
        wl = pow(omega, n - 1, p)
        llast = hx.mul(hx.mul(hx.mul(zh, hx.inv(hx.sub(zeta, wl))), ninv), wl)
        trans = hx.sub(zeta, wl)

        sev = _ScalarAirEvaluator(hx, local, nxt, l0, llast, trans, public_values)
        acc = None
        for c in self.air.constraints:
            v = sev.eval(c)
            acc = v if acc is None else hx.add(hx.mul(acc, alpha), v)
        if acc is None:
            acc = hx.e(0)

        # Q(zeta) = sum_k zeta^(k n) sum_d u^d y_(k, d)
        u_pow = [hx.pow([0, 1] + [0] * (D - 2), d) for d in range(D)]
        q_at = hx.e(0)
        zk = hx.e(1)
        for k in range(num_chunks):
            chunk_val = hx.e(0)
            for d in range(D):
                chunk_val = hx.add(chunk_val, hx.mul(u_pow[d], q_open[k * D + d]))
            q_at = hx.add(q_at, hx.mul(zk, chunk_val))
            zk = hx.mul(zk, zeta_n)
        return acc == hx.mul(q_at, zh)


class _ColumnEvaluator:
    """The AIR's AST evaluated column-wise over the quotient coset."""

    def __init__(self, F, trace_ext, rot, l0, llast, trans, pubs, big_n):
        self.F = F
        self.trace_ext = trace_ext  # (W, big_n, width)
        self.rot = rot
        self.l0 = l0
        self.llast = llast
        self.trans = trans
        self.pubs = pubs
        self.big_n = big_n

    def eval(self, e):
        F = self.F
        if isinstance(e, ax.Constant):
            return F.full((self.big_n,), e.value)
        if isinstance(e, ax.Main):
            col = self.trace_ext[:, :, e.column]
            return torch.roll(col, -self.rot, dims=1) if e.next else col
        if isinstance(e, ax.Pub):
            return F.full((self.big_n,), int(self.pubs[e.index]))
        if isinstance(e, ax.First):
            return self.l0
        if isinstance(e, ax.Last):
            return self.llast
        if isinstance(e, ax.Transition):
            return self.trans
        if isinstance(e, ax.Negated):
            return F.neg(self.eval(e.expr))
        if isinstance(e, ax.Sum):
            return F.add(self.eval(e.left), self.eval(e.right))
        if isinstance(e, ax.Product):
            return F.mul(self.eval(e.left), self.eval(e.right))
        raise TypeError(e)


class _ScalarAirEvaluator:
    """The AIR's AST evaluated host-exact at one extension point."""

    def __init__(self, hx, local, nxt, l0, llast, trans, pubs):
        self.hx = hx
        self.local = local
        self.nxt = nxt
        self.l0 = l0
        self.llast = llast
        self.trans = trans
        self.pubs = pubs

    def eval(self, e):
        hx = self.hx
        if isinstance(e, ax.Constant):
            return hx.e(e.value)
        if isinstance(e, ax.Main):
            return self.nxt[e.column] if e.next else self.local[e.column]
        if isinstance(e, ax.Pub):
            return hx.e(int(self.pubs[e.index]))
        if isinstance(e, ax.First):
            return self.l0
        if isinstance(e, ax.Last):
            return self.llast
        if isinstance(e, ax.Transition):
            return self.trans
        if isinstance(e, ax.Negated):
            return hx.neg(self.eval(e.expr))
        if isinstance(e, ax.Sum):
            return hx.add(self.eval(e.left), self.eval(e.right))
        if isinstance(e, ax.Product):
            return hx.mul(self.eval(e.left), self.eval(e.right))
        raise TypeError(e)
