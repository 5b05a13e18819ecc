"""Groth16 prover and verifier for circom zkeys over BN254.

Port of ``tachyon_tpu/zk/groth16/prover.py`` (the reference's circom
pipeline: prover_main.cc CreateProof, circomlib's QAP
WitnessMapFromMatrices, zk/r1cs/groth16 prove.h and verify.h).

* witness map, on the device: the zkey's A and B coefficients times the
  witness (K1 on the card), summed per (matrix, constraint) segment,
  scattered into the A and B evaluations; c = a * b; three iFFTs and three
  coset FFTs by w_{2n} as one batch each; h = a_e b_e - c_e on the coset.
  The JAX package sums the segments with an XLA ``associative_scan``; the
  port takes a segmented suffix scan of field adds over the sorted
  coefficients (log2 of the longest segment rounds), whose segment starts
  hold the totals: canonical field sums, so the JAX words.
* proof: the G1 MSMs A, C and H (and B1 when r or s is nonzero) and the G2
  MSM B2 through ``math/msm.msm``, then the JAX package's host combination
  in exact ints (``math/host_ec`` through ``r1cs``'s helpers).
* verification: the host pairing product (four Miller loops).

With TACHYON_MSM_DUMP_PATH set, ``prove`` dumps the A query's MSM inputs
for the replay debugger (``io/replay.py``), where the JAX prover does.
"""
from __future__ import annotations

import contextlib
import secrets
import numpy as np
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.io import replay
from tachyon_tpu_torch.io.zkey import ZKeyData
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.math.ec import AffinePoint
from tachyon_tpu_torch.math.msm import msm
from tachyon_tpu_torch.math.ntt import Radix2Domain
from tachyon_tpu_torch.ops import mont
from tachyon_tpu_torch.zk.groth16.r1cs import (Groth16Proof, g1_add, g1_mul, g2_add, g2_mul,
                                                host_point, host_points)


def _points(curve, arr: torch.Tensor) -> AffinePoint:
    """(W, n, 2) Montgomery words (x, y), or (W, n, 4) over Fq2 (x0 x1 y0
    y1) -> AffinePoint on ``curve``'s device with (W, n), or (2, W, n),
    coordinates; all-zero coordinates are infinity."""
    arr = arr.to(curve.device)
    k = arr.shape[2] // 2
    x, y = (arr[:, :, i * k:(i + 1) * k].permute(2, 0, 1) for i in (0, 1))
    if k == 1:
        x, y = x[0], y[0]
    return AffinePoint(x.contiguous(), y.contiguous(), (arr == 0).all(dim=2).all(dim=0))


class CircomGroth16Prover:
    """Prover and verifier over a parsed zkey, on ``device`` (the card
    unless the caller passes another)."""

    def __init__(self, zkey: ZKeyData, device=torch.device("cuda")):
        self.zkey = zkey
        self.g1 = curves.bn254_g1(device)
        self.g2 = curves.bn254_g2(device)
        self.Fr, self.Fq = self.g1.SF, self.g1.F
        if zkey.r != self.Fr.p or zkey.q != self.Fq.p:
            raise ValueError("only BN254 zkeys are supported")
        n = zkey.domain_size
        self.domain = Radix2Domain(self.Fr, n)
        # the coset shift: the root of unity of order 2n (circom's QAP)
        self.shift = self.Fr.spec.root_of_unity(2 * n)

        # device-resident queries
        self.pts_a1 = _points(self.g1, zkey.points_a1)
        self.pts_b1 = _points(self.g1, zkey.points_b1)
        self.pts_b2 = _points(self.g2, zkey.points_b2)
        self.pts_c1 = _points(self.g1, zkey.points_c1)
        self.pts_h1 = _points(self.g1, zkey.points_h1)

        # verifying key and the combination's points as host ints
        self._alpha1, self._beta1, self._delta1 = host_points(self.g1, _points(
            self.g1, torch.stack([zkey.alpha_g1, zkey.beta_g1, zkey.delta_g1], dim=1)))
        self._beta2, self._gamma2, self._delta2 = host_points(self.g2, _points(
            self.g2, torch.stack([zkey.beta_g2, zkey.gamma_g2, zkey.delta_g2], dim=1)))
        self._ic = host_points(self.g1, _points(self.g1, zkey.ic))

        # witness-map plan: coefficients stably sorted by (matrix, constraint)
        m, con, sig = (a.astype(np.int64) for a in
                       (zkey.coeff_matrix, zkey.coeff_constraint, zkey.coeff_signal))
        if len(m) and (m.max() > 1 or con.max() >= n or sig.max() >= zkey.num_vars):
            raise ValueError("zkey coefficient outside matrices A, B, the domain or the signals")
        key = m * n + con
        order = np.argsort(key, kind="stable")
        key = key[order]
        starts = np.flatnonzero(np.diff(key, prepend=-1))  # first index of each segment
        longest = int(np.diff(np.append(starts, len(key))).max()) if len(key) else 1
        self._shifts = [1 << t for t in range(max(longest - 1, 0).bit_length())]
        self._c_key = torch.from_numpy(key).to(device)
        self._c_signal = torch.from_numpy(sig[order]).to(device)
        self._c_value = zkey.coeff_values.to(device)[:, torch.from_numpy(order).to(device)]
        self._seg_start = torch.from_numpy(starts).to(device)
        self._seg_key = self._c_key[self._seg_start]

    # ------------------------------------------------------------ witness map
    def witness_map(self, w_mont: torch.Tensor) -> torch.Tensor:
        """h on the w_{2n} coset: (W, num_vars) Montgomery witness -> (W, n)
        Montgomery evaluations."""
        F, dom, n = self.Fr, self.domain, self.zkey.domain_size
        terms = F.mul(w_mont.index_select(1, self._c_signal), self._c_value)  # (W, nc)
        # segmented suffix scan: after the round of shift t, terms[:, i] holds
        # the sum of its segment's terms i .. i + 2t - 1
        key = self._c_key
        for t in self._shifts:
            same = (key[:-t] == key[t:])[None]
            head = torch.where(same, F.add(terms[:, :-t], terms[:, t:]), terms[:, :-t])
            terms = torch.cat([head, terms[:, -t:]], dim=1)
        # segment totals into a slots [0, n) and b slots [n, 2n)
        ab = F.zeros((2 * n,))
        ab[:, self._seg_key] = terms[:, self._seg_start]
        a, b = ab[:, :n], ab[:, n:]
        abc = torch.stack([a, b, F.mul(a, b)], dim=-1)  # (W, n, 3)
        a_e, b_e, c_e = dom.coset_fft(dom.ifft(abc), self.shift).unbind(-1)
        return F.sub(F.mul(a_e, b_e), c_e)

    # ------------------------------------------------------------------ prove
    def prove(self, witness_std: torch.Tensor, r: int | None = None, s: int | None = None,
              *, deterministic: bool = False, timer=None) -> Groth16Proof:
        """witness_std: (W, num_vars) standard-form words (``parse_wtns``).

        r and s default to fresh CSPRNG scalars; ``deterministic=True`` gives
        the reproducible non-ZK proof (r = s = 0 unless given).  ``timer(name)``,
        when given, is a context manager entered around each step (the
        witness map, each MSM, the host combination)."""
        zk, F, rp = self.zkey, self.Fr, self.Fr.p
        step = timer or (lambda name: contextlib.nullcontext())
        if deterministic:
            r = 0 if r is None else r
            s = 0 if s is None else s
        else:
            r = secrets.randbelow(rp) if r is None else r
            s = secrets.randbelow(rp) if s is None else s
        w_std = witness_std.to(F.device)
        if tuple(w_std.shape) != (F.W, zk.num_vars):
            raise ValueError(f"witness of shape {tuple(w_std.shape)}, expected "
                             f"({F.W}, {zk.num_vars})")

        with step("witness_map"):
            h_std = mont.mont_reduce(F.spec, self.witness_map(mont.to_mont(F.spec, w_std)))
        npub1 = zk.num_public + 1
        # optional input dump for the replay debugger (reference:
        # msm_gpu_replay.cc / TACHYON_PCS_PARAMS_LOG_PATH)
        replay.dump_msm("bn254_g1", self.pts_a1, w_std)
        with step("msm_a"):
            a_acc = host_point(self.g1, msm(self.g1, self.pts_a1, w_std))
        with step("msm_b2_g2"):
            b2_acc = host_point(self.g2, msm(self.g2, self.pts_b2, w_std))
        with step("msm_c"):
            c_acc = host_point(self.g1, msm(self.g1, self.pts_c1, w_std[:, npub1:].contiguous()))
        with step("msm_h"):
            h_acc = host_point(self.g1, msm(self.g1, self.pts_h1, h_std))
        b1_acc = None  # only C's r B1 term reads it
        if r or s:
            with step("msm_b1"):
                b1_acc = host_point(self.g1, msm(self.g1, self.pts_b1, w_std))

        with step("host"):  # at r = s = 0 every blinding term is infinity
            A = g1_add(g1_add(a_acc, self._alpha1), g1_mul(self._delta1, r))
            B = g2_add(g2_add(b2_acc, self._beta2), g2_mul(self._delta2, s))
            b1 = g1_add(g1_add(b1_acc, self._beta1), g1_mul(self._delta1, s))
            C = g1_add(g1_add(c_acc, h_acc), g1_mul(A, s))
            C = g1_add(g1_add(C, g1_mul(b1, r)), g1_mul(self._delta1, (-r * s) % rp))
        return Groth16Proof(A, B, C)

    # ----------------------------------------------------------------- verify
    def verify(self, proof: Groth16Proof, public_inputs: list[int]) -> bool:
        """e(A, B) == e(alpha, beta) e(vk_x, gamma) e(C, delta), on the host."""
        rp = self.Fr.p
        vk_x = self._ic[0]
        for i, pub in enumerate(public_inputs):
            vk_x = g1_add(vk_x, g1_mul(self._ic[i + 1], pub % rp))
        neg_a = (proof.a[0], (-proof.a[1]) % pairing.P) if proof.a else None
        return pairing.pairing_product_is_one([
            (neg_a, proof.b),
            (self._alpha1, self._beta2),
            (vk_x, self._gamma2),
            (proof.c, self._delta2),
        ])


def public_inputs(zkey: ZKeyData, witness_std: torch.Tensor) -> list[int]:
    """The public signals w_1 .. w_num_public of a standard-form witness."""
    w = witness_std[:, 1:zkey.num_public + 1].cpu().contiguous().numpy().view(np.uint32)
    return limbs.words_to_ints(w)
