"""Poseidon2 permutation and sponge over a batch of states.

Port of ``tachyon_tpu/crypto/poseidon2.py`` (reference:
tachyon/crypto/hashes/sponge/poseidon2/poseidon2.h, poseidon2_config.h
FindPoseidon2ARK, poseidon2_{horizen,plonky3}_{external,internal}_matrix.h).
A state is a ``(W, t, *batch)`` int32 word tensor in Montgomery form; every
round is a few whole-batch tensor ops, and the JAX ``lax.scan`` over rounds
is a Python loop.  Round constants come from the arkworks Grain LFSR, the
internal matrix in the Horizen flavour (M_I = J + diag(d)) or Plonky3's
monty flavour (M_I = R^-1 (J + diag(d)), the R^-1 folded into d), so the
words equal the JAX package's and the horizen-labs/Plonky3 vectors.

Every S-box and internal-matrix multiply is K1 on the card (at W = 1 and
W = 2 the one- and two-word kernels, with the diagonal read in place).  The JAX package has no
Pallas kernel of its own here.  At W = 1 two linear steps take a shorter
form with the same canonical words: the external matrix M_E, whose entries
are small integers, is one float64 product (every partial sum is an integer
below 2^42, so exact) and one ``fmod`` by p; the internal matrix's lane sum
is one int64 sum.  A partial round writes its one S-box lane in place
rather than concatenating the state.  ``permute_host`` is the exact
Python-int permutation that the challenger's duplex uses.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tachyon_tpu_torch.crypto.grain import GrainLFSR
from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math.field import PrimeField


class Poseidon2:
    def __init__(
        self,
        F: PrimeField,
        width: int,
        alpha: int,
        full_rounds: int,
        partial_rounds: int,
        internal: str,  # "horizen" | "plonky3"
        internal_diag: list[int] | None = None,  # horizen: d_i (mu_i - 1)
        internal_shifts: list[int] | None = None,  # plonky3: width - 1 shifts
        external: str = "plonky3",  # "plonky3" | "horizen"
    ):
        if alpha not in (3, 5, 7, 11):
            raise ValueError(f"alpha {alpha}")
        self.F = F
        self.t = width
        self.alpha = alpha
        self.full_rounds = full_rounds
        self.partial_rounds = partial_rounds
        self.internal = internal
        self.external = external
        p = F.p

        # round constants via the grain LFSR (FindPoseidon2ARK)
        lfsr = GrainLFSR(F.spec.bits, width, full_rounds, partial_rounds)
        half = full_rounds // 2
        full_ark, partial_ark = [], []
        for i in range(full_rounds + partial_rounds):
            if i < half or i >= half + partial_rounds:
                full_ark.append(lfsr.field_elements_rejection_sampling(p, width))
            else:
                partial_ark.append(lfsr.field_elements_rejection_sampling(p, 1)[0])
        self.ark_full_host = full_ark
        self.ark_partial_host = partial_ark
        self.ark_full = F.encode(np.array(full_ark, dtype=object))  # (W, FR, t)
        self.ark_partial = F.encode(np.array(partial_ark, dtype=object))  # (W, PR)

        # internal matrix constants
        if internal == "horizen":
            if internal_diag is None or len(internal_diag) != width:
                raise ValueError("horizen: internal_diag of length width")
            self.int_diag_host = [int(x) % p for x in internal_diag]
            self.int_rinv_host = None
            self.int_rinv = None
        else:
            if internal_shifts is None or len(internal_shifts) != width - 1:
                raise ValueError("plonky3: internal_shifts of length width - 1")
            rinv = pow(1 << 32, -1, p) if p != (1 << 31) - 1 else 1
            d = [(-2) % p] + [(1 << s) % p for s in internal_shifts]
            # fold the R^-1 of the plonky3 monty kernel into the constants
            self.int_diag_host = [(x * rinv) % p for x in d]
            self.int_rinv_host = rinv
            self.int_rinv = F.encode(np.array(rinv, dtype=object))  # (W,)
        self.int_diag = F.encode(np.array(self.int_diag_host, dtype=object))  # (W, t)

        # M_E as a float64 matrix for the one-word form: column j is the
        # host mix of the unit vector e_j (small integers, no reduction)
        self._me = None
        if F.W == 1:
            cols = [self._mix_external_host([int(i == j) for i in range(width)])
                    for j in range(width)]
            self._me = torch.tensor(cols, dtype=torch.float64, device=F.device).T.contiguous()

    # --- pieces ----------------------------------------------------------------
    def _sbox(self, x):
        F, a = self.F, self.alpha
        x2 = F.square(x)
        if a == 3:
            return F.mul(x2, x)
        if a == 5:
            return F.mul(F.square(x2), x)
        if a == 7:
            return F.mul(F.mul(F.square(x2), x2), x)
        x4 = F.square(x2)  # a == 11
        return F.mul(F.mul(F.square(x4), x2), x)

    def _mix_external(self, st):
        """M_E on (W, t, *batch); t in {2, 3} or a multiple of 4."""
        F, t = self.F, self.t
        if self._me is not None:
            x = st.reshape(t, -1).to(torch.float64)
            y = torch.fmod(self._me @ x, float(F.p))
            return y.to(torch.int32).reshape(st.shape)
        if t == 2:
            s = F.add(st[:, 0], st[:, 1])
            return torch.stack([F.add(st[:, 0], s), F.add(st[:, 1], s)], dim=1)
        if t == 3:
            s = F.add(F.add(st[:, 0], st[:, 1]), st[:, 2])
            return torch.stack([F.add(st[:, i], s) for i in range(3)], dim=1)
        if t % 4:
            raise ValueError(f"width {t}")
        blocks = st.reshape(st.shape[0], t // 4, 4, *st.shape[2:])
        v0, v1, v2, v3 = (blocks[:, :, i] for i in range(4))
        if self.external == "plonky3":
            # M4 = circ(2, 3, 1, 1)-style (poseidon2_plonky3_external_matrix.h)
            t0 = F.add(v0, v1)
            t1 = F.add(v2, v3)
            t2 = F.add(t0, t1)
            t3 = F.add(t2, v1)
            t4 = F.add(t2, v3)
            n3 = F.add(t4, F.double(v0))
            n1 = F.add(t3, F.double(v2))
            n0 = F.add(t3, t0)
            n2 = F.add(t4, t1)
        else:
            # horizen M4 (poseidon2_horizen_external_matrix.h)
            t0 = F.add(v0, v1)
            t1 = F.add(v2, v3)
            t2 = F.add(F.double(v1), t1)
            t3 = F.add(F.double(v3), t0)
            n3 = F.add(F.double(F.double(t1)), t3)
            n1 = F.add(F.double(F.double(t0)), t2)
            n0 = F.add(t3, n1)
            n2 = F.add(t2, n3)
        out = torch.stack([n0, n1, n2, n3], dim=2)  # (W, t/4, 4, *batch)
        if t == 4:
            return out.reshape(st.shape)
        # block-circulant: each 4-lane block adds the sum over blocks
        tot = out[:, 0]
        for b in range(1, t // 4):
            tot = F.add(tot, out[:, b])
        return F.add(out, tot[:, None]).reshape(st.shape)

    def _mix_internal(self, st):
        F = self.F
        s = F.sum(st, 1)
        diag = self.int_diag.reshape(self.int_diag.shape + (1,) * (st.ndim - 2))
        scaled = F.mul(st, diag)
        if self.int_rinv is None:  # horizen: v_i d_i + sum
            return F.add(scaled, s[:, None])
        rinv = self.int_rinv.reshape(self.int_rinv.shape + (1,) * (s.ndim - 1))
        return F.add(scaled, F.mul(s, rinv)[:, None])

    # --- permutation -------------------------------------------------------------
    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """state: (W, t, *batch) Montgomery words -> the same; the input is
        not written."""
        F = self.F
        half = self.full_rounds // 2
        bshape = (1,) * (state.ndim - 2)
        st = self._mix_external(state)

        def full_round(st, r):
            rc = self.ark_full[:, r]
            st = F.add(st, rc.reshape(rc.shape + bshape))
            return self._mix_external(self._sbox(st))

        for r in range(half):
            st = full_round(st, r)
        for r in range(self.partial_rounds):
            rc = self.ark_partial[:, r]
            x0 = self._sbox(F.add(st[:, 0], rc.reshape(rc.shape + bshape)))
            st[:, 0] = x0  # st is this call's own tensor
            st = self._mix_internal(st)
        for r in range(half, self.full_rounds):
            st = full_round(st, r)
        return st

    # --- host-exact permutation (sequential challenger / transcript logic) ---
    def _mix_external_host(self, st: list) -> list:
        p, t = self.F.p, self.t
        if t == 2:
            s = (st[0] + st[1]) % p
            return [(st[0] + s) % p, (st[1] + s) % p]
        if t == 3:
            s = sum(st) % p
            return [(v + s) % p for v in st]
        out = [0] * t
        for b in range(0, t, 4):
            v0, v1, v2, v3 = st[b:b + 4]
            if self.external == "plonky3":
                t0 = v0 + v1
                t1 = v2 + v3
                t2 = t0 + t1
                t3 = t2 + v1
                t4 = t2 + v3
                n3 = (t4 + 2 * v0) % p
                n1 = (t3 + 2 * v2) % p
                n0 = (t3 + t0) % p
                n2 = (t4 + t1) % p
            else:
                t0 = v0 + v1
                t1 = v2 + v3
                t2 = 2 * v1 + t1
                t3 = 2 * v3 + t0
                n3 = (4 * t1 + t3) % p
                n1 = (4 * t0 + t2) % p
                n0 = (t3 + n1) % p
                n2 = (t2 + n3) % p
            out[b:b + 4] = [n0, n1, n2, n3]
        if t == 4:
            return out
        tot = [0] * 4
        for b in range(0, t, 4):
            for i in range(4):
                tot[i] = (tot[i] + out[b + i]) % p
        return [(out[b + i] + tot[i]) % p for b in range(0, t, 4) for i in range(4)]

    def _mix_internal_host(self, st: list) -> list:
        p = self.F.p
        s = sum(st) % p
        if self.int_rinv_host is None:
            return [(v * d + s) % p for v, d in zip(st, self.int_diag_host)]
        sr = s * self.int_rinv_host % p
        return [(v * d + sr) % p for v, d in zip(st, self.int_diag_host)]

    def permute_host(self, state: list) -> list:
        """Exact host-int permutation: the map of ``permute`` on canonical
        values.  The challenger's duplex uses it, where a device call per
        permutation would dominate the sequential Fiat-Shamir loop."""
        p, a = self.F.p, self.alpha
        half = self.full_rounds // 2
        st = self._mix_external_host([int(v) % p for v in state])
        for r in range(half):
            st = [pow((v + c) % p, a, p) for v, c in zip(st, self.ark_full_host[r])]
            st = self._mix_external_host(st)
        for rc in self.ark_partial_host:
            st[0] = pow((st[0] + rc) % p, a, p)
            st = self._mix_internal_host(st)
        for r in range(half, self.full_rounds):
            st = [pow((v + c) % p, a, p) for v, c in zip(st, self.ark_full_host[r])]
            st = self._mix_external_host(st)
        return st

    # --- sponge / compression ------------------------------------------------------
    def hash_no_pad(self, inputs: torch.Tensor, out_len: int,
                    rate: int | None = None) -> torch.Tensor:
        """PaddingFreeSponge (reference: sponge/padding_free_sponge.h): absorb
        rate-sized chunks of inputs (W, n, *batch) in overwrite mode, squeeze
        the first out_len -> (W, out_len, *batch)."""
        F, t = self.F, self.t
        if rate is None:
            rate = 8 if t == 16 else t - 1  # p3 takes rate 8 at width 16
        rate = min(rate, t)
        n = inputs.shape[1]
        st = F.zeros((t, *inputs.shape[2:]))
        for off in range(0, n, rate):
            chunk = inputs[:, off:off + rate]
            st[:, :chunk.shape[1]] = chunk  # overwrite mode (p3 PaddingFreeSponge)
            st = self.permute(st)
        return st[:, :out_len].contiguous()

    def compress(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """TruncatedPermutation 2-to-1 (reference: truncated_permutation.h):
        permute concat(l, r) (zero padded), keep the first len(l)."""
        F, t = self.F, self.t
        k = left.shape[1]
        parts = [left, right]
        if t > 2 * k:
            parts.append(F.zeros((t - 2 * k, *left.shape[2:])))
        return self.permute(torch.cat(parts, dim=1))[:, :k].contiguous()


# ---- standard instances (params from the reference's param_traits) --------------
@functools.lru_cache(maxsize=None)
def baby_bear_p3_w16(device=torch.device("cuda")) -> Poseidon2:
    """Plonky3/SP1 BabyBear width 16 (param_traits/poseidon2_baby_bear.h)."""
    return Poseidon2(PrimeField(presets.BABY_BEAR, device), width=16, alpha=7,
                     full_rounds=8, partial_rounds=13, internal="plonky3",
                     internal_shifts=[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15],
                     external="plonky3")


@functools.lru_cache(maxsize=None)
def baby_bear_w16_horizen_ext(device=torch.device("cuda")) -> Poseidon2:
    """BabyBear width 16 with the Horizen external matrix (the reference's
    unit-test flavour)."""
    return Poseidon2(PrimeField(presets.BABY_BEAR, device), width=16, alpha=7,
                     full_rounds=8, partial_rounds=13, internal="plonky3",
                     internal_shifts=[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15],
                     external="horizen")


GOLDILOCKS_W8_DIAG = [
    0xA98811A1FED4E3A5,
    0x1CC48B54F377E2A0,
    0xE40CD4F6C5609A26,
    0x11DE79EBCA97A4A3,
    0x9177C73D8B7E929C,
    0x2A6FE8085797E791,
    0x3DE6E93329F8D5AD,
    0x3F7AF9125DA962FE,
]


@functools.lru_cache(maxsize=None)
def goldilocks_w8(device=torch.device("cuda")) -> Poseidon2:
    """Goldilocks width 8, Horizen flavour (param_traits/poseidon2_goldilocks.h):
    every S-box and internal-matrix multiply is K1 at W = 2 on the card,
    the linear steps the word-ripple adds."""
    return Poseidon2(PrimeField(presets.GOLDILOCKS, device), width=8, alpha=7,
                     full_rounds=8, partial_rounds=22, internal="horizen",
                     internal_diag=GOLDILOCKS_W8_DIAG, external="horizen")


@functools.lru_cache(maxsize=None)
def bn254_w3(device=torch.device("cuda")) -> Poseidon2:
    """BN254 Fr width 3, Horizen flavour (param_traits/poseidon2_bn254.h)."""
    return Poseidon2(PrimeField(presets.BN254_FR, device), width=3, alpha=5,
                     full_rounds=8, partial_rounds=56, internal="horizen",
                     internal_diag=[1, 1, 2], external="horizen")
