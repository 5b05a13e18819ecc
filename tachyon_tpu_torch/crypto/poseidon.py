"""Original Poseidon sponge (arkworks-compatible), vectorized.

Port of ``tachyon_tpu/crypto/poseidon.py`` over the port's ``PrimeField``
(BN254's Fr in the halo2 transcripts: K1 at W = 8 for every product on the
card).  A state is a ``(W, t, *batch)`` word tensor; the ARK rows and the
MDS matrix are derived on the host from the arkworks Grain LFSR
(``crypto/grain.py``), as in the JAX package, and encoded once on the
field's device.  ``permute_host`` is the same map on Python ints, for the
sequential host logic of the transcripts.

Analog of the reference's PoseidonSponge
(reference: tachyon/crypto/hashes/sponge/poseidon/{poseidon.h,
poseidon_config.h FindPoseidonARKAndMDS, poseidon_sponge_base.h}).
The permutation here is the *plain* MDS form; the reference's sparse-MDS
factorization is a performance rewrite of the same map.
"""
from __future__ import annotations

import numpy as np
import torch

from tachyon_tpu_torch.crypto.grain import GrainLFSR
from tachyon_tpu_torch.math.field import PrimeField


class Poseidon:
    def __init__(
        self,
        F: PrimeField,
        rate: int,
        alpha: int,
        full_rounds: int,
        partial_rounds: int,
        capacity: int = 1,
        skip_matrices: int = 0,
    ):
        self.F = F
        self.rate = rate
        self.capacity = capacity
        self.t = rate + capacity
        self.alpha = alpha
        self.full_rounds = full_rounds
        self.partial_rounds = partial_rounds
        p = F.p

        lfsr = GrainLFSR(F.spec.bits, rate + 1, full_rounds, partial_rounds)
        rounds = full_rounds + partial_rounds
        ark = [
            lfsr.field_elements_rejection_sampling(p, self.t)
            for _ in range(rounds)
        ]
        for _ in range(skip_matrices):
            lfsr.field_elements_mod_p(p, 2 * self.t)
        xs = lfsr.field_elements_mod_p(p, self.t)
        ys = lfsr.field_elements_mod_p(p, self.t)
        mds = [
            [pow((x + y) % p, p - 2, p) for y in ys] for x in xs
        ]
        self.ark_host = ark  # rounds x t python ints
        self.mds_host = mds  # t x t
        self.ark = F.encode(np.array(ark, dtype=object))  # (W, rounds, t)
        self.mds = F.encode(np.array(mds, dtype=object))  # (W, t, t)

    # --- permutation ---------------------------------------------------------
    def _sbox(self, x):
        return self.F.pow_const(x, self.alpha)

    def _mix(self, st):
        """MDS matvec: st (W, t, *batch)."""
        F, t = self.F, self.t
        batch = st.shape[2:]
        mds = self.mds.reshape(self.mds.shape[:3] + (1,) * len(batch))
        prod = F.mul(mds, st[:, None])  # (W, t, t, *batch)
        acc = prod[:, :, 0]
        for j in range(1, t):
            acc = F.add(acc, prod[:, :, j])
        return acc

    def _ark_full(self, st, i: int):
        rc = self.ark[:, i]
        return self.F.add(st, rc.reshape(rc.shape + (1,) * (st.ndim - 2)))

    def permute(self, st: torch.Tensor) -> torch.Tensor:
        """st: (W, t, *batch).

        Plain arkworks round order (ARK -> sbox -> MDS each round, full ARK
        rows even in partial rounds), as the JAX package's ``permute``.
        """
        half = self.full_rounds // 2
        total = self.full_rounds + self.partial_rounds
        for i in range(total):
            st = self._ark_full(st, i)
            if half <= i < half + self.partial_rounds:
                x0 = self._sbox(st[:, 0])
                st = torch.cat([x0[:, None], st[:, 1:]], dim=1)
            else:
                st = self._sbox(st)
            st = self._mix(st)
        return st

    def permute_host(self, st: list) -> list:
        """Exact host-int permutation (same map as `permute`); used by
        sequential host logic (halo2 poseidon transcript) where a device
        round-trip per permutation would dominate."""
        p = self.F.p
        t = self.t
        half = self.full_rounds // 2
        total = self.full_rounds + self.partial_rounds
        st = [int(v) % p for v in st]
        for i in range(total):
            st = [(s + rc) % p for s, rc in zip(st, self.ark_host[i])]
            if half <= i < half + self.partial_rounds:
                st[0] = pow(st[0], self.alpha, p)
            else:
                st = [pow(s, self.alpha, p) for s in st]
            st = [
                sum(self.mds_host[r][c] * st[c] for c in range(t)) % p
                for r in range(t)
            ]
        return st


class PoseidonSpongeState:
    """Host-driven duplex sponge (arkworks absorb/squeeze semantics,
    reference: poseidon_sponge_base.h AbsorbInternal/SqueezeInternal); each
    permutation runs on the field's device."""

    def __init__(self, perm: Poseidon):
        self.perm = perm
        self.F = perm.F
        self.state = [0] * perm.t  # python ints
        self.mode = "absorbing"
        self.next_index = 0

    def _permute(self):
        F = self.F
        st = F.encode(np.array(self.state, dtype=object))[:, :, None]
        out = self.perm.permute(st)
        self.state = [int(v) for v in F.decode(out[:, :, 0])]

    def absorb(self, elements: list[int]):
        rate, cap, p = self.perm.rate, self.perm.capacity, self.F.p
        if self.mode == "absorbing":
            idx = self.next_index
            if idx == rate:
                self._permute()
                idx = 0
        else:
            self._permute()
            idx = 0
        i = 0
        while True:
            remaining = len(elements) - i
            if idx + remaining <= rate:
                for k in range(remaining):
                    self.state[cap + idx + k] = (
                        self.state[cap + idx + k] + elements[i + k]
                    ) % p
                self.mode = "absorbing"
                self.next_index = idx + remaining
                return
            take = rate - idx
            for k in range(take):
                self.state[cap + idx + k] = (
                    self.state[cap + idx + k] + elements[i + k]
                ) % p
            i += take
            self._permute()
            idx = 0

    def squeeze(self, n: int) -> list[int]:
        rate, cap = self.perm.rate, self.perm.capacity
        out = []
        if self.mode == "absorbing":
            self._permute()
            idx = 0
        else:
            idx = self.next_index
            if idx == rate:
                self._permute()
                idx = 0
        while len(out) < n:
            take = min(rate - idx, n - len(out))
            out.extend(self.state[cap + idx : cap + idx + take])
            idx += take
            if len(out) < n:
                self._permute()
                idx = 0
        self.mode = "squeezing"
        self.next_index = idx
        return out
