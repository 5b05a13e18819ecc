"""Challengers (Fiat-Shamir for the STARK/FRI path), Plonky3-compatible.

Port of ``tachyon_tpu/crypto/challenger.py`` (reference:
tachyon/crypto/challenger/{challenger.h,duplex_challenger.h,
multi_field32_challenger.h,hash_challenger.h}): ``DuplexChallenger``,
``MultiField32Challenger`` and ``HashChallenger``.  The transcript is
sequential host logic on exact Python ints through
``Poseidon2.permute_host``; only the duplex challenger's proof-of-work
grind runs on the device, a batch of candidate witnesses per permutation
call.
"""
from __future__ import annotations

import torch

from tachyon_tpu_torch.crypto.poseidon2 import Poseidon2

GRIND_BATCH = 1 << 16  # candidates per device call at 16 bits and above


class DuplexChallenger:
    """Duplex sponge challenger (reference: duplex_challenger.h)."""

    def __init__(self, perm: Poseidon2, rate: int):
        self.perm = perm
        self.R = rate
        self.F = perm.F
        self.t = perm.t
        self._state = [0] * perm.t  # canonical Python ints
        self._inputs: list[int] = []
        self._outputs: list[int] = []

    # --- core ------------------------------------------------------------------
    def _duplex(self):
        for i, v in enumerate(self._inputs):
            self._state[i] = v % self.F.p
        self._inputs.clear()
        self._state = self.perm.permute_host(self._state)
        self._outputs = list(self._state)

    def observe(self, value: int):
        self._outputs.clear()
        self._inputs.append(int(value) % self.F.p)
        if len(self._inputs) == self.R:
            self._duplex()

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def sample(self) -> int:
        if self._inputs or not self._outputs:
            self._duplex()
        return self._outputs.pop()

    def sample_array(self, n: int) -> list[int]:
        return [self.sample() for _ in range(n)]

    def sample_ext(self, degree: int) -> list[int]:
        """An extension element as a list of base coefficients."""
        return self.sample_array(degree)

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    # --- proof-of-work grinding (reference: challenger.h Grind) ---------------
    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int, max_iter: int = 1 << 22) -> int:
        """The least witness w such that a clone observing w samples ``bits``
        zero bits, as the sequential loop finds it.

        ``check_witness(w)`` is one duplex permutation of the current state
        with the pending inputs and w written into the rate lanes, then a
        mask test of the popped element (lane t - 1).  So candidates go
        through the device ``permute`` a batch at a time, in witness order,
        and the first hit is the sequential loop's witness.  A batch holds
        2^(bits + 1) candidates (about two hits), at most GRIND_BATCH.  The
        candidates are encoded and tested on the device: one-word fields."""
        F, t = self.F, self.t
        pend = [int(v) % F.p for v in self._inputs]
        k = len(pend)
        if k >= self.R:
            raise ValueError("pending inputs fill the rate")
        mask = (1 << bits) - 1
        base = list(self._state)
        base[:k] = pend
        fixed = F.encode(base)  # (W, t)
        batch = min(GRIND_BATCH, 1 << (bits + 1))
        for start in range(0, max_iter, batch):
            ws = torch.arange(start, min(start + batch, max_iter), device=F.device)
            st = fixed[:, :, None].repeat(1, 1, ws.numel())
            st[:, k] = F.encode_canonical(ws)[0]
            hits = torch.nonzero((F.to_canonical(self.perm.permute(st)[:, t - 1]) & mask) == 0)
            if hits.numel():
                w = start + int(hits[0, 0])
                self.observe(w)
                if self.sample_bits(bits) != 0:
                    raise AssertionError("grind: the device permutation disagrees with the host")
                return w
        raise RuntimeError("grind failed")

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger.__new__(DuplexChallenger)
        c.perm, c.R, c.F, c.t = self.perm, self.R, self.F, self.t
        c._state = list(self._state)
        c._inputs = list(self._inputs)
        c._outputs = list(self._outputs)
        return c


class MultiField32Challenger:
    """Challenger over a big-field permutation (BN254's Poseidon2) that
    gives 32-bit field challenges (reference: multi_field32_challenger.h,
    multi_field32_conversions.h Reduce/Split), for recursive STARK
    verification inside a SNARK.  ``small_p``: the small field's modulus
    (at most 32 bits)."""

    def __init__(self, perm: Poseidon2, small_p: int):
        self.perm = perm
        self.small_p = small_p
        self.big_p = perm.F.p
        self.num_f = perm.F.spec.bits // 64  # 64-bit digits of a big element
        self.R = self.num_f * perm.t
        self._state = [0] * perm.t
        self._inputs: list[int] = []
        self._outputs: list[int] = []

    def _duplex(self):
        n = self.num_f
        for i in range((len(self._inputs) + n - 1) // n):
            group = self._inputs[i * n:(i + 1) * n]
            # 32-bit values packed little-endian into one big element
            self._state[i] = sum(int(x) << (32 * j) for j, x in enumerate(group)) % self.big_p
        self._inputs.clear()
        self._state = self.perm.permute_host(self._state)
        self._outputs = [((s >> (64 * j)) & ((1 << 64) - 1)) % self.small_p
                         for s in self._state for j in range(n)]

    def observe(self, value: int):
        self._outputs.clear()
        self._inputs.append(int(value) % self.small_p)
        if len(self._inputs) == self.R:
            self._duplex()

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def sample(self) -> int:
        if self._inputs or not self._outputs:
            self._duplex()
        return self._outputs.pop()

    def sample_array(self, n: int) -> list[int]:
        return [self.sample() for _ in range(n)]

    def sample_ext(self, degree: int) -> list[int]:
        return self.sample_array(degree)

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def clone(self) -> "MultiField32Challenger":
        c = MultiField32Challenger.__new__(MultiField32Challenger)
        c.perm, c.small_p, c.big_p, c.num_f, c.R = (self.perm, self.small_p, self.big_p,
                                                    self.num_f, self.R)
        c._state = list(self._state)
        c._inputs = list(self._inputs)
        c._outputs = list(self._outputs)
        return c


class HashChallenger:
    """Hash-based challenger (reference: hash_challenger.h): a sample
    flushes the inputs through the padding-free sponge on host ints; the
    digest seeds the next input buffer."""

    def __init__(self, perm: Poseidon2, out_len: int = 8, rate: int | None = None):
        self.perm = perm
        self.F = perm.F
        self.out_len = out_len
        self.rate = rate if rate is not None else (8 if perm.t == 16 else perm.t - 1)
        self._inputs: list[int] = []
        self._outputs: list[int] = []

    def _hash_host(self, values: list[int]) -> list[int]:
        """PaddingFreeSponge on host ints (overwrite-mode absorb)."""
        p, t, rate = self.F.p, self.perm.t, self.rate
        st = [0] * t
        for off in range(0, len(values), rate):
            chunk = values[off:off + rate]
            st[:len(chunk)] = [int(v) % p for v in chunk]
            st = self.perm.permute_host(st)
        return st[:self.out_len]

    def observe(self, value: int):
        self._outputs.clear()
        self._inputs.append(int(value) % self.F.p)

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def sample(self) -> int:
        if not self._outputs:
            out = self._hash_host(self._inputs)
            self._outputs = list(out)
            self._inputs = list(out)
        return self._outputs.pop()

    def sample_array(self, n: int) -> list[int]:
        return [self.sample() for _ in range(n)]

    def clone(self) -> "HashChallenger":
        c = HashChallenger.__new__(HashChallenger)
        c.perm, c.F, c.out_len, c.rate = self.perm, self.F, self.out_len, self.rate
        c._inputs = list(self._inputs)
        c._outputs = list(self._outputs)
        return c
