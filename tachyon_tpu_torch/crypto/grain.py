"""Grain LFSR for Poseidon/Poseidon2 parameter derivation (arkworks spec).

The port's own copy of ``tachyon_tpu/crypto/grain.py`` (which imports no
JAX), so that the port imports nothing of the JAX package.

Host-side pure Python (parameters are computed once at config time).
Reference behavior: tachyon/crypto/hashes/sponge/poseidon/poseidon_grain_lfsr.h
(arkworks-compatible bit filtering + rejection sampling).
"""
from __future__ import annotations


class GrainLFSR:
    def __init__(
        self,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
        is_sbox_an_inverse: bool = False,
    ):
        self.n = prime_num_bits
        state = [False] * 80
        state[1] = True  # field type marker
        state[5] = is_sbox_an_inverse

        def fill(value: int, start: int, end: int):
            for i in range(end, start - 1, -1):
                state[i] = bool(value & 1)
                value >>= 1

        fill(prime_num_bits, 6, 17)
        fill(state_len, 18, 29)
        fill(num_full_rounds, 30, 39)
        fill(num_partial_rounds, 40, 49)
        for i in range(50, 80):
            state[i] = True
        self.state = state
        self.head = 0
        for _ in range(160):
            self._update()

    def _update(self) -> bool:
        s, h = self.state, self.head
        new_bit = (
            s[(h + 62) % 80]
            ^ s[(h + 51) % 80]
            ^ s[(h + 38) % 80]
            ^ s[(h + 23) % 80]
            ^ s[(h + 13) % 80]
            ^ s[h]
        )
        s[h] = new_bit
        self.head = (h + 1) % 80
        return new_bit

    def get_bits(self, num_bits: int) -> list[bool]:
        out = []
        for _ in range(num_bits):
            first = self._update()
            while not first:
                self._update()  # discard the pair's second bit
                first = self._update()
            out.append(self._update())
        return out

    def _bits_to_int_be(self, bits: list[bool]) -> int:
        # bit 0 is the most significant (BigInt::FromBitsBE)
        v = 0
        for b in bits:
            v = (v << 1) | int(b)
        return v

    def field_elements_rejection_sampling(self, p: int, num: int) -> list[int]:
        out = []
        while len(out) < num:
            v = self._bits_to_int_be(self.get_bits(self.n))
            if v < p:
                out.append(v)
        return out

    def field_elements_mod_p(self, p: int, num: int) -> list[int]:
        return [
            self._bits_to_int_be(self.get_bits(self.n)) % p for _ in range(num)
        ]
