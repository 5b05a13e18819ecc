"""RNGs for blinding: ChaCha20 and XorShift (Scroll-compatible).

The port's own copy of ``tachyon_tpu/crypto/rng.py``, so that the port
imports nothing of the JAX package; only its imports differ.

Analog of reference: tachyon/crypto/random/rng.h, rng_type.h (kChaCha20 via
boringssl, kXORShift for Scroll).  Host-side exact implementations.
"""
from __future__ import annotations

import struct


class XORShiftRNG:
    """xorshift128 as used by rand_xorshift (Scroll's seeded prover RNG)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 16
        self.x, self.y, self.z, self.w = struct.unpack("<IIII", seed)

    def next_u32(self) -> int:
        t = self.x ^ ((self.x << 11) & 0xFFFFFFFF)
        self.x, self.y, self.z = self.y, self.z, self.w
        self.w = (self.w ^ (self.w >> 19)) ^ (t ^ (t >> 8))
        return self.w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def next_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])


def _rotl(v, c):
    return ((v << c) | (v >> (32 - c))) & 0xFFFFFFFF


class ChaCha20RNG:
    """ChaCha20 keystream RNG (rand_chacha ChaCha20Rng layout: 32-byte seed,
    zero nonce, 64-byte blocks)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = struct.unpack("<8I", seed)
        self.counter = 0
        self._buf = b""

    def _block(self, counter: int) -> bytes:
        const = struct.unpack("<4I", b"expand 32-byte k")
        state = list(const) + list(self.key) + [
            counter & 0xFFFFFFFF,
            (counter >> 32) & 0xFFFFFFFF,
            0,
            0,
        ]
        w = list(state)

        def qr(a, b, c, d):
            w[a] = (w[a] + w[b]) & 0xFFFFFFFF
            w[d] = _rotl(w[d] ^ w[a], 16)
            w[c] = (w[c] + w[d]) & 0xFFFFFFFF
            w[b] = _rotl(w[b] ^ w[c], 12)
            w[a] = (w[a] + w[b]) & 0xFFFFFFFF
            w[d] = _rotl(w[d] ^ w[a], 8)
            w[c] = (w[c] + w[d]) & 0xFFFFFFFF
            w[b] = _rotl(w[b] ^ w[c], 7)

        for _ in range(10):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        out = [(w[i] + state[i]) & 0xFFFFFFFF for i in range(16)]
        return struct.pack("<16I", *out)

    def next_bytes(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += self._block(self.counter)
            self.counter += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def next_u32(self) -> int:
        return int.from_bytes(self.next_bytes(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(self.next_bytes(8), "little")


def random_field_element(rng, p: int) -> int:
    """rejection-free wide reduction (64 extra bits)."""
    nbytes = (p.bit_length() + 7) // 8 + 8
    return int.from_bytes(rng.next_bytes(nbytes), "little") % p
