"""Endian-aware binary buffers + per-type Copyable serialization.

The port's own copy of ``tachyon_tpu/base/buffer.py``, which is host-only
and imports no JAX: the port imports nothing of the JAX package, and the
bytes are the same (``tests/test_torch_buffer.py``).

Analog of the reference's serialization substrate
(reference: tachyon/base/buffer/buffer.h Buffer::Write/Read and
tachyon/base/buffer/copyable.h Copyable<T> specializations): every
key/proof object serializes to a flat little-endian byte buffer with a
fixed, versioned layout, so provers can persist and reload state
(checkpoint/resume) and ship proofs across the C ABI without JSON
overhead.

Layout conventions (all little-endian):
* u8/u32/u64        — fixed-width unsigned integers
* field element     — ceil(bits/8) bytes, canonical (value < p)
* G1 affine point   — two field elements (x, y); infinity = all-zero
* G2 affine point   — four base-field elements (x0, x1, y0, y1)
* vec<T>            — u64 count then count items
* bytes             — u64 length then raw bytes
"""
from __future__ import annotations

import struct
from typing import Callable


class Buffer:
    """Write-side binary buffer (reference: base/buffer/buffer.h)."""

    def __init__(self):
        self._parts: list[bytes] = []

    # -- primitive writes ---------------------------------------------------
    def write_u8(self, v: int) -> "Buffer":
        self._parts.append(struct.pack("<B", v))
        return self

    def write_u32(self, v: int) -> "Buffer":
        self._parts.append(struct.pack("<I", v))
        return self

    def write_u64(self, v: int) -> "Buffer":
        self._parts.append(struct.pack("<Q", v))
        return self

    def write_bytes(self, b: bytes) -> "Buffer":
        self.write_u64(len(b))
        self._parts.append(bytes(b))
        return self

    def write_raw(self, b: bytes) -> "Buffer":
        self._parts.append(bytes(b))
        return self

    def write_field(self, v: int, p: int) -> "Buffer":
        if not (0 <= v < p):
            raise ValueError("non-canonical field element")
        nbytes = (p.bit_length() + 7) // 8
        self._parts.append(int(v).to_bytes(nbytes, "little"))
        return self

    def write_vec(self, items, write_one: Callable) -> "Buffer":
        self.write_u64(len(items))
        for it in items:
            write_one(self, it)
        return self

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class ReadBuffer:
    """Read-side cursor over a byte string; every read bounds-checks and
    raises ValueError on truncation (mirrors Buffer::Read's bool returns)."""

    def __init__(self, data: bytes):
        self._d = data
        self._off = 0

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._d):
            raise ValueError("buffer truncated")
        b = self._d[self._off:self._off + n]
        self._off += n
        return b

    def read_u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def read_u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def read_u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def read_bytes(self) -> bytes:
        return self._take(self.read_u64())

    def read_field(self, p: int) -> int:
        nbytes = (p.bit_length() + 7) // 8
        v = int.from_bytes(self._take(nbytes), "little")
        if v >= p:
            raise ValueError("non-canonical field element")
        return v

    def read_vec(self, read_one: Callable, min_size: int = 1) -> list:
        """min_size: smallest number of bytes read_one can legally consume;
        a hostile count exceeding remaining/min_size is rejected before any
        element is read (and before allocating the result list)."""
        n = self.read_u64()
        remaining = len(self._d) - self._off
        if n > remaining // max(min_size, 1):
            raise ValueError("vec count exceeds buffer")
        return [read_one(self) for _ in range(n)]

    def done(self) -> bool:
        return self._off == len(self._d)


# -- point codecs (uncompressed; infinity = all-zero) -----------------------

def write_g1(buf: Buffer, pt, p: int) -> None:
    # no silent % p: write_field's canonicality check raises on bad input,
    # matching the read side's rejection of non-canonical encodings
    if pt is None:
        buf.write_field(0, p).write_field(0, p)
    else:
        buf.write_field(pt[0], p).write_field(pt[1], p)


def read_g1(buf: ReadBuffer, p: int):
    x, y = buf.read_field(p), buf.read_field(p)
    return None if (x == 0 and y == 0) else (x, y)


def write_g2(buf: Buffer, pt, p: int) -> None:
    if pt is None:
        for _ in range(4):
            buf.write_field(0, p)
    else:
        (x0, x1), (y0, y1) = pt
        for c in (x0, x1, y0, y1):
            buf.write_field(c, p)


def read_g2(buf: ReadBuffer, p: int):
    x0, x1, y0, y1 = (buf.read_field(p) for _ in range(4))
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0, x1), (y0, y1))


# -- Copyable registry ------------------------------------------------------

_MAGIC = b"TTPU"
_VERSION = 1


def serialize(kind: str, write_body: Callable[[Buffer], None]) -> bytes:
    """Framed serialization: magic, version, kind tag, then the body
    (the version/tag frame plays the role of Copyable's static typing)."""
    buf = Buffer()
    buf.write_raw(_MAGIC).write_u8(_VERSION).write_bytes(kind.encode())
    write_body(buf)
    return buf.getvalue()


def deserialize(data: bytes, kind: str) -> ReadBuffer:
    buf = ReadBuffer(data)
    if buf._take(4) != _MAGIC:
        raise ValueError("bad magic")
    ver = buf.read_u8()
    if ver != _VERSION:
        raise ValueError(f"unsupported version {ver}")
    got = buf.read_bytes().decode()
    if got != kind:
        raise ValueError(f"kind mismatch: want {kind}, got {got}")
    return buf


# -- concrete object codecs -------------------------------------------------

def groth16_proof_to_bytes(proof, q: int) -> bytes:
    """Groth16Proof{a: G1, b: G2, c: G1} (reference: the Copyable<Proof>
    specialization in zk/r1cs/groth16/proof.h)."""
    def body(buf: Buffer):
        write_g1(buf, proof.a, q)
        write_g2(buf, proof.b, q)
        write_g1(buf, proof.c, q)
    return serialize("groth16.proof", body)


def groth16_proof_from_bytes(data: bytes, q: int, cls):
    buf = deserialize(data, "groth16.proof")
    a = read_g1(buf, q)
    b = read_g2(buf, q)
    c = read_g1(buf, q)
    if not buf.done():
        raise ValueError("trailing bytes")
    return cls(a=a, b=b, c=c)
