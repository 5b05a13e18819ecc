"""snarkjs .zkey / .wtns binary parsers (Groth16, BN254).

Port of ``tachyon_tpu/io/zkey.py``.  Field elements in the zkey are
little-endian Montgomery residues with R = 2^256, the port's Montgomery
domain, so the bytes of a coordinate are its eight 32-bit words: point
arrays are read with ``np.frombuffer`` and transposed, with no arithmetic.
They are word for word the JAX package's 16-bit limb arrays, repacked
(``fields/limbs.from_jax_limbs``).  Witness values are standard form.

The zkey's coefficient values carry one Montgomery factor too many
(v R^2 mod r).  The JAX package divides each by R in a Python loop; that is
a Montgomery reduction, so the port runs one ``mont.mont_reduce`` over all
of them (one K1 launch on the card).

Both parsers read through the C++ mmap parser of ``io/native`` by default
(built at first use; a failed build raises); ``native=False`` reads the
file into memory and parses it in Python, the oracle of the native path.
The two share one parse over a source (``_BytesSource``, ``_NativeSource``)
that finds sections and gathers words.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.ops import mont

ZKEY_MAGIC = b"zkey"
WTNS_MAGIC = b"wtns"

# section ids (the JAX package's, from the reference's zkey.h ZKeySectionType)
S_HEADER = 1
S_HEADER_GROTH = 2
S_IC = 3
S_COEFFS = 4
S_POINTS_A1 = 5
S_POINTS_B1 = 6
S_POINTS_B2 = 7
S_POINTS_C1 = 8
S_POINTS_H1 = 9


def _read_sections(data: bytes, magic: bytes):
    if data[:4] != magic:
        raise ValueError(f"bad magic {data[:4]!r}, expected {magic!r}")
    version, num_sections = struct.unpack_from("<II", data, 4)
    sections = {}
    off = 12
    for _ in range(num_sections):
        typ, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections.setdefault(typ, []).append((off, size))
        off += size
    return version, sections


def bytes_to_words(buf: np.ndarray, n8: int) -> np.ndarray:
    """(n, n8) uint8 little-endian elements -> (n8 // 4, n) uint32 words."""
    return np.ascontiguousarray(
        np.ascontiguousarray(buf).view("<u4").reshape(buf.shape[0], n8 // 4).T)


def _word_tensor(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> int32 tensor with the same bits (the port's storage)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@dataclass
class ZKeyData:
    n8q: int
    n8r: int
    q: int
    r: int
    num_vars: int
    num_public: int
    domain_size: int
    # verifying key points, (W, 2) int32 Montgomery words: x, y columns
    alpha_g1: torch.Tensor
    beta_g1: torch.Tensor
    beta_g2: torch.Tensor  # (W, 4): x0, x1, y0, y1
    gamma_g2: torch.Tensor
    delta_g1: torch.Tensor
    delta_g2: torch.Tensor
    # query points on the host: (W, n, 2) G1 / (W, n, 4) G2 Montgomery words
    ic: torch.Tensor
    points_a1: torch.Tensor
    points_b1: torch.Tensor
    points_b2: torch.Tensor
    points_c1: torch.Tensor
    points_h1: torch.Tensor
    # coefficients: (matrix, constraint, signal) uint32 arrays, and the
    # values as (W, nc) Montgomery words on the parse's device
    coeff_matrix: np.ndarray
    coeff_constraint: np.ndarray
    coeff_signal: np.ndarray
    coeff_values: torch.Tensor


class _BytesSource:
    """The whole file in memory, parsed in Python."""

    def __init__(self, path: str, magic: bytes):
        with open(path, "rb") as f:
            self.data = f.read()
        _, self.sections = _read_sections(self.data, magic)

    def section(self, typ: int) -> int:
        return self.sections[typ][0][0]

    def bytes(self, off: int, n: int) -> bytes:
        return self.data[off:off + n]

    def _records(self, off: int, n: int, stride: int) -> np.ndarray:
        return np.frombuffer(self.data, dtype=np.uint8, count=n * stride,
                             offset=off).reshape(n, stride)

    def words(self, off: int, n: int, W: int, stride: int | None = None,
              value_off: int = 0) -> np.ndarray:
        raw = self._records(off, n, stride or 4 * W)
        return bytes_to_words(raw[:, value_off:value_off + 4 * W], 4 * W)

    def u32s(self, off: int, n: int, stride: int, field_off: int) -> np.ndarray:
        raw = self._records(off, n, stride)
        return raw[:, field_off:field_off + 4].copy().view("<u4").reshape(-1)

    def close(self):
        pass


class _NativeSource:
    """The file mapped by the C++ parser (``io/native``)."""

    def __init__(self, path: str, magic: bytes):
        from tachyon_tpu_torch.io.native import NativeFile

        self.f = NativeFile(path)
        head = self.f.read_bytes(0, 4) if self.f.size >= 4 else b""
        if head != magic:
            self.f.close()
            raise ValueError(f"bad magic {head!r}, expected {magic!r}")
        self.bytes = self.f.read_bytes
        self.words = self.f.gather_words
        self.u32s = self.f.gather_u32

    def section(self, typ: int) -> int:
        off, _ = self.f.find_section(typ)
        if off is None:
            raise ValueError(f"section {typ} is missing or runs past the end of the file")
        return off

    def close(self):
        self.f.close()


def _open(path: str, magic: bytes, native: bool):
    return (_NativeSource if native else _BytesSource)(path, magic)


def _u32(src, off: int) -> int:
    return struct.unpack("<I", src.bytes(off, 4))[0]


def _points(src, off: int, count: int, n8: int, coords: int) -> torch.Tensor:
    """``count`` points of ``coords`` coordinates at ``off`` -> (W, count, coords)."""
    W = n8 // 4
    return _word_tensor(src.words(off, count * coords, W).reshape(W, count, coords))


def _scalar_spec(r: int):
    for f in presets.ALL_FIELDS:
        if f.p == r:
            return f
    raise ValueError(f"no field preset has the zkey's scalar modulus {r}")


def parse_zkey(path: str, device=torch.device("cuda"), native: bool = True) -> ZKeyData:
    """Read a Groth16 zkey; the coefficient values are normalised on
    ``device`` (the card unless the caller passes another).  ``native``
    selects the mmap parser (default) or the pure-Python one."""
    src = _open(path, ZKEY_MAGIC, native)
    try:
        return _parse_zkey(src, device)
    finally:
        src.close()


def _parse_zkey(src, device) -> ZKeyData:
    prover_type = _u32(src, src.section(S_HEADER))
    if prover_type != 1:
        raise ValueError(f"prover type {prover_type}: only Groth16 zkeys are supported")

    off = src.section(S_HEADER_GROTH)
    n8q = _u32(src, off)
    q = int.from_bytes(src.bytes(off + 4, n8q), "little")
    off2 = off + 4 + n8q
    n8r = _u32(src, off2)
    r = int.from_bytes(src.bytes(off2 + 4, n8r), "little")
    off3 = off2 + 4 + n8r
    num_vars, num_public, domain_size = struct.unpack("<III", src.bytes(off3, 12))
    off4 = off3 + 12
    # vk points: alpha1, beta1, beta2, gamma2, delta1, delta2
    vk = {}
    for name, coords in (("alpha_g1", 2), ("beta_g1", 2), ("beta_g2", 4),
                         ("gamma_g2", 4), ("delta_g1", 2), ("delta_g2", 4)):
        vk[name] = _points(src, off4, 1, n8q, coords)[:, 0]
        off4 += coords * n8q

    ic = _points(src, src.section(S_IC), num_public + 1, n8q, 2)

    off = src.section(S_COEFFS)
    num_coeffs = _u32(src, off)
    entry = 12 + n8r
    coeff_matrix, coeff_constraint, coeff_signal = (
        src.u32s(off + 4, num_coeffs, entry, k) for k in (0, 4, 8))
    # v R^2 -> v R: one Montgomery reduction over all values (the JAX
    # package's per-value v * R^-1 mod r)
    stored = _word_tensor(src.words(off + 4, num_coeffs, n8r // 4, entry, 12)).to(device)
    coeff_values = mont.mont_reduce(_scalar_spec(r), stored)

    def query(sid, count, coords):
        return _points(src, src.section(sid), count, n8q, coords)

    return ZKeyData(
        n8q=n8q, n8r=n8r, q=q, r=r,
        num_vars=num_vars, num_public=num_public, domain_size=domain_size,
        **vk, ic=ic,
        points_a1=query(S_POINTS_A1, num_vars, 2),
        points_b1=query(S_POINTS_B1, num_vars, 2),
        points_b2=query(S_POINTS_B2, num_vars, 4),
        points_c1=query(S_POINTS_C1, num_vars - num_public - 1, 2),
        points_h1=query(S_POINTS_H1, domain_size, 2),
        coeff_matrix=coeff_matrix, coeff_constraint=coeff_constraint,
        coeff_signal=coeff_signal, coeff_values=coeff_values,
    )


def parse_wtns(path: str, native: bool = True) -> tuple[int, torch.Tensor]:
    """(modulus, (W, n) int32 standard-form words on the host); ``native``
    selects the mmap parser (default) or the pure-Python one."""
    src = _open(path, WTNS_MAGIC, native)
    try:
        off = src.section(1)
        n8 = _u32(src, off)
        modulus = int.from_bytes(src.bytes(off + 4, n8), "little")
        num = _u32(src, off + 4 + n8)
        return modulus, _word_tensor(src.words(src.section(2), num, n8 // 4))
    finally:
        src.close()
