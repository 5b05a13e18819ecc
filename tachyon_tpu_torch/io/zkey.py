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
of them (one K1 launch on the card).  The C++ mmap fast path of the JAX
package (``io/native``) is not ported: ``parse_wtns`` is its pure-Python path.
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


def _points(data: bytes, off: int, count: int, n8: int, coords: int) -> torch.Tensor:
    """``count`` points of ``coords`` coordinates at ``off`` -> (W, count, coords)."""
    W = n8 // 4
    raw = np.frombuffer(data, dtype="<u4", count=count * coords * W, offset=off)
    return _word_tensor(raw.reshape(count, coords, W).transpose(2, 0, 1))


def _scalar_spec(r: int):
    for f in presets.ALL_FIELDS:
        if f.p == r:
            return f
    raise ValueError(f"no field preset has the zkey's scalar modulus {r}")


def parse_zkey(path: str, device=torch.device("cuda")) -> ZKeyData:
    """Read a Groth16 zkey; the coefficient values are normalised on
    ``device`` (the card unless the caller passes another)."""
    with open(path, "rb") as f:
        data = f.read()
    version, sections = _read_sections(data, ZKEY_MAGIC)

    off, _ = sections[S_HEADER][0]
    (prover_type,) = struct.unpack_from("<I", data, off)
    if prover_type != 1:
        raise ValueError(f"prover type {prover_type}: only Groth16 zkeys are supported")

    off, _ = sections[S_HEADER_GROTH][0]
    (n8q,) = struct.unpack_from("<I", data, off)
    q = int.from_bytes(data[off + 4 : off + 4 + n8q], "little")
    off2 = off + 4 + n8q
    (n8r,) = struct.unpack_from("<I", data, off2)
    r = int.from_bytes(data[off2 + 4 : off2 + 4 + n8r], "little")
    off3 = off2 + 4 + n8r
    num_vars, num_public, domain_size = struct.unpack_from("<III", data, off3)
    off4 = off3 + 12
    # vk points: alpha1, beta1, beta2, gamma2, delta1, delta2
    vk = {}
    for name, coords in (("alpha_g1", 2), ("beta_g1", 2), ("beta_g2", 4),
                         ("gamma_g2", 4), ("delta_g1", 2), ("delta_g2", 4)):
        vk[name] = _points(data, off4, 1, n8q, coords)[:, 0]
        off4 += coords * n8q

    off, _ = sections[S_IC][0]
    ic = _points(data, off, num_public + 1, n8q, 2)

    off, _ = sections[S_COEFFS][0]
    (num_coeffs,) = struct.unpack_from("<I", data, off)
    entry = 12 + n8r
    raw = np.frombuffer(
        data, dtype=np.uint8, count=num_coeffs * entry, offset=off + 4
    ).reshape(num_coeffs, entry)
    coeff_matrix = raw[:, 0:4].copy().view("<u4").reshape(-1)
    coeff_constraint = raw[:, 4:8].copy().view("<u4").reshape(-1)
    coeff_signal = raw[:, 8:12].copy().view("<u4").reshape(-1)
    # v R^2 -> v R: one Montgomery reduction over all values (the JAX
    # package's per-value v * R^-1 mod r)
    stored = _word_tensor(bytes_to_words(raw[:, 12:], n8r)).to(device)
    coeff_values = mont.mont_reduce(_scalar_spec(r), stored)

    def query(sid, count, coords):
        return _points(data, sections[sid][0][0], count, n8q, coords)

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


def parse_wtns(path: str) -> tuple[int, torch.Tensor]:
    """(modulus, (W, n) int32 standard-form words on the host)."""
    with open(path, "rb") as f:
        data = f.read()
    version, sections = _read_sections(data, WTNS_MAGIC)
    off, _ = sections[1][0]
    (n8,) = struct.unpack_from("<I", data, off)
    modulus = int.from_bytes(data[off + 4 : off + 4 + n8], "little")
    (num,) = struct.unpack_from("<I", data, off + 4 + n8)
    off, _ = sections[2][0]
    raw = np.frombuffer(data, dtype=np.uint8, count=num * n8, offset=off)
    return modulus, _word_tensor(bytes_to_words(raw.reshape(num, n8), n8))
