"""Halo2-compatible Fiat-Shamir transcripts (host-side, exact).

The port's own copy of ``tachyon_tpu/crypto/transcript.py``, so that the
port imports nothing of the JAX package; only its imports differ (the two
Poseidon cores take the port's ``crypto/poseidon.py``, its constants held on
the CPU: they run ``permute_host`` on Python ints).

Analog of the reference's transcript stack
(reference: tachyon/crypto/transcripts/transcript.h,
zk/plonk/halo2/blake2b_transcript.h, sha256_transcript.h,
proof_serializer.h, prime_field_conversion.h FromUint512).

Bit-compatible semantics:
  * Blake2b-512 with personalization "Halo2-Transcript";
  * domain prefixes: 0 = challenge squeeze, 1 = point, 2 = scalar;
  * points absorbed as x||y little-endian (infinity -> (0, 5));
  * challenge = (64 squeezed bytes as little-endian u512) mod r;
  * proof serialization: scalars raw LE; G1 points 32-byte compressed with
    the PSE ("legacy", 1 flag bit) or new (2 flag bit) layout.

Transcripts are host logic (sequential hashing); all values cross the
device boundary as python ints.
"""
from __future__ import annotations

import functools as _functools
import hashlib

from tachyon_tpu_torch.fields.spec import FieldSpec


class ProofDecodeError(ValueError):
    """Malformed proof bytes: non-canonical encoding, off-curve point, or
    truncated buffer.  Verifiers catch this and return False (a malformed
    proof must never crash a verifier or be accepted under a second
    encoding — proof malleability)."""


class Blake2bTranscript:
    """Writer/reader core: hash state + challenge derivation."""

    PREFIX_CHALLENGE = b"\x00"
    PREFIX_POINT = b"\x01"
    PREFIX_SCALAR = b"\x02"

    def __init__(self, scalar_spec: FieldSpec, base_spec: FieldSpec):
        self.r = scalar_spec.p
        self.q = base_spec.p
        self.n_base_bytes = (base_spec.bits + 63) // 64 * 8
        self.n_scalar_bytes = (scalar_spec.bits + 63) // 64 * 8
        self._h = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    # --- absorbing --------------------------------------------------------
    def common_point(self, point: tuple | None):
        """point: (x, y) ints or None for infinity."""
        self._h.update(self.PREFIX_POINT)
        if point is None:
            x, y = 0, 5
        else:
            x, y = point
        self._h.update(int(x).to_bytes(self.n_base_bytes, "little"))
        self._h.update(int(y).to_bytes(self.n_base_bytes, "little"))

    def common_scalar(self, scalar: int):
        self._h.update(self.PREFIX_SCALAR)
        self._h.update((int(scalar) % self.r).to_bytes(self.n_scalar_bytes, "little"))

    # --- squeezing ----------------------------------------------------------
    def squeeze_challenge(self) -> int:
        self._h.update(self.PREFIX_CHALLENGE)
        digest = self._h.copy().digest()
        return int.from_bytes(digest, "little") % self.r


def compress_g1(point: tuple | None, base_spec: FieldSpec, legacy: bool = True) -> bytes:
    """32-byte halo2 G1 compression (reference: proof_serializer.h)."""
    nb = (base_spec.bits + 63) // 64 * 8
    if point is None:
        if legacy:
            return (0).to_bytes(nb, "little")
        return (1 << (nb * 8 - 1)).to_bytes(nb, "little")
    x, y = point
    b = bytearray(int(x).to_bytes(nb, "little"))
    if legacy:
        if y & 1:
            b[-1] |= 0x80
    else:
        if y & 1:
            b[-1] |= 0x40
    return bytes(b)


def decompress_g1(data: bytes, base_spec: FieldSpec, b_coeff: int, legacy: bool = True):
    """inverse of compress_g1; returns (x, y) or None. b_coeff: curve b."""
    q = base_spec.p
    b = bytearray(data)
    if len(data) * 8 < q.bit_length():
        raise ProofDecodeError("truncated point encoding")
    if legacy:
        is_odd = b[-1] >> 7
        b[-1] &= 0x7F
        x = int.from_bytes(bytes(b), "little")
        if x == 0:
            return None
    else:
        is_inf = b[-1] >> 7
        is_odd = (b[-1] >> 6) & 1
        b[-1] &= 0x3F
        x = int.from_bytes(bytes(b), "little")
        if x == 0 and is_inf:
            return None
    if x >= q:
        # each point must have exactly one byte encoding
        raise ProofDecodeError("non-canonical x coordinate (x >= q)")
    rhs = (x * x * x + b_coeff) % q
    y = pow(rhs, (q + 1) // 4, q)  # q % 4 == 3 for bn254
    if (y * y) % q != rhs:
        raise ProofDecodeError("not on curve")
    if (y & 1) != is_odd:
        y = q - y
    return (x, y)


class TranscriptWriter(Blake2bTranscript):
    """Prover-side: absorbs and appends to the proof byte buffer."""

    def __init__(self, scalar_spec: FieldSpec, base_spec: FieldSpec, legacy=True):
        super().__init__(scalar_spec, base_spec)
        self.proof = bytearray()
        self.legacy = legacy

    def write_point(self, point: tuple | None):
        self.common_point(point)
        self.proof += compress_g1(point, FieldSpecShim(self.q), self.legacy)

    def write_scalar(self, scalar: int):
        self.common_scalar(scalar)
        self.proof += (int(scalar) % self.r).to_bytes(self.n_scalar_bytes, "little")


class TranscriptReader(Blake2bTranscript):
    """Verifier-side: reads the proof buffer and absorbs."""

    def __init__(self, proof: bytes, scalar_spec: FieldSpec, base_spec: FieldSpec,
                 b_coeff: int = 3, legacy=True):
        super().__init__(scalar_spec, base_spec)
        self.buf = memoryview(bytes(proof))
        self.off = 0
        self.legacy = legacy
        self.b_coeff = b_coeff

    def read_point(self):
        return _checked_read_point(self)

    def read_scalar(self) -> int:
        return _checked_read_scalar(self)


def _take(reader, nb: int) -> bytes:
    if reader.off + nb > len(reader.buf):
        raise ProofDecodeError("truncated proof")
    data = bytes(reader.buf[reader.off : reader.off + nb])
    reader.off += nb
    return data


def _checked_read_point(reader):
    data = _take(reader, reader.n_base_bytes)
    pt = decompress_g1(
        data, FieldSpecShim(reader.q), reader.b_coeff, reader.legacy
    )
    reader.common_point(pt)
    return pt


def _checked_read_scalar(reader) -> int:
    v = int.from_bytes(_take(reader, reader.n_scalar_bytes), "little")
    if v >= reader.r:
        # reject v >= r: otherwise v and v % r absorb identically, giving
        # every proof multiple byte encodings (malleability)
        raise ProofDecodeError("non-canonical scalar (v >= r)")
    reader.common_scalar(v)
    return v


class FieldSpecShim:
    """minimal duck-type for compress/decompress helpers."""

    def __init__(self, p: int):
        self.p = p
        self.bits = p.bit_length()


class Sha256Transcript:
    """halo2/Scroll sha256 transcript core (reference:
    zk/plonk/halo2/sha256_transcript.h Sha256Base).

    Semantics: absorbing writes 31 zero bytes + prefix + big-endian
    coordinates; squeeze appends the 1-byte challenge prefix, finalizes a
    state copy, then REPLACES the state with sha256(digest) chaining;
    challenge = u512(digest LE || zeros) mod r."""

    PREFIX_CHALLENGE = b"\x00"
    PREFIX_POINT = b"\x01"
    PREFIX_SCALAR = b"\x02"
    ZEROS = b"\x00" * 31

    def __init__(self, scalar_spec: FieldSpec, base_spec: FieldSpec):
        self.r = scalar_spec.p
        self.q = base_spec.p
        self.n_base_bytes = (base_spec.bits + 63) // 64 * 8
        self.n_scalar_bytes = (scalar_spec.bits + 63) // 64 * 8
        self._h = hashlib.sha256()

    def common_point(self, point: tuple | None):
        self._h.update(self.ZEROS)
        self._h.update(self.PREFIX_POINT)
        x, y = (0, 0) if point is None else point
        self._h.update(int(x).to_bytes(self.n_base_bytes, "big"))
        self._h.update(int(y).to_bytes(self.n_base_bytes, "big"))

    def common_scalar(self, scalar: int):
        self._h.update(self.ZEROS)
        self._h.update(self.PREFIX_SCALAR)
        self._h.update(
            (int(scalar) % self.r).to_bytes(self.n_scalar_bytes, "big")
        )

    def squeeze_challenge(self) -> int:
        self._h.update(self.PREFIX_CHALLENGE)
        digest = self._h.digest()
        self._h = hashlib.sha256()
        self._h.update(digest)
        return int.from_bytes(digest, "little") % self.r


class PoseidonTranscript:
    """halo2 poseidon transcript core (reference:
    zk/plonk/halo2/poseidon_transcript.h PoseidonBase; params
    BN254PoseidonParams9 = Fr, rate 8, alpha 5, 8 full / 63 partial rounds,
    PoseidonConfig::Create(0); kroma-network/poseidon duplex flavor:
    state[0] seeded with 2^64, absorb adds at state[i+1], squeeze appends
    the terminal 1 then permutes and returns state[1])."""

    def __init__(self, scalar_spec: FieldSpec, base_spec: FieldSpec):
        self.r = scalar_spec.p
        self.q = base_spec.p
        self.n_base_bytes = (base_spec.bits + 63) // 64 * 8
        self.n_scalar_bytes = (scalar_spec.bits + 63) // 64 * 8
        self._perm = _poseidon_transcript_perm(scalar_spec)
        self.rate = 8
        self.state = [0] * 9
        self.state[0] = (1 << 64) % self.r
        self.absorbing: list[int] = []

    def _update(self, elements: list[int]):
        buf = self.absorbing + [int(v) % self.r for v in elements]
        # process full rate-chunks; a trailing partial chunk stays buffered
        while len(buf) >= self.rate:
            chunk, buf = buf[: self.rate], buf[self.rate :]
            for i, v in enumerate(chunk):
                self.state[i + 1] = (self.state[i + 1] + v) % self.r
            self.state = self._perm.permute_host(self.state)
        self.absorbing = buf

    def common_point(self, point: tuple | None):
        x, y = (0, 0) if point is None else point
        # BaseToScalar: LE bytes of the base coord reduced into Fr
        self._update([int(x) % self.r, int(y) % self.r])

    def common_scalar(self, scalar: int):
        self._update([int(scalar)])

    def squeeze_challenge(self) -> int:
        last = self.absorbing + [1]
        for i, v in enumerate(last):
            self.state[i + 1] = (self.state[i + 1] + v) % self.r
        self.state = self._perm.permute_host(self.state)
        self.absorbing = []
        return self.state[1]


@_functools.lru_cache(maxsize=None)
def _poseidon_transcript_perm(scalar_spec: FieldSpec):
    from tachyon_tpu_torch.crypto.poseidon import Poseidon
    from tachyon_tpu_torch.math.field import PrimeField

    return Poseidon(
        PrimeField(scalar_spec, "cpu"), rate=8, alpha=5,
        full_rounds=8, partial_rounds=63,
    )


class SnarkVerifierPoseidonTranscript:
    """snark-verifier poseidon transcript core (reference:
    zk/plonk/halo2/snark_verifier_poseidon_transcript.h — Params5 = Fr,
    rate 4, alpha 5, 8 full / 60 partial rounds, PoseidonConfig::Create(0);
    scroll-tech/snark-verifier absorb-buffered flavor: state[0] seeded with
    2^64, updates buffer scalars, squeeze processes rate-4 chunks adding at
    state[j+1] with a 1 added at state[len+1] for partial chunks, and one
    extra 1-padded permute when the buffer is chunk-aligned (incl. empty);
    returns state[1])."""

    def __init__(self, scalar_spec: FieldSpec, base_spec: FieldSpec):
        self.r = scalar_spec.p
        self.q = base_spec.p
        self.n_base_bytes = (base_spec.bits + 63) // 64 * 8
        self.n_scalar_bytes = (scalar_spec.bits + 63) // 64 * 8
        self._perm = _sv_poseidon_perm(scalar_spec)
        self.rate = 4
        self.width = 5
        self.state = [0] * self.width
        self.state[0] = (1 << 64) % self.r
        self.absorbing: list[int] = []

    def common_point(self, point: tuple | None):
        x, y = (0, 0) if point is None else point
        # BaseToScalar: LE bytes of the base coord reduced into Fr
        self.absorbing += [int(x) % self.r, int(y) % self.r]

    def common_scalar(self, scalar: int):
        self.absorbing.append(int(scalar) % self.r)

    def squeeze_challenge(self) -> int:
        buf, rate = self.absorbing, self.rate
        num_chunks = (len(buf) + rate - 1) // rate
        for i in range(num_chunks):
            chunk = buf[i * rate: min((i + 1) * rate, len(buf))]
            for j, v in enumerate(chunk):
                self.state[j + 1] = (self.state[j + 1] + v) % self.r
            if len(chunk) + 1 < self.width:
                self.state[len(chunk) + 1] = \
                    (self.state[len(chunk) + 1] + 1) % self.r
            self.state = self._perm.permute_host(self.state)
        if len(buf) == num_chunks * rate:
            self.state[1] = (self.state[1] + 1) % self.r
            self.state = self._perm.permute_host(self.state)
        self.absorbing = []
        return self.state[1]


@_functools.lru_cache(maxsize=None)
def _sv_poseidon_perm(scalar_spec: FieldSpec):
    from tachyon_tpu_torch.crypto.poseidon import Poseidon
    from tachyon_tpu_torch.math.field import PrimeField

    return Poseidon(
        PrimeField(scalar_spec, "cpu"), rate=4, alpha=5,
        full_rounds=8, partial_rounds=60,
    )


_TRANSCRIPT_CORES = {
    "blake2b": Blake2bTranscript,
    "sha256": Sha256Transcript,
    "poseidon": PoseidonTranscript,
    "snark_verifier": SnarkVerifierPoseidonTranscript,
}


def make_writer(kind: str, scalar_spec: FieldSpec, base_spec: FieldSpec,
                legacy: bool = True):
    """TranscriptWriter over any hash flavor (reference:
    zk/plonk/halo2/transcript_type.h dispatch)."""
    core = _TRANSCRIPT_CORES[kind]

    class _Writer(core):
        def __init__(self):
            super().__init__(scalar_spec, base_spec)
            self.proof = bytearray()
            self.legacy = legacy

        def write_point(self, point):
            self.common_point(point)
            self.proof += compress_g1(point, FieldSpecShim(self.q), self.legacy)

        def write_scalar(self, scalar):
            self.common_scalar(scalar)
            self.proof += (int(scalar) % self.r).to_bytes(
                self.n_scalar_bytes, "little"
            )

    return _Writer()


def make_reader(kind: str, proof: bytes, scalar_spec: FieldSpec,
                base_spec: FieldSpec, b_coeff: int = 3, legacy: bool = True):
    core = _TRANSCRIPT_CORES[kind]

    class _Reader(core):
        def __init__(self):
            super().__init__(scalar_spec, base_spec)
            self.buf = memoryview(bytes(proof))
            self.off = 0
            self.legacy = legacy
            self.b_coeff = b_coeff

        def read_point(self):
            return _checked_read_point(self)

        def read_scalar(self) -> int:
            return _checked_read_scalar(self)

    return _Reader()
