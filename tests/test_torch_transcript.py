"""The port's halo2 transcripts and Poseidon against the JAX package, on CPU.

``tachyon_tpu_torch/crypto/transcript.py`` is a copy of the JAX package's
host module, and ``crypto/poseidon.py`` a torch port: the same seeded
sequence of points and scalars goes into each transcript flavor (Blake2b,
SHA-256, Poseidon, the snark-verifier Poseidon) of both packages, and the
challenges and proof bytes must be equal; the port's reader reads the proof
back.  The port's torch ``Poseidon.permute`` is held against the JAX
package's exact ``permute_host`` (its own ``permute`` takes minutes eagerly
on a CPU) and the sponge's absorb/squeeze against the JAX sponge's, both
on host permutations.
"""
import numpy as np
import pytest
import torch

from tachyon_tpu.crypto import poseidon as jposeidon
from tachyon_tpu.crypto import transcript as jt
from tachyon_tpu.fields import presets as jpresets
from tachyon_tpu_torch.crypto import poseidon, transcript as tt
from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.math.field import PrimeField

torch.set_num_threads(1)

P = presets.BN254_FQ.p
R = presets.BN254_FR.p
KINDS = ("blake2b", "sha256", "poseidon", "snark_verifier")


def script(seed: int) -> list:
    """A seeded sequence of transcript calls: points (some at infinity),
    scalars, common values and squeezes."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(14):
        k = int.from_bytes(rng.bytes(40), "little") % R
        kind = ("point", "scalar", "common_scalar", "common_point", "squeeze")[i % 5]
        if kind in ("point", "common_point"):
            ops.append((kind, None if i % 7 == 0 else host_ec.scalar_mul((1, 2), k, 0, P)))
        else:
            ops.append((kind, k))
    ops.append(("squeeze", None))
    return ops


def run(w, ops) -> list:
    out = []
    for kind, v in ops:
        if kind == "point":
            w.write_point(v)
        elif kind == "scalar":
            w.write_scalar(v)
        elif kind == "common_scalar":
            w.common_scalar(v)
        elif kind == "common_point":
            w.common_point(v)
        else:
            out.append(w.squeeze_challenge())
    return out


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_transcript_vs_jax(kind, legacy):
    ops = script(11 + KINDS.index(kind))
    jw = jt.make_writer(kind, jpresets.BN254_FR, jpresets.BN254_FQ, legacy=legacy)
    pw = tt.make_writer(kind, presets.BN254_FR, presets.BN254_FQ, legacy=legacy)
    want, got = run(jw, ops), run(pw, ops)
    assert got == want and bytes(pw.proof) == bytes(jw.proof)
    # the port's reader reads the proof back and squeezes the same challenges
    rd = tt.make_reader(kind, bytes(pw.proof), presets.BN254_FR, presets.BN254_FQ,
                        legacy=legacy)
    seen = []
    for op, v in ops:
        if op == "point":
            assert rd.read_point() == v
        elif op == "scalar":
            assert rd.read_scalar() == v
        elif op == "common_scalar":
            rd.common_scalar(v)
        elif op == "common_point":
            rd.common_point(v)
        else:
            seen.append(rd.squeeze_challenge())
    assert seen == want and rd.off == len(pw.proof)


def test_blake2b_writer_reader_classes():
    """TranscriptWriter/TranscriptReader (the halo2 prover's) equal the JAX ones."""
    ops = script(5)
    jw = jt.TranscriptWriter(jt.FieldSpecShim(R), jt.FieldSpecShim(P))
    pw = tt.TranscriptWriter(tt.FieldSpecShim(R), tt.FieldSpecShim(P))
    assert run(pw, ops) == run(jw, ops) and bytes(pw.proof) == bytes(jw.proof)
    rd = tt.TranscriptReader(bytes(pw.proof), tt.FieldSpecShim(R), tt.FieldSpecShim(P))
    assert rd.read_point() == ops[0][1]


@pytest.mark.parametrize("legacy", [True, False])
def test_compress_decompress(legacy):
    shim = tt.FieldSpecShim(P)
    rng = np.random.default_rng(3)
    for i in range(6):
        pt = None if i == 0 else host_ec.scalar_mul((1, 2), int(rng.integers(1, 1 << 62)), 0, P)
        enc = tt.compress_g1(pt, shim, legacy)
        assert enc == jt.compress_g1(pt, jt.FieldSpecShim(P), legacy)
        assert tt.decompress_g1(enc, shim, 3, legacy) == pt
    with pytest.raises(tt.ProofDecodeError):  # x >= q: a second encoding
        tt.decompress_g1((P + 1).to_bytes(32, "little"), shim, 3, legacy)
    x = next(x for x in range(1, 64) if pow((x ** 3 + 3) % P, (P - 1) // 2, P) != 1)
    with pytest.raises(tt.ProofDecodeError):  # x^3 + 3 is no square: off the curve
        tt.decompress_g1(x.to_bytes(32, "little"), shim, 3, legacy)
    rd = tt.TranscriptReader(R.to_bytes(32, "little"), tt.FieldSpecShim(R), shim)
    with pytest.raises(tt.ProofDecodeError):  # a scalar >= r
        rd.read_scalar()


@pytest.mark.parametrize("rate,partial", [(8, 63), (4, 60), (2, 57)])
def test_poseidon_constants_and_permute(rate, partial):
    """The Grain-derived ARK and MDS equal the JAX package's; the torch
    permutation of a batch of seeded states equals the JAX permute_host."""
    F = PrimeField(presets.BN254_FR, "cpu")
    perm = poseidon.Poseidon(F, rate=rate, alpha=5, full_rounds=8, partial_rounds=partial)
    jperm = jt._poseidon_transcript_perm(jpresets.BN254_FR) if rate == 8 else \
        jt._sv_poseidon_perm(jpresets.BN254_FR) if rate == 4 else None
    if jperm is None:
        from tachyon_tpu.math.field import PrimeField as JPrimeField

        jperm = jposeidon.Poseidon(JPrimeField(jpresets.BN254_FR), rate=rate, alpha=5,
                                   full_rounds=8, partial_rounds=partial)
    assert perm.ark_host == jperm.ark_host and perm.mds_host == jperm.mds_host
    rng = np.random.default_rng(rate)
    states = [[int.from_bytes(rng.bytes(40), "little") % R for _ in range(rate + 1)]
              for _ in range(3)]
    got = perm.permute(F.encode(np.array(states, dtype=object).T))  # (W, t, 3)
    want = [jperm.permute_host(s) for s in states]
    assert [[int(v) for v in F.decode(got[:, :, b])] for b in range(3)] == want
    assert [perm.permute_host(s) for s in states] == want


def test_poseidon_sponge_vs_jax():
    """Absorb/squeeze of the port's sponge (the torch permutation) against
    the JAX sponge's logic on its host permutation."""
    F = PrimeField(presets.BN254_FR, "cpu")
    perm = poseidon.Poseidon(F, rate=2, alpha=5, full_rounds=8, partial_rounds=57)
    from tachyon_tpu.math.field import PrimeField as JPrimeField

    jperm = jposeidon.Poseidon(JPrimeField(jpresets.BN254_FR), rate=2, alpha=5,
                               full_rounds=8, partial_rounds=57)

    class HostSponge(jposeidon.PoseidonSpongeState):
        def _permute(self):
            self.state = self.perm.permute_host(self.state)

    ps, js = poseidon.PoseidonSpongeState(perm), HostSponge(jperm)
    rng = np.random.default_rng(9)
    for step in ([3], [1, 2], [5, 6, 7], "s1", [8], "s3", "s2", [9, 10]):
        if isinstance(step, str):
            assert ps.squeeze(int(step[1])) == js.squeeze(int(step[1]))
        else:
            vals = [int(rng.integers(0, 1 << 60)) * v for v in step]
            ps.absorb(vals)
            js.absorb(vals)
    assert ps.squeeze(2) == js.squeeze(2) and ps.state == js.state
