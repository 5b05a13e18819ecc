"""tachyon_tpu_torch/base/buffer.py against tachyon_tpu/base/buffer.py: the
same bytes for every codec, and the same rejections.  Host-only."""
import random

import pytest

from tachyon_tpu.base import buffer as jbuf
from tachyon_tpu_torch.base import buffer as tbuf
from tachyon_tpu_torch.zk.groth16.r1cs import Groth16Proof

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _writes(mod, rnd: random.Random) -> bytes:
    buf = mod.Buffer()
    buf.write_u8(rnd.randrange(256)).write_u32(rnd.randrange(1 << 32))
    buf.write_u64(rnd.randrange(1 << 64)).write_bytes(rnd.randbytes(13))
    buf.write_field(rnd.randrange(R), R).write_raw(b"\x01\x02")
    buf.write_vec([rnd.randrange(Q) for _ in range(5)], lambda b, v: b.write_field(v, Q))
    g1 = (rnd.randrange(Q), rnd.randrange(Q))
    g2 = ((rnd.randrange(Q), rnd.randrange(Q)), (rnd.randrange(Q), rnd.randrange(Q)))
    for pt in (g1, None):
        mod.write_g1(buf, pt, Q)
    for pt in (g2, None):
        mod.write_g2(buf, pt, Q)
    return buf.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_writes_match_jax(seed):
    assert _writes(tbuf, random.Random(seed)) == _writes(jbuf, random.Random(seed))


def test_reads_roundtrip():
    data = _writes(tbuf, random.Random(7))
    rnd = random.Random(7)
    rd = tbuf.ReadBuffer(data)
    assert rd.read_u8() == rnd.randrange(256)
    assert rd.read_u32() == rnd.randrange(1 << 32)
    assert rd.read_u64() == rnd.randrange(1 << 64)
    assert rd.read_bytes() == rnd.randbytes(13)
    assert rd.read_field(R) == rnd.randrange(R)
    assert rd._take(2) == b"\x01\x02"
    want = [rnd.randrange(Q) for _ in range(5)]
    assert rd.read_vec(lambda b: b.read_field(Q), min_size=32) == want
    g1 = (rnd.randrange(Q), rnd.randrange(Q))
    g2 = ((rnd.randrange(Q), rnd.randrange(Q)), (rnd.randrange(Q), rnd.randrange(Q)))
    assert tbuf.read_g1(rd, Q) == g1 and tbuf.read_g1(rd, Q) is None
    assert tbuf.read_g2(rd, Q) == g2 and tbuf.read_g2(rd, Q) is None
    assert rd.done()


def test_groth16_proof_bytes_match_jax():
    rnd = random.Random(3)
    proof = Groth16Proof(
        a=(rnd.randrange(Q), rnd.randrange(Q)),
        b=((rnd.randrange(Q), rnd.randrange(Q)), (rnd.randrange(Q), rnd.randrange(Q))),
        c=None)
    data = tbuf.groth16_proof_to_bytes(proof, Q)
    assert data == jbuf.groth16_proof_to_bytes(proof, Q)
    assert tbuf.groth16_proof_from_bytes(data, Q, Groth16Proof) == proof
    one = lambda b: b.write_u8(1)  # noqa: E731
    assert tbuf.serialize("k", one) == jbuf.serialize("k", one)


@pytest.mark.parametrize("case", ["truncated", "non_canonical", "bad_magic", "bad_version",
                                  "wrong_kind", "trailing", "huge_vec"])
def test_rejections_match_jax(case):
    good = tbuf.groth16_proof_to_bytes(Groth16Proof(None, None, None), Q)

    def run(mod):
        if case == "truncated":
            return mod.ReadBuffer(mod.Buffer().write_u64(42).getvalue()[:-1]).read_u64()
        if case == "non_canonical":
            return mod.Buffer().write_field(Q, Q)
        if case == "bad_magic":
            return mod.deserialize(b"XXXX" + good[4:], "groth16.proof")
        if case == "bad_version":
            return mod.deserialize(good[:4] + b"\x09" + good[5:], "groth16.proof")
        if case == "wrong_kind":
            return mod.deserialize(good, "other")
        if case == "trailing":
            return mod.groth16_proof_from_bytes(good + b"\x00", Q, Groth16Proof)
        return mod.ReadBuffer(mod.Buffer().write_u64(1 << 40).getvalue()).read_vec(
            lambda b: b.read_u8())

    for mod in (jbuf, tbuf):
        with pytest.raises(ValueError):
            run(mod)
