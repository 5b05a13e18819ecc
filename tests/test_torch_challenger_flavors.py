"""The port's MultiField32Challenger and HashChallenger against the JAX
package on CPU.

Both challengers are host logic on exact ints through ``permute_host``, so
the same observations give the same samples: each sequence is held against
the JAX challenger's and against the reference's unit-test vectors
(multi_field32_challenger_unittest.cc:50-65, hash_challenger_unittest.cc:
50-62, as ``tests/test_challenger_flavors.py`` pins them), and a clone
continues as the original does.
"""
import numpy as np
import pytest
import torch

from tachyon_tpu.crypto import challenger as jchallenger
from tachyon_tpu.crypto import poseidon2 as jposeidon2
from tachyon_tpu_torch.crypto import poseidon2
from tachyon_tpu_torch.crypto.challenger import HashChallenger, MultiField32Challenger
from tachyon_tpu_torch.fields import presets

torch.set_num_threads(1)
CPU = torch.device("cpu")
BB = presets.BABY_BEAR.p
MF32_GOLDEN = [72199253, 733473132, 442816494, 326641700, 1342573676, 1242755868,
               887300172, 1831922292, 1518709680]
HASH_GOLDEN = [886174168, 1457271233, 1952268252, 1595005924, 796215768, 1553987485,
               1108393593, 1336137665, 971109448, 1853357459]


def test_multi_field32_vs_jax_and_golden():
    jc = jchallenger.MultiField32Challenger(jposeidon2.bn254_w3(), BB)
    c = MultiField32Challenger(poseidon2.bn254_w3(CPU), BB)
    assert (c.num_f, c.R) == (jc.num_f, jc.R) == (3, 9)
    for i in range(20):
        jc.observe(i)
        c.observe(i)
    got = [c.sample() for _ in MF32_GOLDEN]
    assert got == MF32_GOLDEN == [jc.sample() for _ in MF32_GOLDEN]
    rng = np.random.default_rng(180)
    xs = [int(v) for v in rng.integers(0, 1 << 40, 31)]  # reduced mod p on observe
    jc.observe_many(xs)
    c.observe_many(xs)
    assert c.sample_array(12) == jc.sample_array(12)
    assert c.sample_ext(4) == jc.sample_ext(4)
    assert c.sample_bits(7) == jc.sample_bits(7)


def test_multi_field32_clone_and_grind():
    """A clone samples what the original samples; check_witness as in the
    JAX package's grind test finds the same witness."""
    c = MultiField32Challenger(poseidon2.bn254_w3(CPU), BB)
    jc = jchallenger.MultiField32Challenger(jposeidon2.bn254_w3(), BB)
    c.observe_many(range(5))
    jc.observe_many(range(5))
    d = c.clone()
    assert d.sample_array(6) == c.sample_array(6) == jc.sample_array(6)
    d.observe(9)
    assert c._inputs == [] and d._inputs == [9]

    def first_witness(ch, clone):
        for w in range(100):
            if clone(ch).check_witness(3, w):
                return w
        raise AssertionError("no witness")

    def jclone(ch):
        k = jchallenger.MultiField32Challenger(ch.perm, ch.small_p)
        k._state, k._inputs, k._outputs = list(ch._state), list(ch._inputs), list(ch._outputs)
        return k

    w = first_witness(c, MultiField32Challenger.clone)
    assert w == first_witness(jc, jclone)
    assert c.check_witness(3, w) and jc.check_witness(3, w)


def test_hash_challenger_vs_jax_and_golden():
    jc = jchallenger.HashChallenger(jposeidon2.baby_bear_p3_w16(), out_len=8, rate=8)
    c = HashChallenger(poseidon2.baby_bear_p3_w16(CPU), out_len=8, rate=8)
    jc._inputs = [i + 1 for i in range(10)]
    c.observe_many(i + 1 for i in range(10))
    for i in range(20):
        jc.observe(i)
        c.observe(i)
    d = c.clone()
    got = c.sample_array(len(HASH_GOLDEN))
    assert got == HASH_GOLDEN == jc.sample_array(len(HASH_GOLDEN))
    assert d.sample_array(len(HASH_GOLDEN)) == HASH_GOLDEN
    # past the first digest the next sample hashes it again
    assert c.sample_array(9) == jc.sample_array(9)
    c.observe(5)
    jc.observe(5)
    assert c.sample() == jc.sample()


@pytest.mark.parametrize("rate", [None, 4])
def test_hash_challenger_rates_vs_jax(rate):
    """The default rate (8 at width 16, t - 1 otherwise) and a narrow one,
    on the Goldilocks width-8 permutation."""
    jc = jchallenger.HashChallenger(jposeidon2.goldilocks_w8(), out_len=4, rate=rate)
    c = HashChallenger(poseidon2.goldilocks_w8(CPU), out_len=4, rate=rate)
    assert c.rate == jc.rate
    rng = np.random.default_rng(181)
    xs = [int.from_bytes(rng.bytes(9), "little") for _ in range(11)]
    c.observe_many(xs)
    jc.observe_many(xs)
    assert c.sample_array(10) == jc.sample_array(10)
