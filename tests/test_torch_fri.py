"""The port's Merkle MMCS, duplex challenger and TwoAdicFRI PCS on CPU.

The PCS is held against ``tests/fixtures/fri_babybear_pinned.json``, the
JAX package's transcript of ``tests/test_fri_pinned.py`` (every root,
opened value, the final value, the proof-of-work witness and the first
query's siblings), word for word; its verifier must accept the proof and
refuse a tampered one.  The challenger is held against the JAX
``DuplexChallenger`` on the same observations (its grind through one JAX
permutation batch, about ten seconds of XLA compile), the Merkle tree at
mixed heights against a tree of ``permute_host`` digests.
``get_evaluations_on_domain`` is held against the JAX method on the same
LDE rows and against the committed matrix's interpolant on the coset.
"""
import json

import numpy as np
import pytest
import torch

from scripts import fri_pinned
from tachyon_tpu.crypto import poseidon2 as jposeidon2
from tachyon_tpu.crypto.challenger import DuplexChallenger as JDuplexChallenger
from tachyon_tpu_torch.crypto import merkle, poseidon2
from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.fields import presets

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pinned():
    """The pinned shapes' proof through the port, and the verifier's view."""
    pcs, datas, points, ch = fri_pinned.setup(CPU)
    opened, proof = pcs.create_opening_proof(datas, points, ch)
    return pcs, datas, points, opened, proof


def test_pinned_artifacts():
    assert fri_pinned.artifacts(CPU) == json.loads(fri_pinned.FIXTURE.read_text())


def test_verify_accepts_and_rejects(pinned):
    pcs, datas, points, opened, proof = pinned
    roots = [d.root() for d in datas]
    dims = [[(n, c) for n, c in shapes] for shapes in fri_pinned.SHAPES]

    def verifier():
        ch = DuplexChallenger(pcs.h, rate=8)
        for r in roots:
            ch.observe_many(int(v) for v in pcs.F.decode(r))
        ch.sample_ext(4)
        return ch

    assert pcs.verify_opening_proof(roots, dims, points, opened, proof, verifier()) is True
    bad = opened[1][0][0].clone()
    bad[2, 0, 1] = (bad[2, 0, 1] + 1) % pcs.F.p
    tampered = (opened[0], ((bad,),))
    assert pcs.verify_opening_proof(roots, dims, points, tampered, proof, verifier()) is False
    wrong_pow = proof._replace(pow_witness=proof.pow_witness + 1)
    assert pcs.verify_opening_proof(roots, dims, points, opened, wrong_pow, verifier()) is False


@pytest.mark.parametrize("size", [8, 32, 64])
def test_get_evaluations_on_domain_vs_jax(pinned, size):
    """The first ``size`` bit-reversed LDE rows of the pinned round-0
    matrix (32 x 3, 64 LDE rows), re-bit-reversed, equal the JAX method's
    on the same rows and the matrix's interpolant at g w_size^k."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    from tachyon_tpu.crypto.fri import TwoAdicFRIPCS as JPCS
    from tachyon_tpu_torch.fields import limbs

    pcs, datas = pinned[0], pinned[1]
    F, p = pcs.F, pcs.F.p
    got = pcs.get_evaluations_on_domain(datas[0], 0, size)
    lde = jnp.asarray(limbs.to_jax_limbs(datas[0].ldes[0]))
    want = JPCS.get_evaluations_on_domain(None, SimpleNamespace(ldes=(lde,)), 0, size)
    np.testing.assert_array_equal(limbs.to_jax_limbs(got), np.asarray(want))
    coeffs = F.decode(datas[0].coeffs[0])  # (32, 3)
    g, w = F.spec.generator, F.spec.root_of_unity(size)
    vals = F.decode(got)
    for k in range(size):
        x = g * pow(w, k, p) % p
        for c in range(3):
            assert int(vals[k, c]) == sum(int(coeffs[j, c]) * pow(x, j, p)
                                          for j in range(32)) % p
    with pytest.raises(ValueError):
        pcs.get_evaluations_on_domain(datas[0], 0, 128)


def host_tree_root(h, mats: list) -> list:
    """The MMCS root on host ints: mats are lists of rows, heights powers
    of two; the tallest hashed, then compress and inject height by height."""
    p = h.F.p

    def leaf(row):
        st = [0] * h.t
        for off in range(0, len(row), 8):
            st[:len(row[off:off + 8])] = row[off:off + 8]
            st = h.permute_host(st)
        return st[:8]

    def compress(a, b):
        return h.permute_host(a + b)[:8]

    height = max(len(m) for m in mats)
    layer = [leaf(sum((m[i] for m in mats if len(m) == height), [])) for i in range(height)]
    while len(layer) > 1:
        layer = [compress(layer[2 * i], layer[2 * i + 1]) for i in range(len(layer) // 2)]
        inject = [m for m in mats if len(m) == len(layer)]
        if inject:
            layer = [compress(d, leaf(sum((m[i] for m in inject), [])))
                     for i, d in enumerate(layer)]
    assert all(0 <= v < p for v in layer[0])
    return layer[0]


def test_merkle_mixed_heights():
    """build / open_at / verify over heights 16, 8 (two matrices) and 4:
    the root equals the host tree's; every leaf opens and verifies, a
    batch opening equals the single ones, a tampered row or sibling fails."""
    h = poseidon2.baby_bear_p3_w16(CPU)
    F = h.F
    rng = np.random.default_rng(17)
    shapes = [(8, 3), (16, 5), (4, 9), (8, 2)]
    rows = [[[int(v) for v in rng.integers(0, F.p, c)] for _ in range(n)] for n, c in shapes]
    mats = [F.encode(np.array(r, dtype=object)) for r in rows]
    tree = merkle.build(h, mats)
    root = tree.root()
    assert [int(v) for v in F.decode(root)] == host_tree_root(h, rows)
    dims = list(shapes)
    every = torch.arange(16)
    batch = merkle.open_batch(tree, every)
    assert merkle.verify_batch(h, root, dims, every, batch).all()
    assert not merkle.verify_batch(h, root, dims, every ^ 1, batch).any()
    one = merkle.open_at(tree, 12)
    assert all(torch.equal(b[:, 12], o) for b, o in zip(batch.opened_rows, one.opened_rows))
    assert all(torch.equal(b[:, :, 12], o) for b, o in zip(batch.siblings, one.siblings))
    assert merkle.verify(h, root, dims, 12, one) and not merkle.verify(h, root, dims, 13, one)
    bad_row = one.opened_rows[2].clone()
    bad_row[0, 4] = (bad_row[0, 4] + 1) % F.p
    assert not merkle.verify(h, root, dims, 12, one._replace(
        opened_rows=one.opened_rows[:2] + (bad_row,) + one.opened_rows[3:]))
    bad_sib = one.siblings[3].clone()
    bad_sib[0, 0] = (bad_sib[0, 0] + 1) % F.p
    assert not merkle.verify(h, root, dims, 12, one._replace(
        siblings=one.siblings[:3] + (bad_sib,)))


def test_challenger_vs_jax():
    """sample, sample_ext, sample_bits and grind on the same observations
    as the JAX challenger (rate 8, and rate 4 as the uni-STARK test's)."""
    jh, h = jposeidon2.baby_bear_p3_w16(), poseidon2.baby_bear_p3_w16(CPU)
    for rate in (8, 4):
        jc, c = JDuplexChallenger(jh, rate), DuplexChallenger(h, rate)
        got, want = [], []
        for k in range(3):
            obs = [k * 1000 + i * 7919 for i in range(5 + 3 * k)] + [presets.BABY_BEAR.p + k]
            jc.observe_many(obs)
            c.observe_many(obs)
            want += [jc.sample(), jc.sample_ext(4), jc.sample_bits(13), jc.sample_array(3)]
            got += [c.sample(), c.sample_ext(4), c.sample_bits(13), c.sample_array(3)]
        assert got == want
    jc.observe(12345)
    c.observe(12345)
    before = c.clone()
    jw = jc.grind(5)
    assert c.grind(5) == jw
    assert c.sample() == jc.sample()
    # the least witness: every smaller candidate fails the check
    assert before.clone().check_witness(5, jw)
    assert not any(before.clone().check_witness(5, w) for w in range(jw))


def test_encode_canonical_rejects_wide_fields():
    with pytest.raises(ValueError):
        PrimeField(presets.BN254_FR, CPU).encode_canonical(torch.tensor([1]))
