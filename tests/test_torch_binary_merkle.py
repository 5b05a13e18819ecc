"""The port's binary Merkle tree (``crypto/binary_merkle.py``) over the
port's BabyBear Poseidon2 ``compress`` against the JAX package.

``tests/fixtures/torch_math_jax.json`` holds every layer of
``tachyon_tpu.crypto.binary_merkle.build(baby_bear_p3_w16().compress, ...)``
over ``scripts/make_torch_math_fixture.py``'s 16 leaves of 8-element
digests, the siblings of ``open_at(5)`` and the JAX verdicts (a JAX
compress compiles for 10-25 s a tree level on a CPU).  The port's layers
and siblings must be the same words; its ``verify`` accepts every opening
and refuses a tampered leaf, sibling or index.  The slow test re-records
the group.
"""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import pytest
import torch

from tachyon_tpu_torch.crypto import binary_merkle, poseidon2
from tachyon_tpu_torch.fields import limbs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_math_jax.json"


@lru_cache(maxsize=None)
def maker():
    path = ROOT / "scripts" / "make_torch_math_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_math_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())["merkle"]


def jax_words(d: dict) -> torch.Tensor:
    return limbs.from_jax_limbs(maker().unhexed(d))


@pytest.fixture(scope="module")
def tree():
    h = poseidon2.baby_bear_p3_w16("cpu")
    leaves = h.F.encode(maker().merkle_leaves())  # (1, DIGEST, n)
    return h, leaves, binary_merkle.build(h.compress, leaves)


def test_layers_and_opening_vs_jax(tree):
    h, leaves, t = tree
    fx = fixture()
    assert len(t.layers) == len(fx["layers"]) == 5
    for got, want in zip(t.layers, fx["layers"]):
        assert torch.equal(got, jax_words(want))
    proof = binary_merkle.open_at(t, maker().MERKLE_OPEN)
    for got, want in zip(proof.siblings, fx["siblings"]):
        assert torch.equal(got, jax_words(want))
    assert fx["verify"] and fx["tampered_refused"]


def test_verify_every_leaf_and_refusals(tree):
    h, leaves, t = tree
    root = t.root()
    n = leaves.shape[-1]
    for idx in range(n):
        proof = binary_merkle.open_at(t, idx)
        assert binary_merkle.verify(h.compress, root, idx, leaves[:, :, idx], proof)
    idx = maker().MERKLE_OPEN
    proof = binary_merkle.open_at(t, idx)
    bad = leaves[:, :, idx].clone()
    bad[:, 0] = h.F.encode(12345)
    assert not binary_merkle.verify(h.compress, root, idx, bad, proof)
    sibs = list(proof.siblings)
    sibs[2] = sibs[2].clone()
    sibs[2][:, 3] = h.F.encode(7)
    assert not binary_merkle.verify(h.compress, root, idx, leaves[:, :, idx],
                                    binary_merkle.BinaryMerkleProof(tuple(sibs)))
    assert not binary_merkle.verify(h.compress, root, idx ^ 1, leaves[:, :, idx], proof)


def test_build_refuses_non_power_of_two(tree):
    h, leaves, _ = tree
    with pytest.raises(ValueError, match="power of two"):
        binary_merkle.build(h.compress, leaves[:, :, :12])


@pytest.mark.slow
def test_fixture_recomputed_from_jax():
    """The JAX package, run again, gives the committed group (minutes)."""
    assert maker().record(("merkle",))["merkle"] == fixture()
