"""The port's SimpleFRI (``crypto/simple_fri.py``) against the JAX package on CPU.

BabyBear evaluations of random polynomials of degree < n/2 at n = 16 and
32, from fixed numpy seeds, with ``baby_bear_p3_w16`` and a fresh
``DuplexChallenger(perm, 8)``: every layer root, the final value, each
query's index and every opened row and sibling equal the JAX
``SimpleFRI.commit``'s, recorded in ``tests/fixtures/torch_simple_fri_jax.json``
by ``scripts/make_torch_simple_fri_fixture.py`` (the JAX package compiles
a Poseidon2 graph for every tree level, minutes on a CPU; the slow test
recomputes it).  The comparison is of canonical ints, word for word.  The
port's ``verify`` accepts the proof and refuses a tampered opened value, a
tampered final value and a wrong query index.  (The JAX ``verify`` cannot
check its own proof: it unpacks four items from each layer's pair of
openings and passes ``merkle.verify`` no matrix dimensions.)
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from tachyon_tpu_torch.crypto import merkle, poseidon2
from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.crypto.simple_fri import SimpleFRI, SimpleFRIProof
from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math.field import PrimeField

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "make_torch_simple_fri_fixture.py"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_simple_fri_jax.json"


def fixture_script():
    spec = importlib.util.spec_from_file_location("make_torch_simple_fri_fixture", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def proofs(fx):
    """The port's proof of each size."""
    F = PrimeField(presets.BABY_BEAR, CPU)
    h = poseidon2.baby_bear_p3_w16(CPU)
    fri = SimpleFRI(F, h, fx["num_queries"])
    out = {}
    for n in fixture_script().SIZES:
        evals = fx["proofs"][str(n)]["evals"]
        assert evals == fixture_script().evaluations(n)
        out[n] = fri.commit(F.encode(evals), DuplexChallenger(h, 8))
    return F, h, fri, out


def ints(F, t):
    return [int(v) for v in F.decode(t).reshape(-1)]


@pytest.mark.parametrize("n", [16, 32])
def test_proof_equals_jax(n, fx, proofs):
    F, _, _, by_n = proofs
    proof, want = by_n[n], fx["proofs"][str(n)]
    assert [ints(F, r) for r in proof.layer_roots] == want["roots"]
    assert proof.final_value == want["final_value"]
    assert [idx for idx, _ in proof.query_paths] == [q["index"] for q in want["queries"]]
    for (_, path), q in zip(proof.query_paths, want["queries"]):
        assert len(path) == len(q["layers"]) == n.bit_length() - 1
        for (lo, hi), layer in zip(path, q["layers"]):
            for mp, side in ((lo, "lo"), (hi, "hi")):
                assert [ints(F, r) for r in mp.opened_rows] == layer[side]["rows"]
                assert [ints(F, s) for s in mp.siblings] == layer[side]["siblings"]


def tampered_row(proof: SimpleFRIProof, q: int, layer: int, p: int) -> SimpleFRIProof:
    """The proof with query q's opened value at j of one layer plus one."""
    idx, path = proof.query_paths[q]
    lo, hi = path[layer]
    row = lo.opened_rows[0].clone()
    row[0, 0] = (row[0, 0] + 1) % p  # Montgomery words stay below p
    path = list(path)
    path[layer] = (merkle.MerkleProof((row,), lo.siblings), hi)
    paths = list(proof.query_paths)
    paths[q] = (idx, path)
    return proof._replace(query_paths=paths)


@pytest.mark.parametrize("n", [16, 32])
def test_verify_accepts_and_refuses_tampering(n, proofs):
    F, h, fri, by_n = proofs
    proof = by_n[n]
    assert fri.verify(n, proof, DuplexChallenger(h, 8)) is True
    for q, layer in ((0, 0), (len(proof.query_paths) - 1, 2)):
        assert fri.verify(n, tampered_row(proof, q, layer, F.p), DuplexChallenger(h, 8)) is False
    bad_final = proof._replace(final_value=(proof.final_value + 1) % F.p)
    assert fri.verify(n, bad_final, DuplexChallenger(h, 8)) is False
    idx, path = proof.query_paths[1]
    bad_idx = proof._replace(query_paths=[proof.query_paths[0], ((idx + 1) % n, path),
                                          *proof.query_paths[2:]])
    assert fri.verify(n, bad_idx, DuplexChallenger(h, 8)) is False
    assert fri.verify(2 * n, proof, DuplexChallenger(h, 8)) is False


def test_fold_is_the_even_odd_split():
    """One fold of the evaluations of f = c0 + c1 x + c2 x^2 + c3 x^3 at
    beta is the evaluations of (c0 + beta c1) + (c2 + beta c3) y on the
    squared domain."""
    F = PrimeField(presets.BABY_BEAR, CPU)
    p = F.p
    fri = SimpleFRI(F, poseidon2.baby_bear_p3_w16(CPU))
    from tachyon_tpu_torch.math.ntt import Radix2Domain
    n, cs, beta = 8, [3, 141, 59, 26, 0, 0, 0, 0], 977
    dom = Radix2Domain(F, n)
    w = dom.omega_int
    evals = [sum(c * pow(w, i * j, p) for j, c in enumerate(cs)) % p for i in range(n)]
    got = ints(F, fri._fold(F.encode(evals), beta, dom))
    g0, g1 = (cs[0] + beta * cs[1]) % p, (cs[2] + beta * cs[3]) % p
    assert got == [(g0 + g1 * pow(w, 2 * i, p)) % p for i in range(n // 2)]


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed fixture (minutes)."""
    assert fixture_script().record() == fx
