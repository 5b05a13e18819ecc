"""The port's standalone PLONK prover (``tachyon_tpu_torch/zk/plonk/prover.py``)
against the JAX package's, on CPU, through ``tests/fixtures/torch_plonk_jax.json``
(recorded by ``scripts/make_torch_plonk_fixture.py``): the key's words and
commitments, ``vk_transcript_repr`` and the proof bytes of the same
circuit, with the JAX prover's blinding draws replayed through ``rng``.
This file: ``tests/test_plonk.py``'s circuit at n = 16 with SHPlonk and
GWC, ``pk_from_jax`` and the scans; ``test_torch_plonk_refusals.py`` the
verifier's refusals, ``test_torch_plonk_lookup.py`` the lookups and the
shuffle, ``test_torch_plonk_blinding.py`` the blinding rows.  The halo2 files'
``int_field_ops`` fixture keeps each case under twenty seconds."""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.crypto import kzg
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.ops import mont
from tachyon_tpu_torch.zk.plonk import expressions as ex
from tachyon_tpu_torch.zk.plonk import prover as plonk
from tachyon_tpu_torch.zk.plonk.constraint_system import ConstraintSystem

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_plonk_jax.json"
CPU = torch.device("cpu")
R = presets.BN254_FR.p

torch.set_num_threads(1)


@lru_cache(maxsize=None)
def maker():
    """scripts/make_torch_plonk_fixture.py as a module (its JAX imports are
    inside its recording functions)."""
    path = ROOT / "scripts" / "make_torch_plonk_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_plonk_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


class Replay:
    """``randbelow`` that gives the recorded draws in order."""

    def __init__(self, draws):
        self.draws = [int(v, 16) for v in draws]
        self.i = 0

    def randbelow(self, p: int) -> int:
        v = self.draws[self.i]
        assert v < p
        self.i += 1
        return v


def words(cols) -> list:
    return [[hex(v) for v in limbs.words_to_ints(c.contiguous().numpy().view(np.uint32))]
            for c in cols]


def hex_point(pt):
    return None if pt is None else [hex(v) for v in pt]


@lru_cache(maxsize=None)
def setup(name: str):
    """The case's circuit, params and the port's key, on the CPU."""
    circuit, pcs, tau, _ = maker().CASES[name]
    case = maker().build_case(circuit, ConstraintSystem, ex)
    params = kzg.unsafe_setup(maker().N, tau, CPU)
    return case, params, plonk.keygen(params, case["cs"], maker().N, case["fixed"])


def check_case(name: str) -> tuple:
    """The key and the proof against the fixture; returns (case, params, pk, proof)."""
    want = fixture()["cases"][name]
    case, params, pk = setup(name)
    key = want["key"]
    for field in ("fixed_evals", "fixed_coeffs", "sigma_evals", "sigma_coeffs"):
        assert words(getattr(pk, field)) == key[field], field
    assert [hex_point(c) for c in pk.fixed_commitments] == key["fixed_commitments"]
    assert [hex_point(c) for c in pk.sigma_commitments] == key["sigma_commitments"]
    assert [hex(d) for d in pk.deltas] == key["deltas"]
    assert hex(plonk.vk_transcript_repr(pk)) == want["vk_transcript_repr"]
    rng = Replay(want["draws"])
    proof = plonk.PlonkProver(params, pk, pcs=want["pcs"], rng=rng).prove(case["advice"],
                                                                        case["instance"])
    assert rng.i == len(rng.draws)
    assert proof.hex() == want["proof"]
    assert want["verified"] is True
    assert plonk.PlonkVerifier(params, pk, pcs=want["pcs"]).verify(proof, case["instance"])
    return case, params, pk, proof


@pytest.mark.parametrize("name", ["mul_shplonk", "mul_gwc"])
def test_mul_vs_jax(name):
    check_case(name)


def jax_shaped_key(pk, jax_cs):
    """The JAX package's ProvingKey of the port's key: its columns as (L, n)
    16-bit limbs (numpy), the JAX constraint system."""
    from tachyon_tpu.zk.plonk.prover import ProvingKey as JaxProvingKey

    cols = lambda ts: [limbs.to_jax_limbs(t) for t in ts]  # noqa: E731
    return JaxProvingKey(jax_cs, pk.n, cols(pk.fixed_evals), cols(pk.fixed_coeffs),
                         cols(pk.sigma_evals), cols(pk.sigma_coeffs), pk.fixed_commitments,
                         pk.sigma_commitments, pk.deltas)


@pytest.mark.parametrize("name", ["mul_shplonk", "lookup_log_derivative", "shuffle"])
def test_pk_from_jax(name):
    """The JAX key of the fixture's words (the JAX keygen's) through
    ``pk_from_jax`` is the port's key, constraint system included, and a
    JAX-shaped copy of the port's key round-trips."""
    from tachyon_tpu.zk.plonk import expressions as jex
    from tachyon_tpu.zk.plonk.constraint_system import ConstraintSystem as JaxCS

    circuit = maker().CASES[name][0]
    jax_cs = maker().build_case(circuit, JaxCS, jex)["cs"]
    port_cs = maker().build_case(circuit, ConstraintSystem, ex)["cs"]
    key = fixture()["cases"][name]["key"]
    W = limbs.word_count(presets.BN254_FR)

    def jax_limbs(col):
        return limbs.to_jax_limbs(limbs.from_ints([int(v, 16) for v in col], W))

    point = lambda c: None if c is None else tuple(int(v, 16) for v in c)  # noqa: E731
    from tachyon_tpu.zk.plonk.prover import ProvingKey as JaxProvingKey

    jpk = JaxProvingKey(jax_cs, maker().N,
                        *([jax_limbs(c) for c in key[f]] for f in
                          ("fixed_evals", "fixed_coeffs", "sigma_evals", "sigma_coeffs")),
                        [point(c) for c in key["fixed_commitments"]],
                        [point(c) for c in key["sigma_commitments"]],
                        [int(d, 16) for d in key["deltas"]])
    pk = plonk.pk_from_jax(jpk, CPU)
    assert pk.cs == port_cs
    assert type(pk.cs) is ConstraintSystem
    assert all(type(g.polys[0]).__module__ == ex.__name__ for g in pk.cs.gates)
    for field in ("fixed_evals", "fixed_coeffs", "sigma_evals", "sigma_coeffs"):
        assert words(getattr(pk, field)) == key[field], field
    again = plonk.pk_from_jax(jax_shaped_key(pk, jax_cs), CPU)
    for field in ("fixed_evals", "fixed_coeffs", "sigma_evals", "sigma_coeffs"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(again, field), getattr(pk, field)))
    assert again.cs == pk.cs and again.deltas == pk.deltas
    want = int(fixture()["cases"][name]["vk_transcript_repr"], 16)
    assert plonk.vk_transcript_repr(pk) == want


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_scans_equal_sequential(n):
    """The log-depth scans (``mont.scan``) and batch inverse give the words
    of the sequential products, sums and inverses (K1's outputs are
    canonical), along axis 1 of (W, n) and along axis 2 of (W, 3, n, 2)."""
    Fr = curves.bn254_fr(CPU)
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(6 * n)]
    vals[n // 2] = 0 if n > 2 else vals[n // 2]
    a = Fr.encode(vals[:n])
    prod, acc, tot = [], 1, 0
    sums = []
    for v in vals[:n]:
        prod.append(acc)
        acc = acc * v % R
        tot = (tot + v) % R
        sums.append(tot)
    assert list(Fr.decode(plonk._prefix_product(Fr, a))) == prod
    assert list(Fr.decode(mont.scan(Fr.add, a))) == sums
    inverse = lambda v: pow(v, R - 2, R)  # noqa: E731, pow(0, R - 2, R) = 0
    assert list(Fr.decode(Fr.batch_inverse(a))) == [inverse(v) for v in vals[:n]]
    cube = np.array(vals, dtype=object).reshape(3, n, 2)
    got = Fr.decode(Fr.batch_inverse(Fr.encode(cube), axis=2))
    assert (got == np.vectorize(inverse, otypes=[object])(cube)).all()
