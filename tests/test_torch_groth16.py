"""The port's native Groth16 over BN254 (``zk/groth16/r1cs.py``) against the
JAX package, on CPU.

The JAX flow takes minutes on a CPU (its witness map compiles), so
``scripts/make_torch_groth16_fixture.py`` records it in
``tests/fixtures/torch_groth16_jax.json``: for the toy x * y = z circuit
and a square chain of 130 constraints (every query above 128 points), the
params from a fixed ``rng``, a proof at fixed r and s, and the verdicts.
Here the port's ``setup`` must give the params point for point, ``prove``
the proof tuple for tuple with ``MSM_HOST_THRESHOLD`` lowered to 0 (every
MSM, B1 and the G2 MSM included, on the port's device path: the plain
twins on the CPU), and ``verify`` the verdicts.  The chain circuit's proof
is held in ``test_torch_groth16_chain.py`` (a file under a minute each).
The slow test re-records the fixture and requires equality.
"""
import importlib.util
import json
import types
from pathlib import Path

import pytest
import torch

from tachyon_tpu.zk.groth16 import r1cs as jr1cs
from tachyon_tpu_torch.math import curves, pairing_bls12_381
from tachyon_tpu_torch.zk.groth16 import circuits, r1cs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_groth16_jax.json"


def maker():
    """scripts/make_torch_groth16_fixture.py as a module (its JAX imports
    are inside its recorders)."""
    path = REPO / "scripts" / "make_torch_groth16_fixture.py"
    mod_spec = importlib.util.spec_from_file_location("make_torch_groth16_fixture", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def point(p):
    """A fixture point (hex list, or two for G2; null) -> ints."""
    if p is None:
        return None
    if isinstance(p[0], list):
        return tuple(tuple(int(v, 16) for v in c) for c in p)
    return tuple(int(v, 16) for v in p)


def fixture_params(entry, circuit) -> r1cs.Groth16Params:
    """The recorded JAX params as the port's, through ``params_from_jax``."""
    fp = entry["params"]
    ns = types.SimpleNamespace(family=fp["family"], r1cs=circuit, n=fp["n"])
    for k, v in fp.items():
        if k not in ("family", "n"):
            setattr(ns, k, [point(p) for p in v] if k.endswith("query") or k == "ic"
                    else point(v))
    return r1cs.params_from_jax(ns)


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


def case(fx, name):
    """(fixture entry, port circuit, public, private, secrets, r, s)."""
    build, secrets, r, s = maker().inputs(name)
    circuit, public, private = build(r1cs.R1CS)
    return fx["circuits"][name], circuit, public, private, secrets, r, s


@pytest.mark.parametrize("name", ["mul", "chain"])
def test_setup_equals_jax_params(fx, name):
    entry, circuit, _, _, secrets, _, _ = case(fx, name)
    assert [hex(v) for v in secrets] == entry["secrets"]
    got = r1cs.setup(circuit, "bn254", rng=iter(secrets).__next__, device="cpu")
    assert got == fixture_params(entry, circuit)
    if name == "chain":
        assert min(len(got.a_query), len(got.b2_query), len(got.l_query),
                   len(got.h_query)) > 128


def test_prove_equals_jax_mul(fx, monkeypatch):
    """Every MSM on the device path; the proof verifies, fails for the
    public input + 1, and rerandomizes."""
    monkeypatch.setattr(r1cs, "MSM_HOST_THRESHOLD", 0)
    entry, circuit, public, private, _, r, s = case(fx, "mul")
    g16 = r1cs.Groth16(fixture_params(entry, circuit), device="cpu")
    assert all(p is not None for p in (g16._a_pts, g16._b1_pts, g16._b2_pts, g16._l_pts,
                                       g16._h_pts))
    proof = g16.prove(public, private, r=r, s=s)
    assert tuple(proof) == tuple(point(p) for p in entry["proof"])
    assert g16.verify(proof, public) is True
    assert g16.verify(proof, [public[0] + 1]) is False
    rr = g16.rerandomize(proof)
    assert rr != proof and g16.verify(rr, public) is True


@pytest.mark.parametrize("name", ["mul", "chain"])
def test_verify_verdicts(fx, name):
    """The port's host verify on the recorded proof gives the JAX verdicts."""
    entry, circuit, public, _, _, _, _ = case(fx, name)
    g16 = r1cs.Groth16(fixture_params(entry, circuit), device="cpu")
    proof = r1cs.Groth16Proof(*(point(p) for p in entry["proof"]))
    assert g16.verify(proof, public) is entry["verify"] is True
    assert g16.verify(proof, [v + 1 for v in public]) is entry["verify_public_plus_1"] is False


def test_params_from_jax_round_trip(fx):
    """The JAX package's own params object (its setup on the toy circuit,
    from the recorded secrets) crosses over equal to the recorded params,
    which the port's setup gives (test_setup_equals_jax_params)."""
    entry, circuit, _, _, secrets, _, _ = case(fx, "mul")
    jp = jr1cs.setup(maker().inputs("mul")[0](jr1cs.R1CS)[0], "bn254",
                     rng=iter(secrets).__next__)
    got = r1cs.params_from_jax(jp)
    assert got == fixture_params(entry, circuit)
    assert isinstance(got.r1cs, r1cs.R1CS) and got.r1cs == circuit


def test_families_and_lagrange():
    """bls12_381 runs: the toy circuit's setup, prove and verify round trip
    (its params and proof against the JAX package in
    ``test_torch_bls12_groth16.py``); an unknown family raises; the
    batch-inverted Lagrange values equal the JAX package's Fermat ones."""
    circuit, public, private = circuits.mul_circuit(r=pairing_bls12_381.R)
    secrets = iter([11, 12, 13, 14, 15]).__next__
    g16 = r1cs.Groth16(r1cs.setup(circuit, "bls12_381", rng=secrets, device="cpu"), device="cpu")
    proof = g16.prove(public, private, r=5, s=6)
    assert g16.verify(proof, public) is True
    assert g16.verify(proof, [public[0] + 1]) is False
    with pytest.raises(ValueError, match="unknown curve family"):
        r1cs.setup(circuit, "bls12_377", device="cpu")
    Fr = curves.bn254_fr("cpu")
    omega = Fr.spec.root_of_unity(16)
    for tau in (12345, omega ** 3 % Fr.p):  # a tau on the domain gives zeros
        assert r1cs._lagrange_at_tau(Fr.p, 16, omega, tau) == \
            jr1cs._lagrange_at_tau(Fr.p, 16, omega, tau)


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed fixture (minutes)."""
    assert maker().record() == fx
