"""The port's SHPlonk and GWC against the JAX package, on CPU.

``tests/test_multiopen.py``'s setting: ``kzg.unsafe_setup(8, tau=0x5EED)``,
three seeded polynomials opened at (3, 5), (3, 5), (7,).  The JAX KZG path
compiles for minutes on a CPU, so its proofs are recorded by
``scripts/make_torch_multiopen_fixture.py`` into
``tests/fixtures/torch_multiopen_jax.json``; the port's commitments and
proof bytes must equal them, its verifier accept them and refuse a
tampered value, as the JAX verifier did.  The slow test re-records the
fixture and compares.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from tachyon_tpu_torch.crypto import kzg
from tachyon_tpu_torch.crypto.multiopen import GWC, SHPlonk, ProverOpening, VerifierOpening
from tachyon_tpu_torch.crypto.transcript import (
    ProofDecodeError, TranscriptReader, TranscriptWriter,
)
from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.ops import mont

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_multiopen_jax.json"
SCHEMES = {"shplonk": SHPlonk, "gwc": GWC}


def maker():
    path = REPO / "scripts" / "make_torch_multiopen_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_multiopen_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def port(fx):
    """The port's params, openings and commitments on the fixture's inputs."""
    m = maker()
    assert [[hex(c) for c in cs] for cs in m.inputs()] == fx["coeffs"]
    params = kzg.unsafe_setup(fx["n"], int(fx["tau"], 16), "cpu")
    Fr = curves.bn254_fr("cpu")
    pro, ver = [], []
    for coeffs, pts in zip(m.inputs(), m.POINT_SETS):
        enc = Fr.encode(coeffs)
        cm = kzg.to_int_point(kzg.commit(params, mont.mont_reduce(Fr.spec, enc)))
        pro.append(ProverOpening(enc, pts))
        ver.append(VerifierOpening(cm, pts, tuple(m.values(coeffs, pts))))
    return params, pro, ver


def reader(proof: bytes):
    return TranscriptReader(proof, presets.BN254_FR, presets.BN254_FQ)


def test_commitments_and_values(fx, port):
    _, _, ver = port
    assert [[hex(v) for v in o.commitment] for o in ver] == fx["commitments"]
    assert [[hex(v) for v in o.values] for o in ver] == fx["values"]


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_proof_bytes_vs_jax(fx, port, name):
    params, pro, ver = port
    scheme = SCHEMES[name](params)
    w = TranscriptWriter(presets.BN254_FR, presets.BN254_FQ)
    scheme.create_opening_proof(pro, w)
    want = fx["schemes"][name]
    assert bytes(w.proof).hex() == want["proof"]
    assert scheme.verify_opening_proof(ver, reader(bytes(w.proof))) is want["verified"] is True


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_tampered_refused(fx, port, name):
    params, _, ver = port
    proof = bytes.fromhex(fx["schemes"][name]["proof"])
    bad = list(ver)
    bad[0] = VerifierOpening(ver[0].commitment, ver[0].points,
                             ((ver[0].values[0] + 1) % presets.BN254_FR.p,) + ver[0].values[1:])
    scheme = SCHEMES[name](params)
    assert scheme.verify_opening_proof(bad, reader(proof)) is False
    assert fx["schemes"][name]["tampered_verified"] is False
    flipped = bytearray(proof)
    flipped[5] ^= 1
    try:
        ok = scheme.verify_opening_proof(ver, reader(bytes(flipped)))
    except ProofDecodeError:  # the flipped x is off the curve
        ok = False
    assert ok is False


@pytest.mark.slow
def test_fixture_matches_jax(fx, tmp_path):
    """Re-record the fixture from the JAX package into a temporary
    directory (minutes of XLA:CPU compile) and compare."""
    out = tmp_path / "torch_multiopen_jax.json"
    assert maker().main(["--out", str(out)]) == 0
    assert json.loads(out.read_text()) == fx
