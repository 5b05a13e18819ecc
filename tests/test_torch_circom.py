"""The port's circom Groth16 prover (``zk/groth16/prover.py``) and its
``prove`` command line (``tachyon_tpu_torch/cli.py``) against the JAX
package, on CPU.

``scripts/make_torch_circom_fixture.py`` records the JAX package's
``CircomGroth16Prover`` on the committed key files (``torch_circom_jax.json``):
the witness map of the toy circuit (domain 4), of a square chain of 130
constraints (domain 256) and of a bit chain (domain 512, whose A rows of
3, 5 and 254 terms take the segment sums through eight rounds), and the
toy's proofs, deterministic and at fixed r and s, with the verdicts.  Here the port's witness map must give the JAX
words, its proofs the JAX tuples (the toy's MSMs on the naive path), and
the command line the snarkjs JSON of the JAX tuple; a wrong witness makes
the command line exit 1.  The chain's proof is held in
``test_torch_circom_chain*.py`` (a file under a minute each).  The slow test
records the fixture again and requires equality.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from tachyon_tpu_torch import cli
from tachyon_tpu_torch.io import zkey
from tachyon_tpu_torch.ops import mont
from tachyon_tpu_torch.zk.groth16 import prover

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import circom_key  # noqa: E402
import make_torch_circom_fixture as maker  # noqa: E402

torch.set_num_threads(1)

FIXTURE = REPO / "tests" / "fixtures" / maker.JSON_NAME


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


def point(p):
    """A fixture point (hex list, or two for G2; null) -> ints."""
    if p is None:
        return None
    if isinstance(p[0], list):
        return tuple(tuple(int(v, 16) for v in c) for c in p)
    return tuple(int(v, 16) for v in p)


def load(name):
    """(zkey, standard-form witness words, prover) of a committed key, on CPU."""
    zpath, wpath = maker.paths(name)
    zk = zkey.parse_zkey(str(zpath), device="cpu")
    _, w = zkey.parse_wtns(str(wpath))
    return zk, w, prover.CircomGroth16Prover(zk, device="cpu")


@pytest.mark.parametrize("name", maker.CIRCUITS)
def test_witness_map_equals_jax(fx, name):
    zk, w, pr = load(name)
    assert (zk.domain_size, zk.num_vars) == (fx["circuits"][name]["domain_size"],
                                             fx["circuits"][name]["num_vars"])
    # rounds of the segmented suffix scan: log2 of the longest segment
    assert len(pr._shifts) == {"mul": 1, "chain": 1, "bits": 8}[name]
    h = pr.witness_map(mont.to_mont(pr.Fr.spec, w))
    assert h.shape == (pr.Fr.W, zk.domain_size)
    assert [hex(int(v)) for v in pr.Fr.decode(h)] == fx["circuits"][name]["witness_map"]


def test_prove_equals_jax_mul(fx):
    entry = fx["circuits"]["mul"]
    zk, w, pr = load("mul")
    r, s = int(entry["r"], 16), int(entry["s"], 16)
    public = prover.public_inputs(zk, w)
    assert [hex(v) for v in public] == entry["public"]
    det = pr.prove(w, deterministic=True)
    assert tuple(det) == tuple(point(p) for p in entry["proof_deterministic"])
    proof = pr.prove(w, r=r, s=s)
    assert tuple(proof) == tuple(point(p) for p in entry["proof"])
    assert pr.verify(proof, public) is entry["verify"] is True
    assert pr.verify(proof, [v + 1 for v in public]) is entry["verify_public_plus_1"] is False
    assert pr.verify(det, public) is entry["verify_deterministic"] is True


def test_cli_mul(fx, tmp_path, capsys):
    """``prove --device cpu --no-zk --verify`` writes the snarkjs JSON of the
    JAX deterministic tuple; a witness that breaks x * y = z exits 1."""
    entry = fx["circuits"]["mul"]
    zpath, wpath = maker.paths("mul")
    out = ["--proof", str(tmp_path / "proof.json"), "--public", str(tmp_path / "public.json")]
    args = ["prove", str(zpath), str(wpath), "--device", "cpu", "--no-zk", "--verify"]
    assert cli.main(args + out) == 0
    want = prover.Groth16Proof(*(point(p) for p in entry["proof_deterministic"]))
    assert json.loads((tmp_path / "proof.json").read_text()) == cli.proof_json(want)
    assert json.loads((tmp_path / "public.json").read_text()) == \
        [str(int(v, 16)) for v in entry["public"]]
    err = capsys.readouterr().err
    assert "parse zkey:" in err and "prove[0]:" in err and "-> True" in err

    (circuit, public, private), _, _, _ = maker.inputs("mul")
    circom_key.write_wtns(tmp_path / "bad.wtns", [1] + public + [private[0] + 1] + private[1:])
    assert cli.main(["prove", str(zpath), str(tmp_path / "bad.wtns"), "--device", "cpu",
                     "--no-zk", "--verify"] + out) == 1
    assert "PROOF VERIFICATION FAILED" in capsys.readouterr().err


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx, tmp_path):
    """The writer and the JAX package, run again, give the committed key
    files and fixture (about 25 minutes on a CPU)."""
    maker.write_keys(tmp_path)
    for name in maker.CIRCUITS:
        for got, want in zip(maker.paths(name, tmp_path), maker.paths(name)):
            assert got.read_bytes() == want.read_bytes()
    assert maker.record(tmp_path) == fx
