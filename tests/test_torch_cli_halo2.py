"""``python -m tachyon_tpu_torch.cli prove-halo2 ... --device cpu`` writes
the JAX bridge's hex proof of the recorder's multiplication circuit
(``tests/fixtures/torch_bridge_jax.json``), and ``prove --trace-path``
writes a chrome trace with the ``groth16_prove`` span; on CPU."""
import json

import torch

from test_torch_bridge import fixture, maker
from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch import cli

torch.set_num_threads(1)


def test_prove_halo2_writes_the_jax_hex(tmp_path, capsys):
    circuit = tmp_path / "circuit.json"
    circuit.write_text(json.dumps(maker().MUL_CIRCUIT))
    out = tmp_path / "proof.hex"
    assert cli.main(["prove-halo2", str(circuit), "--proof", str(out), "--device", "cpu"]) == 0
    assert out.read_text() == fixture()["halo2_prove"]["mul"] + "\n"
    assert "verified" in capsys.readouterr().out


def test_prove_trace_path(tmp_path):
    m = maker()
    trace = tmp_path / "trace.json"
    proof, public = tmp_path / "proof.json", tmp_path / "public.json"
    assert cli.main(["prove", f"{m.CIRCOM}.zkey", f"{m.CIRCOM}.wtns", "--no-zk", "--verify",
                     "--device", "cpu", "--proof", str(proof), "--public", str(public),
                     "--trace-path", str(trace)]) == 0
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"ProofGeneration/groth16_prove", "ProofVerification/groth16_verify"} <= names
    want = fixture()["groth16_prove"]
    assert json.loads(proof.read_text()) == json.loads(want["proof_json"])
    assert json.loads(public.read_text()) == json.loads(want["public_json"])
