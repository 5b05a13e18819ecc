"""The port's Groth16 prove on the recorded square chain of 130 constraints,
against the JAX package, on CPU: here with its A and B1 MSMs on the device
path.

``tests/fixtures/torch_groth16_jax.json`` (``scripts/
make_torch_groth16_fixture.py``) holds the JAX params and proof of the
chain at fixed r and s.  With ``MSM_HOST_THRESHOLD`` lowered to 0 every
query (132 variables, 130 private, 255 h points) is uploaded for the
port's device MSM path (the G1 sweep path runs the kernels' plain twins on
the CPU, the G2 one the generic path over Fq2), and each proof must equal
the JAX proof tuple for tuple and verify.  One such MSM path costs 10-40 s
on a CPU, so three files share the chain's five MSMs, each file taking
its own on the device path and the rest on the host: this one A and B1,
``test_torch_groth16_chain_lh.py`` L and H, ``test_torch_groth16_chain_g2.py``
the G2 sum B2.
"""
import json

import torch

from tachyon_tpu_torch.math.msm import MSM_NAIVE_THRESHOLD
from tachyon_tpu_torch.zk.groth16 import r1cs

from test_torch_groth16 import FIXTURE, case, fixture_params, point

torch.set_num_threads(1)

MSMS = ("a", "b1", "b2", "l", "h")


def prove_chain(monkeypatch, on_device):
    """Prove the chain with the MSMs named in ``on_device`` on the device
    path and the others on the host; check the proof against the JAX one
    and the host pairing.  Returns the prover, the proof and the public
    input."""
    monkeypatch.setattr(r1cs, "MSM_HOST_THRESHOLD", 0)
    fx = json.loads(FIXTURE.read_text())
    entry, circuit, public, private, _, r, s = case(fx, "chain")
    g16 = r1cs.Groth16(fixture_params(entry, circuit), device="cpu")
    for name in MSMS:
        pts = getattr(g16, f"_{name}_pts")
        assert pts.inf.shape[0] > MSM_NAIVE_THRESHOLD
        if name not in on_device:
            setattr(g16, f"_{name}_pts", None)  # the host sum
    proof = g16.prove(public, private, r=r, s=s)
    assert tuple(proof) == tuple(point(p) for p in entry["proof"])
    assert g16.verify(proof, public) is True
    return g16, proof, public


def test_prove_equals_jax_chain_a_b1(monkeypatch):
    prove_chain(monkeypatch, ("a", "b1"))
