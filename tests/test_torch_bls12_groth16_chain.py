"""The port's BLS12-381 Groth16 on the recorded square chain of 130
constraints, against the JAX package, on CPU: the setup here, and the
prove with each MSM on the device path in a file of its own.

``tests/fixtures/torch_groth16_bls12_381_jax.json`` (``scripts/
make_torch_bls12_groth16_fixture.py``) holds the JAX params and proof of
the chain at fixed r and s.  The port's setup must give the params point
for point.  With ``MSM_HOST_THRESHOLD`` lowered to 0 every query (132
variables, 130 private, 255 h points) is uploaded for the port's device
MSM path (the G1 sweep path runs the W = 12 kernels' plain twins on the
CPU, the G2 one the generic path over Fq2), and each proof must equal the
JAX proof tuple for tuple and verify.  One such MSM path costs ~20 s on
a CPU at W = 12 (the G2 one ~45 s), so five files share the chain's five
MSMs, each taking one on the device path and the rest on the host:
``test_torch_bls12_groth16_chain_{a,b1,l,h,g2}.py``.
"""
import json

import torch

from tachyon_tpu_torch.math.msm import MSM_NAIVE_THRESHOLD
from tachyon_tpu_torch.zk.groth16 import r1cs

from test_torch_bls12_groth16 import FAMILY, FIXTURE, case
from test_torch_groth16 import fixture_params, point

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


def test_setup_equals_jax_params_chain():
    fx = json.loads(FIXTURE.read_text())
    entry, circuit, _, _, secrets, _, _ = case(fx, "chain")
    got = r1cs.setup(circuit, FAMILY, rng=iter(secrets).__next__, device="cpu")
    assert got == fixture_params(entry, circuit)
    assert min(len(got.a_query), len(got.b2_query), len(got.l_query), len(got.h_query)) > 128

