"""The port's BLS12-381 Groth16 prove on the recorded chain of 130
constraints with its G2 MSM (B2 over 132 points) on the device path, the
generic sweep path over Fq2 (K1's plain twin at W = 12 for every base
multiply on the CPU), against the JAX package, on CPU (see
``test_torch_bls12_groth16_chain.py``)."""
import torch

from test_torch_bls12_groth16_chain import prove_chain

torch.set_num_threads(1)


def test_prove_equals_jax_chain_b2(monkeypatch):
    g16, proof, public = prove_chain(monkeypatch, ("b2",))
    assert g16.verify(proof, [public[0] + 1]) is False
