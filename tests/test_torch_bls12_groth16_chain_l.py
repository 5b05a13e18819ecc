"""The port's BLS12-381 Groth16 prove on the recorded chain of 130
constraints with its L MSM (130 points) on the device path (the
W = 12 kernels' plain twins), against the JAX package, on CPU (see
``test_torch_bls12_groth16_chain.py``)."""
import torch

from test_torch_bls12_groth16_chain import prove_chain

torch.set_num_threads(1)


def test_prove_equals_jax_chain_l(monkeypatch):
    prove_chain(monkeypatch, ("l",))
