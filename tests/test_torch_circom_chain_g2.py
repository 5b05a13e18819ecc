"""The port's circom Groth16 prove on the committed 130-constraint chain
key with its G2 MSM (B2 over 132 points) on the device path, the generic
sweep path over Fq2, against host-exact ints, on CPU (see
``test_torch_circom_chain.py``)."""
import torch

from test_torch_circom_chain import prove_chain

torch.set_num_threads(1)


def test_prove_chain_b2(monkeypatch):
    pr, proof, public = prove_chain(monkeypatch, ("b2",))
    assert pr.verify(proof, [public[0] + 1]) is False
