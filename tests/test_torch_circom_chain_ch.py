"""The port's circom Groth16 prove on the committed 130-constraint chain
key with its C and H MSMs (130 and 256 points) on the device path, against
host-exact ints, on CPU (see ``test_torch_circom_chain.py``)."""
import torch

from test_torch_circom_chain import prove_chain

torch.set_num_threads(1)


def test_prove_chain_c_h(monkeypatch):
    prove_chain(monkeypatch, ("c", "h"))
