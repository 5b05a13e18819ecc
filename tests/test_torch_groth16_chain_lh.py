"""The port's Groth16 prove on the recorded chain of 130 constraints with
its L and H MSMs (130 and 255 points) on the device path, against the JAX
package, on CPU (see ``test_torch_groth16_chain.py``)."""
import torch

from test_torch_groth16_chain import prove_chain

torch.set_num_threads(1)


def test_prove_equals_jax_chain_l_h(monkeypatch):
    prove_chain(monkeypatch, ("l", "h"))
