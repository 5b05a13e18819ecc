"""Pallas and Vesta (y^2 = x^3 + 5, each the other's scalar field; 255-bit
p, so the spare-bit kernels on the card, as BN254): the port's point ops
against the JAX package on CPU, word for word (``test_torch_secp256k1``'s
``check_point_ops``: K2, K3 and K4's twins against the JAX formulas on
lanes that double, cancel and hold infinity, and to_affine's words)."""
import pytest
import torch

from test_torch_secp256k1 import check_point_ops

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["pallas", "vesta"])
def test_point_ops_vs_jax(name):
    check_point_ops(name, jax_to_affine=False)
