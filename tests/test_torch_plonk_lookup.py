"""The port's PLONK prover against the JAX package's on the lookup and
shuffle cases of ``tests/fixtures/torch_plonk_jax.json`` (a halo2 and a
log-derivative range lookup, a shuffle; n = 16), byte for byte, and the
verifier's refusals; on CPU (see ``test_torch_plonk.py``)."""
import pytest
import torch

from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from test_torch_plonk import check_case, setup
from tachyon_tpu_torch.zk.plonk import prover as plonk

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["lookup_halo2", "lookup_log_derivative"])
def test_lookup_vs_jax(name):
    case, params, pk, proof = check_case(name)
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    assert plonk.PlonkVerifier(params, pk).verify(bytes(bad), []) is False


@pytest.mark.parametrize("name", ["lookup_halo2", "lookup_log_derivative"])
def test_out_of_table_refused(name):
    """An input outside the table stops the honest prover."""
    case, params, pk = setup(name)
    advice = [list(case["advice"][0])]
    advice[0][3] = 99
    with pytest.raises(ValueError, match="not in table"):
        plonk.PlonkProver(params, pk).prove(advice, [])


def test_shuffle_vs_jax():
    case, params, pk, proof = check_case("shuffle")
    a, b = case["advice"]
    b_bad = list(b)
    b_bad[0] += 1  # no longer a permutation of a
    bad = plonk.PlonkProver(params, pk).prove([a, b_bad], [])
    assert plonk.PlonkVerifier(params, pk).verify(bad, []) is False
