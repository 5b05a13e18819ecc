"""The port's halo2 prover with the PSE vendor and GWC: the fixture case
``simple_gwc`` (SimpleCircuit at k = 4) proves to the JAX package's
recorded Scroll bytes, verifies, and is refused with a byte flipped (see
``test_torch_halo2_pse.py``)."""
import torch

from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from test_torch_halo2_pse import check_pse_case

torch.set_num_threads(1)


def test_pse_gwc_equals_scroll_bytes_and_verifies():
    check_pse_case("simple_gwc")
