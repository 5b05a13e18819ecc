"""The halo2 entry of tachyon_tpu_torch/c/bridge.py against the JAX bridge's
hex proofs in ``tests/fixtures/torch_bridge_jax.json``, on CPU
(``bridge.init("cpu")``): the multiplication circuit of
``tachyon_tpu/c/test_capi.c`` (k = 4, SHPlonk) and a log-derivative lookup
(k = 5, GWC), each proved and self-verified by the port.  The halo2 files'
``int_field_ops`` fixture keeps each case under half a minute."""
import json

import pytest
import torch

from test_torch_bridge import fixture, maker
from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.c import bridge
from tachyon_tpu_torch.zk.plonk import halo2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_cpu():
    bridge.init("cpu")


@pytest.mark.parametrize("name", ["mul", "lookup_log_derivative"])
def test_halo2_prove(name):
    circuit = maker().HALO2_CIRCUITS[name]
    assert bridge.halo2_prove(json.dumps(circuit)) == fixture()["halo2_prove"][name]


def test_halo2_unsatisfied_circuit_raises():
    """A witness that breaks the gate does not verify, and the bridge raises."""
    bad = json.loads(json.dumps(maker().MUL_CIRCUIT))
    bad["assignments"]["advice"][0][1] = 13  # 3 * 4 != 13, copied to instance 12
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        bridge.halo2_prove(json.dumps(bad))


def test_json_circuit_builder():
    """The schema's expression tags build the expressions of the JAX bridge."""
    from tachyon_tpu_torch.zk.plonk import expressions as ex

    sels = [ex.Selector(0, True)]
    e = bridge._build_expr(["sum", ["prod", ["selector", 0], ["scaled", ["advice", 1, -1], 3]],
                            ["neg", ["sum", ["const", 5], ["challenge", 0, 1]]]], sels)
    assert e == ex.Sum(ex.Product(sels[0], ex.Scaled(ex.Advice(1, -1), 3)),
                       ex.Negated(ex.Sum(ex.Constant(5), ex.Challenge(0, 1))))
    for tag in (["fixed", 0, 0], ["instance", 2, 1]):
        assert bridge._build_expr(tag, sels) == {"fixed": ex.Fixed, "instance": ex.Instance}[
            tag[0]](tag[1], tag[2])
    with pytest.raises(ValueError, match="unknown expression tag"):
        bridge._build_expr(["pow", 2], sels)
    assert halo2.FR == maker().BN254_R
