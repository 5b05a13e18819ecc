"""A proving key written by the JAX package, proven from by the port, on CPU.

``load_proving_key`` reads the ``save_proving_key`` JSON that the JAX
package wrote for the fixture case ``simple_shplonk``
(``tests/fixtures/torch_halo2_jax.json``); ``Halo2Prover`` on
``TorchBackend`` (CPU) must prove from it to the JAX proof's bytes, and the
port's ``save_proving_key`` of its own key must write the JAX document
(see ``test_torch_halo2.py``)."""
import json

import torch

from test_torch_halo2 import fixture, instances, int_field_ops, maker  # noqa: F401 (autouse fixture)
from tachyon_tpu_torch.zk.plonk import circuits, halo2
from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

torch.set_num_threads(1)


def test_jax_written_key_proves_to_jax_bytes(tmp_path):
    case = fixture()["cases"]["simple_shplonk"]
    path = tmp_path / "pk.json"
    path.write_text(case["proving_key"])
    pk = halo2.load_proving_key(str(path), "cpu")
    assert pk.pinned_vk == case["pinned_vk"]
    assert hex(pk.transcript_repr) == case["transcript_repr"]
    proof = halo2.Halo2Prover(pk, backend=TorchBackend(pk, "cpu")).create_proof(
        maker().build(circuits, case), instances(case)).proof
    assert proof.hex() == case["proof"]
    assert halo2.Halo2Verifier(pk).verify(proof, instances(case)) is True

    # the port's key, saved, is the JAX document
    own = halo2.keygen(circuits.SimpleCircuit(), case["k"], device="cpu")
    halo2.save_proving_key(own, str(tmp_path / "own.json"))
    assert json.loads((tmp_path / "own.json").read_text()) == json.loads(case["proving_key"])
