"""One live comparison of the port's halo2 prover with the JAX package's,
on CPU: SimpleCircuit(constant=5, a=3, b=11), k = 4, Scroll, SHPlonk, one
circuit (the fixture's cases prove two).

The JAX ``keygen`` and ``Halo2Prover`` on ``HostBackend`` (exact host ints,
about half a minute on a CPU) against the port's ``keygen`` and
``TorchBackend`` on the CPU: the same pinned VK, the same challenges and
evaluations, the same proof bytes; each verifier accepts the other's
proof."""
import torch

from tachyon_tpu.zk.plonk import halo2 as jhalo2
from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from tests.circuits_halo2 import SimpleCircuit as JSimpleCircuit
from tachyon_tpu_torch.zk.plonk import circuits, halo2
from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

torch.set_num_threads(1)

ARGS = {"constant": 5, "a": 3, "b": 11}


def test_simple_circuit_live_vs_jax():
    jpk = jhalo2.keygen(JSimpleCircuit(**ARGS), k=4)
    jc = [JSimpleCircuit(**ARGS)]
    insts = [c.instance_columns() for c in jc]
    want = jhalo2.Halo2Prover(jpk).create_proof(jc, insts)

    pk = halo2.keygen(circuits.SimpleCircuit(**ARGS), 4, device="cpu")
    pc = [circuits.SimpleCircuit(**ARGS)]
    assert [c.instance_columns() for c in pc] == insts
    got = halo2.Halo2Prover(pk, backend=TorchBackend(pk, "cpu")).create_proof(pc, insts)

    assert pk.pinned_vk == jpk.pinned_vk and pk.transcript_repr == jpk.transcript_repr
    for field in ("theta", "beta", "gamma", "y", "x", "h_eval", "advice_evals", "fixed_evals",
                  "common_permutation_evals", "permutation_product_evals",
                  "advice_commitments", "h_commitments"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.proof == want.proof
    assert halo2.Halo2Verifier(pk).verify(want.proof, insts) is True
    assert jhalo2.Halo2Verifier(jpk).verify(got.proof, insts) is True
