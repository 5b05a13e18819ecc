"""The port's uni-STARK on CPU against the JAX package's recorded proof.

``tests/fixtures/torch_stark_jax.json`` holds the JAX ``UniStark`` proof of
the Fibonacci AIR on ``fib_trace(8)`` (``FRIConfig(1, 4, 2)``, a rate-4
``DuplexChallenger``), written by ``scripts/make_torch_stark_fixture.py``
(the JAX prove costs tens of minutes of XLA:CPU compile).  The port's
proof must equal it root for root and value for value; ``verify`` must
accept it and refuse a wrong public value and a tampered quotient opening.
The slow test records the JAX proof anew and compares.
"""
import json

import pytest
import torch

from scripts import make_torch_stark_fixture as fixture
from tachyon_tpu_torch.crypto import poseidon2
from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.crypto.fri import FRIConfig, TwoAdicFRIPCS
from tachyon_tpu_torch.fields import extensions, presets
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.zk.air import expressions as ax
from tachyon_tpu_torch.zk.air.stark import UniStark

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def stark():
    F = PrimeField(presets.BABY_BEAR, CPU)
    pcs = TwoAdicFRIPCS(F, extensions.baby_bear4(CPU), poseidon2.baby_bear_p3_w16(CPU),
                        FRIConfig(*fixture.CONFIG))
    return UniStark(pcs, fixture.fib_air(ax))


def challenger():
    return DuplexChallenger(poseidon2.baby_bear_p3_w16(CPU), rate=fixture.RATE)


@pytest.fixture(scope="module")
def proved(stark):
    trace, pubs = fixture.fib_trace(fixture.N)
    return stark.prove(trace, pubs, challenger()), pubs


def port_dict(F, proof):
    def base(a):
        return [int(v) for v in F.decode(a).reshape(-1)]

    def ext(a):
        return [base(a[d]) for d in range(a.shape[0])]

    return fixture.proof_dict(proof, base, ext)


def test_proof_equals_jax(stark, proved):
    proof, pubs = proved
    want = json.loads(fixture.FIXTURE.read_text())
    assert want["config"] == list(fixture.CONFIG) and want["public"] == pubs
    assert port_dict(stark.F, proof) == want["proof"]


def test_verify_accepts_and_rejects(stark, proved):
    proof, pubs = proved
    F = stark.F
    assert stark.verify(proof, pubs, challenger()) is True
    assert stark.verify(proof, pubs[:2] + [pubs[2] + 1], challenger()) is False
    q = proof.opened_values[1][0][0].clone()
    q[1, 0, 2] = (q[1, 0, 2] + 1) % F.p
    tampered = proof._replace(opened_values=(proof.opened_values[0], ((q,),)))
    assert stark.verify(tampered, pubs, challenger()) is False


def test_device_trace_gives_the_same_proof(stark, proved):
    """A canonical integer tensor (encoded on the device) proves as the
    numpy Python-int trace does."""
    trace, pubs = fixture.fib_trace(fixture.N)
    rows = torch.tensor([[int(v) % stark.F.p for v in r] for r in trace])
    again = stark.prove(rows, pubs, challenger())
    assert port_dict(stark.F, again) == port_dict(stark.F, proved[0])


@pytest.mark.slow
def test_fixture_rerecords():
    """The JAX package still gives the recorded proof (XLA:CPU compile:
    tens of minutes)."""
    assert fixture.record() == json.loads(fixture.FIXTURE.read_text())
