"""The port's halo2 prover against the JAX package, on CPU: SimpleCircuit,
Scroll vendor, SHPlonk.

The JAX ``HostBackend`` (exact host ints) takes about half a minute a case
on a CPU, so its keys and proofs are recorded by
``scripts/make_torch_halo2_fixture.py`` into
``tests/fixtures/torch_halo2_jax.json``: for each case the port's
``keygen`` and ``Halo2Prover`` on ``TorchBackend`` (both on the
CPU, every MSM, NTT and quotient build on the plain twins) must give the
pinned VK, ``transcript_repr`` and proof bytes exactly.  One case a file
(``test_torch_halo2_*.py``): each proof takes 10-25 s on one core with
``int_field_ops`` installed.  Here also: the port's verifier, tampered
proofs, the lazy ``HostKZG``, the card as the default device, and the slow
re-recording of the fixture.
"""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu_torch.fields.limbs import from_ints, words_to_ints
from tachyon_tpu_torch.ops import cuda_mont, mont
from tachyon_tpu_torch.zk.plonk import circuits, halo2
from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_halo2_jax.json"


def maker():
    """scripts/make_torch_halo2_fixture.py as a module (its JAX imports are
    inside ``record_case``)."""
    path = REPO / "scripts" / "make_torch_halo2_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_halo2_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL_BATCH = 256  # CPU elements at or below which int_field_ops computes on Python ints


@pytest.fixture(scope="module", autouse=True)
def int_field_ops():
    """Python-int add, sub and multiply in place of the tensor program for
    CPU batches of at most SMALL_BATCH canonical elements of a field of
    W >= 8 words, for the tests of a module that defines or imports this
    fixture (the halo2 files).  A k = 4 proof runs tens of thousands of
    field ops on a handful of lanes, where the tensor program costs about
    1 ms an op against about 0.1 ms for the ints: a case takes 10-25 s
    instead of about 2 minutes.  The words are the same; the tensor
    program itself is held against the JAX package in
    ``test_torch_mont.py``, and the card's kernels in ``chip_smoke.py``
    phase 12."""
    def small_ints(f, a, b):
        W = a.shape[0]
        if W < 8 or not a.is_cpu or a.numel() > W * SMALL_BATCH:
            return None
        vals = [words_to_ints(t.contiguous().numpy().view(np.uint32).reshape(W, -1))
                for t in (a, b)]
        return None if any(v >= f.p for vs in vals for v in vs) else vals

    @lru_cache(maxsize=None)
    def r_inv(f):
        return pow(f.R, -1, f.p)

    def on_ints(plain, op):
        def run(f, a, b):
            a, b = torch.broadcast_tensors(a, b)
            if (v := small_ints(f, a, b)) is None:
                return plain(f, a, b)
            return from_ints([op(f, x, y) for x, y in zip(*v)], a.shape[0]).reshape(a.shape)
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mont, "add", on_ints(mont.add, lambda f, x, y: (x + y) % f.p))
        mp.setattr(mont, "sub", on_ints(mont.sub, lambda f, x, y: (x - y) % f.p))
        mp.setattr(cuda_mont, "mul_plain", on_ints(
            cuda_mont.mul_plain, lambda f, x, y: x * y % f.p * r_inv(f) % f.p))
        yield


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def instances(case: dict) -> list:
    return [[[int(v, 16) for v in col] for col in cols] for cols in case["instances"]]


@lru_cache(maxsize=None)
def prove_case(name: str):
    """The port's key and proof of one fixture case on the CPU."""
    case = fixture()["cases"][name]
    cs_ = maker().build(circuits, case)
    pk = halo2.keygen(cs_[0], case["k"], device="cpu", **case["keygen"])
    proof = halo2.Halo2Prover(pk, backend=TorchBackend(pk, "cpu")).create_proof(
        cs_, instances(case))
    return pk, proof.proof


def check_case(name: str):
    """Pinned VK, transcript_repr and proof bytes equal the JAX ones; the
    port's verifier accepts the proof, as the JAX verifier did."""
    case = fixture()["cases"][name]
    pk, proof = prove_case(name)
    assert pk.pinned_vk == case["pinned_vk"]
    assert hex(pk.transcript_repr) == case["transcript_repr"]
    assert [None if c is None else [hex(v) for v in c]
            for c in pk.fixed_commitments] == case["fixed_commitments"]
    assert [None if c is None else [hex(v) for v in c]
            for c in pk.permutation_commitments] == case["permutation_commitments"]
    assert proof.hex() == case["proof"]
    assert halo2.Halo2Verifier(pk).verify(proof, instances(case)) is case["verified"] is True
    return pk, proof


def test_simple_shplonk_vs_jax():
    check_case("simple_shplonk")


def test_tampered_proof_refused():
    """A flipped byte, a truncated proof and the public instance + 1 are
    refused by the port's verifier."""
    case = fixture()["cases"]["simple_shplonk"]
    pk, proof = prove_case("simple_shplonk")
    ver = halo2.Halo2Verifier(pk)
    insts = instances(case)
    for i in (0, len(proof) // 2, len(proof) - 1):
        bad = bytearray(proof)
        bad[i] ^= 1
        assert ver.verify(bytes(bad), insts) is False
    assert ver.verify(proof[:-32], insts) is False
    wrong = [[[(v + 1) % halo2.FR for v in col] for col in cols] for cols in insts]
    assert ver.verify(proof, wrong) is False


def test_backend_surface_vs_jax():
    """TorchBackend's commit, ifft and coset_evals on the CPU equal the JAX
    host oracle's (HostKZG.commit, host_ifft, _coset_evals)."""
    from tachyon_tpu.zk.plonk import halo2 as jhalo2

    pk, _ = prove_case("simple_shplonk")
    be = TorchBackend(pk, "cpu")
    vals = [(3 ** i * 0x1234567) % halo2.FR for i in range(pk.n - 3)]
    shift = halo2.halo2_zeta()
    assert be.ifft(vals + [0] * 3) == jhalo2.host_ifft(vals + [0] * 3, pk.omega)
    assert be.coset_evals(vals, shift) == jhalo2._coset_evals(vals, shift, pk.omega, pk.n)
    assert be.commit(vals) == jhalo2.HostKZG(pk.n, pk.kzg.tau).commit(vals)


def test_host_kzg_lazy():
    """HostKZG builds no base until one is read; then the JAX package's
    points, and a commitment equals the JAX one (an exact host MSM in the port)."""
    from tachyon_tpu.zk.plonk import halo2 as jhalo2

    assert halo2.HostKZG(1 << 20, 2)._bases is None
    small, jsmall = halo2.HostKZG(4, 5), jhalo2.HostKZG(4, 5)
    assert small.bases == jsmall.bases
    coeffs = [3, 0, 7, halo2.FR - 1]
    assert small.commit(coeffs) == jsmall.commit(coeffs)
    assert small.commit_lagrange(coeffs, halo2.halo2_omega(2)) == \
        jsmall.commit_lagrange(coeffs, jhalo2.halo2_omega(2))


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """keygen, TorchBackend, Halo2Prover with no backend and
    load_proving_key run on CUDA unless told otherwise: on a host without
    it they raise rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        halo2.keygen(circuits.SimpleCircuit(), 4)
    pk, _ = prove_case("simple_shplonk")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend(pk)
    with pytest.raises(RuntimeError, match="CUDA"):
        halo2.Halo2Prover(pk)
    path = tmp_path / "pk.json"
    halo2.save_proving_key(pk, str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        halo2.load_proving_key(str(path))


@pytest.mark.slow
def test_fixture_matches_jax(tmp_path):
    """Re-record the fixture from the JAX package into a temporary
    directory and compare (a few minutes of JAX host arithmetic)."""
    out = tmp_path / "torch_halo2_jax.json"
    assert maker().main(["--out", str(out)]) == 0
    assert json.loads(out.read_text()) == fixture()
