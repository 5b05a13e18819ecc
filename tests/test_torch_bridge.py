"""tachyon_tpu_torch/c/bridge.py against the JAX package's C ABI bridge, on
CPU (``bridge.init("cpu")``): every entry gives the bytes, hex and JSON of
``tests/fixtures/torch_bridge_jax.json`` (recorded from ``tachyon_tpu/c/bridge.py``
by ``scripts/make_torch_bridge_fixture.py``) on the recorder's inputs, and
bad byte counts, malformed streams and unknown platforms are errors.  The
halo2 cases are in ``test_torch_bridge_halo2.py``."""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import pytest
import torch

from tachyon_tpu_torch.c import bridge

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_bridge_jax.json"

torch.set_num_threads(1)


@lru_cache(maxsize=None)
def maker():
    """scripts/make_torch_bridge_fixture.py as a module (its JAX imports are
    inside its recording functions)."""
    path = ROOT / "scripts" / "make_torch_bridge_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_bridge_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


@pytest.fixture(autouse=True)
def on_cpu():
    assert bridge.init("cpu") == torch.device("cpu")


@pytest.mark.parametrize("n", [3, 64])
def test_msm_g1(n):
    bases, scalars = maker().msm_inputs(n)
    assert bridge.msm_g1(bases, scalars, n).hex() == fixture()["msm_g1"][str(n)]


def test_msm_g1_infinity():
    G = (1).to_bytes(32, "little") + (2).to_bytes(32, "little")
    r = maker().BN254_R
    assert bridge.msm_g1(G * 2, (1).to_bytes(32, "little") + (r - 1).to_bytes(32, "little"),
                         2) == b"\x00" * 64


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("inverse", [0, 1])
def test_fft(n, inverse):
    data = maker().fft_inputs(n)
    out = bridge.fft(data, n, inverse)
    assert out.hex() == fixture()["fft"][f"{n}_{inverse}"]
    assert bridge.fft(out, n, 1 - inverse) == data


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_poseidon2_hash(n):
    out = bridge.poseidon2_hash(maker().poseidon2_inputs(n), n)
    assert out.hex() == fixture()["poseidon2_hash"][str(n)]


def test_groth16_prove():
    m = maker()
    proof, public = bridge.groth16_prove(f"{m.CIRCOM}.zkey", f"{m.CIRCOM}.wtns", 1, 1)
    want = fixture()["groth16_prove"]
    assert proof == want["proof_json"]
    assert public == want["public_json"]


@pytest.mark.parametrize("name", ["capi_8x2", "two_16x4_8x3"])
def test_sp1(name):
    m = maker()
    shapes, blowup, queries, pow_bits = m.SP1_STREAMS[name]
    blob = m.sp1_stream(shapes)
    want = fixture()["sp1"][name]
    assert bridge.sp1_baby_bear_fri_commit(blowup, blob).hex() == want["commit"]
    assert bridge.sp1_baby_bear_fri_prove_verify(blowup, queries, pow_bits,
                                                 blob).hex() == want["prove_verify"]


@pytest.mark.parametrize("call", [
    lambda: bridge.msm_g1(b"\x00" * 63, b"\x00" * 32, 1),
    lambda: bridge.msm_g1(b"\x00" * 64, b"\x00" * 31, 1),
    lambda: bridge.fft(b"\x00" * 32 * 7, 8, 0),
    lambda: bridge.poseidon2_hash(b"\x00" * 33, 1),
    lambda: bridge.sp1_baby_bear_fri_commit(1, b"\x01\x00\x00"),
    lambda: bridge.sp1_baby_bear_fri_commit(1, (1).to_bytes(4, "little") + b"\x08\x00\x00\x00"),
    lambda: bridge.sp1_baby_bear_fri_commit(1, maker().sp1_stream(((8, 2),)) + b"\x00" * 4),
], ids=["msm_bases", "msm_scalars", "fft", "poseidon2", "sp1_unaligned", "sp1_header",
        "sp1_trailing"])
def test_bad_byte_counts(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("platform", ["tpu", "cuda:7", "metal"])
def test_unknown_platform(platform):
    with pytest.raises(ValueError, match="unknown platform"):
        bridge.init(platform)
    assert bridge.device() == torch.device("cpu")


@pytest.mark.parametrize("platform", ["cuda", "gpu", "", None])
def test_card_platform_without_cuda(platform, monkeypatch):
    """No fallback: the card on a host without CUDA raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.init(platform)
    assert bridge.device() == torch.device("cpu")
