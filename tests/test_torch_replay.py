"""tachyon_tpu_torch/io/replay.py: an MSM dumped and replayed gives the same
point, a dump written by the JAX package's ``dump_msm`` replays in the port,
the Groth16 prover dumps where the JAX one does, and the halo2 dump holds
the circuit; on CPU."""
import json
import os

import numpy as np
import pytest
import torch

from tachyon_tpu.io import replay as jreplay
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.io import replay
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math.ec import AffinePoint

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _inputs(n=5):
    g1 = curves.bn254_g1(CPU)
    P, R = g1.F.p, g1.SF.p
    pts = [host_ec.scalar_mul((1, 2), 11 * i + 3, 0, P) for i in range(n)]
    pts[0] = None
    ks = [pow(5, 30 + i, R) for i in range(n)]
    ks[n - 1] = 0
    aff = AffinePoint(
        g1.F.encode([p[0] if p else 0 for p in pts]),
        g1.F.encode([p[1] if p else 0 for p in pts]),
        torch.tensor([p is None for p in pts]))
    want = host_ec.msm([p for p in pts], ks, 0, P)
    return aff, limbs.from_ints(ks, g1.SF.W, CPU), want


@pytest.fixture
def dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TACHYON_MSM_DUMP_PATH", str(tmp_path))
    monkeypatch.setenv("TACHYON_HALO2_DUMP_PATH", str(tmp_path))
    return tmp_path


def test_no_dump_without_env(monkeypatch):
    monkeypatch.delenv("TACHYON_MSM_DUMP_PATH", raising=False)
    aff, sc, _ = _inputs(2)
    assert replay.dump_msm("bn254_g1", aff, sc) is None


def test_dump_then_replay(dump_dir):
    aff, sc, want = _inputs()
    fn = replay.dump_msm("bn254_g1", aff, sc)
    assert os.path.dirname(fn) == str(dump_dir)
    data = np.load(fn)
    assert sorted(data.files) == ["curve", "inf", "scalars", "x", "y"]
    assert data["x"].dtype == np.uint32 and data["x"].shape == (16, 5)
    assert np.array_equal(data["x"], limbs.to_jax_limbs(aff.x))
    assert replay.replay_msm(fn, CPU) == want


def test_jax_layout_dump_replays(dump_dir):
    aff, sc, want = _inputs()
    fn = jreplay.dump_msm("bn254_g1", limbs.to_jax_limbs(aff.x), limbs.to_jax_limbs(aff.y),
                          aff.inf.numpy(), limbs.to_jax_limbs(sc))
    assert replay.replay_msm(fn, CPU) == want
    ported = replay.dump_msm("bn254_g1", aff, sc)
    a, b = np.load(fn), np.load(ported)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_main_replays(dump_dir, capsys):
    aff, sc, want = _inputs(3)
    fn = replay.dump_msm("bn254_g1", aff, sc)
    assert replay.main(["msm", fn, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"x = {want[0]}" in out and f"y = {want[1]}" in out


def test_halo2_dump_holds_the_circuit(dump_dir):
    circuit = json.dumps({"k": 4})
    fn = replay.dump_halo2(circuit)
    assert fn.endswith(".json") and open(fn).read() == circuit
