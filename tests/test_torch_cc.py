"""The port's header-only C++ binding (``tachyon_tpu_torch/cc``) against the
JAX package's C ABI.

``make -C tachyon_tpu_torch/cc OUT=<tmp>`` builds the port's
``libtachyon_tpu_c.so`` and ``test_cc`` (g++, C++17) against
``tachyon_tpu.hpp``; ``test_cc cpu`` then runs every call of the header
but ``Halo2Prove`` (a halo2 proof takes minutes on the plain PyTorch path
in a process without the tests' Python-int field ops; ``chip_smoke.py``
runs it on the card) under ``Runtime("cpu")`` in its embedded interpreter,
on the inputs that ``scripts/make_torch_bridge_fixture.py`` gave the JAX
bridge: its MsmG1, Fft, Poseidon2Hash, Groth16Prove (no_zk) and SP1 bytes
must equal ``tests/fixtures/torch_bridge_jax.json``'s.  Its ``PYTHONPATH``
starts with a directory whose ``jax`` and ``tachyon_tpu`` raise on import.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CC_DIR = ROOT / "tachyon_tpu_torch" / "cc"
sys.path.insert(0, str(ROOT))

from scripts import make_torch_bridge_fixture as bridge_fixture  # noqa: E402

FIXTURE = json.loads((ROOT / "tests" / "fixtures" / "torch_bridge_jax.json").read_text())
SP1_CASE = "capi_8x2"


def jobs(d: Path) -> list[str]:
    """Write the recorded groups' inputs into d; the test_cc jobs that read them."""
    out = []
    for n in (3, 64):
        bases, scalars = bridge_fixture.msm_inputs(n)
        (d / f"msm{n}.bases").write_bytes(bases)
        (d / f"msm{n}.scalars").write_bytes(scalars)
        out.append(f"msm:msm{n}")
    for n in (8, 16):
        for inv in (0, 1):
            (d / f"fft{n}_{inv}.in").write_bytes(bridge_fixture.fft_inputs(n))
            out.append(f"fft:fft{n}_{inv}:{inv}")
    for n in range(1, 6):
        (d / f"poseidon2_{n}.in").write_bytes(bridge_fixture.poseidon2_inputs(n))
        out.append(f"poseidon2:poseidon2_{n}")
    shutil.copy(f"{bridge_fixture.CIRCOM}.zkey", d / "mul.zkey")
    shutil.copy(f"{bridge_fixture.CIRCOM}.wtns", d / "mul.wtns")
    out.append("groth16:mul")
    shapes, blowup, queries, pow_bits = bridge_fixture.SP1_STREAMS[SP1_CASE]
    (d / "sp1.bin").write_bytes(bridge_fixture.sp1_stream(shapes))
    (d / "sp1_pv.bin").write_bytes(bridge_fixture.sp1_stream(shapes))
    out += [f"sp1_commit:sp1:{blowup}", f"sp1_prove:sp1_pv:{blowup}:{queries}:{pow_bits}"]
    return out


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    out = tmp_path_factory.mktemp("cc")
    r = subprocess.run(["make", "-C", str(CC_DIR), f"OUT={out}"], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    block = tmp_path_factory.mktemp("block")
    for pkg in ("jax", "tachyon_tpu"):
        (block / pkg).mkdir()
        (block / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is blocked: the port must not import it')\n")
    site = [p for p in sys.path if p.endswith("-packages") and os.path.isdir(p)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(block), str(ROOT), *site]))
    data = tmp_path_factory.mktemp("jobs")
    r = subprocess.run([str(out / "test_cc"), "cpu", str(data), *jobs(data)],
                       capture_output=True, text=True, env=env, timeout=600)
    return r, data


def test_runs_every_job_and_the_error_model(ran):
    r, _ = ran
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stdout + r.stderr
    assert r.stdout.startswith("version 0.2.0, platform cpu")


def test_msm_fft_poseidon2_bytes_equal_the_jax_bridge(ran):
    r, d = ran
    assert r.returncode == 0, r.stderr
    for n in (3, 64):
        assert (d / f"msm{n}.out").read_bytes().hex() == FIXTURE["msm_g1"][str(n)]
    for key, want in FIXTURE["fft"].items():  # "8_0": n = 8, forward
        assert (d / f"fft{key}.out").read_bytes().hex() == want
    for n in range(1, 6):
        assert (d / f"poseidon2_{n}.out").read_bytes().hex() == FIXTURE["poseidon2_hash"][str(n)]


def test_groth16_and_sp1_equal_the_jax_bridge(ran):
    r, d = ran
    assert r.returncode == 0, r.stderr
    want = FIXTURE["groth16_prove"]
    assert json.loads((d / "mul.proof.json").read_text()) == json.loads(want["proof_json"])
    assert json.loads((d / "mul.public.json").read_text()) == json.loads(want["public_json"])
    assert (d / "sp1.out").read_bytes().hex() == FIXTURE["sp1"][SP1_CASE]["commit"]
    assert (d / "sp1_pv.out").read_bytes().hex() == FIXTURE["sp1"][SP1_CASE]["prove_verify"]
