"""The port's C ABI (``tachyon_tpu_torch/c``): ``make`` builds
``libtachyon_tpu_c.so`` and ``test_capi`` into a temporary directory, the
unedited ``tests/abi_driver.py`` drives the library through the byte layouts
of the rs and node bindings, ``test_capi cpu`` runs its MSM, FFT and
Poseidon2 steps (its halo2 and SP1 steps run on the card, in
``chip_smoke.py``), the port's ``api.h`` declares every symbol of the JAX
package's, and ``tachyon_tpu_init`` fails where it should.

The library embeds CPython (or joins a ctypes caller's), so each run is a
subprocess; its ``PYTHONPATH`` starts with a directory whose ``jax`` and
``tachyon_tpu`` packages raise on import, so nothing the library runs can
reach the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from test_abi_conformance import declared_symbols

ROOT = Path(__file__).resolve().parent.parent
C_DIR = ROOT / "tachyon_tpu_torch" / "c"


def _symbols(header: Path) -> set:
    return set(re.findall(r"\b(tachyon_tpu_[a-z0-9_]+)\s*\(", header.read_text()))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = tmp_path_factory.mktemp("capi")
    r = subprocess.run(["make", "-C", str(C_DIR), f"OUT={out}"], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    block = tmp_path_factory.mktemp("block")
    for pkg in ("jax", "tachyon_tpu"):
        (block / pkg).mkdir()
        (block / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is blocked: the port must not import it')\n")
    site = [p for p in sys.path if p.endswith("-packages") and os.path.isdir(p)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(block), str(ROOT), *site])
    return out, env


def _run(cmd, env, timeout=300):
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


def test_api_h_declares_the_jax_surface(built):
    out, _ = built
    jax_syms = _symbols(ROOT / "tachyon_tpu" / "c" / "api.h")
    assert jax_syms <= _symbols(C_DIR / "api.h")
    nm = subprocess.run(["nm", "-D", "--defined-only", str(out / "libtachyon_tpu_c.so")],
                        capture_output=True, text=True, check=True).stdout
    exported = set(re.findall(r"\bT (tachyon_tpu_\w+)", nm))
    assert jax_syms <= exported, jax_syms - exported
    header = (C_DIR / "api.h").read_text()
    for v in ("MAJOR 0", "MINOR 2", "PATCH 0"):
        assert f"TACHYON_TPU_VERSION_{v}" in header


def test_abi_driver_on_the_port_library(built):
    out, env = built
    rc, stdout, stderr = _run([sys.executable, str(ROOT / "tests" / "abi_driver.py"),
                               str(out / "libtachyon_tpu_c.so"), *declared_symbols()], env)
    assert rc == 0 and "ABI_OK" in stdout, stdout + stderr


def test_capi_cpu_steps(built):
    out, env = built
    rc, stdout, stderr = _run([str(out / "test_capi"), "cpu", "msm,fft,poseidon2"], env)
    assert rc == 0 and stdout.strip().endswith("OK"), stdout + stderr
    assert "platform cpu" in stdout


def test_jax_is_blocked(built):
    _, env = built
    rc, _, stderr = _run([sys.executable, "-c", "import jax"], env)
    assert rc != 0 and "jax is blocked" in stderr


INIT_ERRORS = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
lib.tachyon_tpu_init.argtypes = [ctypes.c_char_p]
lib.tachyon_tpu_last_error.restype = ctypes.c_char_p
for platform in sys.argv[2:]:
    rc = lib.tachyon_tpu_init(None if platform == "NULL" else platform.encode())
    print(platform, rc, lib.tachyon_tpu_last_error().decode())
"""


def test_init_errors(built):
    """The card on a host without CUDA and an unknown platform are errors
    with a message; "cpu" then succeeds."""
    out, env = built
    env = dict(env, CUDA_VISIBLE_DEVICES="")
    rc, stdout, stderr = _run([sys.executable, "-c", INIT_ERRORS, str(out / "libtachyon_tpu_c.so"),
                               "cuda", "NULL", "tpu", "cpu"], env)
    assert rc == 0, stderr
    lines = dict(line.split(" ", 1) for line in stdout.strip().splitlines())
    for platform in ("cuda", "NULL"):
        code, msg = lines[platform].split(" ", 1)
        assert int(code) < 0 and "CUDA is not available" in msg, lines[platform]
    code, msg = lines["tpu"].split(" ", 1)
    assert int(code) < 0 and "unknown platform 'tpu'" in msg
    assert lines["cpu"].split(" ", 1)[0] == "0"


def test_calls_before_init_fail(built):
    out, env = built
    code = ("import ctypes, sys\n"
            "lib = ctypes.CDLL(sys.argv[1])\n"
            "lib.tachyon_tpu_last_error.restype = ctypes.c_char_p\n"
            "buf = (ctypes.c_uint8 * 64)()\n"
            "print(lib.tachyon_tpu_bn254_g1_msm(buf, buf, 1, buf),"
            " lib.tachyon_tpu_last_error().decode())\n")
    rc, stdout, stderr = _run([sys.executable, "-c", code, str(out / "libtachyon_tpu_c.so")], env)
    assert rc == 0, stderr
    assert stdout.strip() == "-1 tachyon_tpu_init was not called"
