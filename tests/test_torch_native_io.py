"""The port's mmap zkey/wtns parser (``tachyon_tpu_torch/io/native.py`` with
``io/native/zkparse.cc``) against its pure-Python parse and the JAX
package's parse, on the circom fixture keys, on CPU.  The library is built
with ``g++`` into the package's build directory at first use."""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu.io import zkey as jzkey
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.io import native, zkey
from tachyon_tpu_torch.ops import _build

FIX = Path(__file__).resolve().parent / "fixtures"
CIRCUITS = ("mul", "chain", "bits")
CPU = torch.device("cpu")
ARRAYS = ("alpha_g1", "beta_g1", "beta_g2", "gamma_g2", "delta_g1", "delta_g2", "ic",
          "points_a1", "points_b1", "points_b2", "points_c1", "points_h1", "coeff_values")
SCALARS = ("n8q", "n8r", "q", "r", "num_vars", "num_public", "domain_size")
INDEX_ARRAYS = ("coeff_matrix", "coeff_constraint", "coeff_signal")


@pytest.mark.parametrize("name", CIRCUITS)
def test_zkey_native_equals_python(name):
    path = str(FIX / f"torch_circom_{name}.zkey")
    a = zkey.parse_zkey(path, CPU, native=True)
    b = zkey.parse_zkey(path, CPU, native=False)
    for k in SCALARS:
        assert getattr(a, k) == getattr(b, k), k
    for k in INDEX_ARRAYS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ARRAYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("name", ["mul", "chain"])
def test_zkey_native_equals_jax(name):
    path = str(FIX / f"torch_circom_{name}.zkey")
    a = zkey.parse_zkey(path, CPU, native=True)
    j = jzkey.parse_zkey(path)
    for k in SCALARS:
        assert getattr(a, k) == getattr(j, k), k
    for k in INDEX_ARRAYS:
        assert np.array_equal(getattr(a, k), getattr(j, k)), k
    for k in ARRAYS:
        assert np.array_equal(limbs.to_jax_limbs(getattr(a, k)), np.asarray(getattr(j, k))), k


@pytest.mark.parametrize("name", CIRCUITS)
def test_wtns_native_equals_python_and_jax(name):
    path = str(FIX / f"torch_circom_{name}.wtns")
    mod_n, w_n = zkey.parse_wtns(path, native=True)
    mod_p, w_p = zkey.parse_wtns(path, native=False)
    mod_j, l_j = jzkey.parse_wtns(path, native=False)
    assert mod_n == mod_p == mod_j
    assert torch.equal(w_n, w_p)
    assert np.array_equal(limbs.to_jax_limbs(w_n), l_j)


def test_native_file_reads():
    path = str(FIX / "torch_circom_mul.wtns")
    with native.NativeFile(path) as f:
        off, size = f.find_section(1)
        assert off and size > 0
        assert f.find_section(99) == (None, 0)
        n8 = int.from_bytes(f.read_bytes(off, 4), "little")
        num = int.from_bytes(f.read_bytes(off + 4 + n8, 4), "little")
        off2, _ = f.find_section(2)
        words = torch.from_numpy(f.gather_words(off2, num, n8 // 4).view(np.int32))
        assert torch.equal(words, zkey.parse_wtns(path, native=False)[1])
        with pytest.raises(ValueError):
            f.gather_words(off2, num + 10 ** 6, n8 // 4)
        with pytest.raises(ValueError):
            f.read_bytes(f.size - 2, 4)


def test_truncated_files_raise(tmp_path):
    data = (FIX / "torch_circom_mul.zkey").read_bytes()
    cut = tmp_path / "cut.zkey"
    cut.write_bytes(data[: len(data) - 100])
    with pytest.raises(ValueError):
        zkey.parse_zkey(str(cut), CPU, native=True)
    bad = tmp_path / "bad.wtns"
    bad.write_bytes(b"nope" + data[4:200])
    with pytest.raises(ValueError):
        zkey.parse_wtns(str(bad), native=True)


def test_failed_build_raises(monkeypatch):
    """No fallback to the Python parse: a compiler error raises."""
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-flag-x"])
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="zkparse build failed"):
            zkey.parse_wtns(str(FIX / "torch_circom_mul.wtns"), native=True)
    finally:
        native.library.cache_clear()
    assert not (_build.BUILD / f".zkparse.{os.getpid()}").exists()  # the failed build's directory
