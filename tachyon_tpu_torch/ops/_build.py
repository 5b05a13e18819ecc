"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C interface
(no PyTorch headers, so no PyTorch extension build):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -split-compile 0 \
         -c -o <src>.o csrc/<src>.cu                      # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libtachyon_kernels.so *.o

The library lands in ``tachyon_tpu_torch/_build/<key>/``, where the key
hashes the sources and the flags, so a rerun on unchanged sources loads the
library it built before.  Only sources in this repository are compiled.
``host_build`` does the same for a host library built by ``g++`` (the mmap
parser of ``io/native.py``), into ``_build/<tag>-<key>/``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -split-compile 0: nvcc optimizes a source's kernels on every core at once
# (the build of all sources took 86.6 s against 165.2 s without it on the
# H100's host, PERF.md)
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile", "0"]

# (name, argtypes) of every extern "C" launcher; each returns cudaError_t
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
LAUNCHERS = {
    "tt_mont_mul": [_P, _P, _P, _I64, _P, ctypes.c_int, _P],
    "tt_mont_mul1": [_P, _P, _P, _I64, _I64, _I64, _P, _P],
    "tt_mont_mul2": [_P, _P, _P, _I64, _I64, _I64, _P, _P],
    "tt_add_xyzz": [_P] * 12 + [_I64, _P, ctypes.c_int, _P],
    "tt_dbl_xyzz": [_P] * 8 + [_I64, _P, ctypes.c_int, _P],
    "tt_madd_xyzz": [_P] * 11 + [_I64, _P, ctypes.c_int, _P],
    "tt_scalar_mul_xyzz": [_P] * 8 + [_I64, ctypes.c_int, _P, ctypes.c_int, _P],
    "tt_suffix_totals": [_P] * 8 + [_I64] * 4 + [_P, ctypes.c_int, _P],
    "tt_suffix_carries": [_P] * 6 + [_I64] * 2 + [_P, ctypes.c_int, _P],
    "tt_suffix_emit": [_P] * 12 + [_I64] * 4 + [_P, ctypes.c_int, _P],
    "tt_reduce_partials": [_P] * 9 + [_I64] * 4 + [_P, ctypes.c_int, _P],
    "tt_reduce_combine": [_P] * 6 + [_I64] * 2 + [ctypes.c_int, _P, ctypes.c_int, _P],
    "tt_lane_suffix_scan": [_P] * 13 + [_I64, _P, ctypes.c_int, _P],
    "tt_lane_fold": [_P] * 12 + [_I64, _I64, _P, ctypes.c_int, _P],
    "tt_bucket_add": [_P] * 13 + [_I64] * 4 + [_P, ctypes.c_int, _P],
    "tt_horner_xyzz": [_P] * 8 + [_I64, ctypes.c_int, _P, ctypes.c_int, _P],
}

# block sizes the wrappers read from the library (each returns an int)
THREAD_COUNTS = ("tt_suffix_sweep_threads", "tt_reduce_sweep_threads",
                 "tt_reduce_combine_threads")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (or reuse) and load the kernel library; raises with nvcc's
    output when the build fails."""
    out_dir = BUILD / build_key()
    lib_path = out_dir / "libtachyon_kernels.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{obj.name} ({proc.returncode})")
        tmp = out_dir / f"libtachyon_kernels.{tag}.so"
        if not failed:
            r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                *(str(obj) for obj, _ in jobs)],
                               capture_output=True, text=True)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed.append(f"link ({r.returncode})")
        (out_dir / "nvcc.log").write_text("".join(logs))
        for obj, _ in jobs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "".join(logs))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in THREAD_COUNTS:
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


def host_build(tag: str, sources: list[Path], command, product: str) -> Path:
    """Build a host artifact (the mmap parser's ``g++`` library) at first use.

    ``command(out_dir)`` is the argument list that writes ``product`` into
    ``out_dir``; it runs in a directory of its own, which is then renamed to
    ``_build/<tag>-<key>/``, the key hashing the sources and the command, so
    that processes that build at once do not see each other's half-written
    files.  Raises with the command's output when it fails."""
    h = hashlib.sha256(" ".join(command(Path("OUT"))).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD / f"{tag}-{h.hexdigest()[:16]}"
    if not (out_dir / product).exists():
        tmp = BUILD / f".{tag}.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        r = subprocess.run(command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0 or not (tmp / product).exists():
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"{tag} build failed ({r.returncode}): "
                               f"{' '.join(command(tmp))}\n{r.stdout}")
        try:
            os.rename(tmp, out_dir)
        except OSError:  # another process renamed its build there first
            shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / product


def nvcc_log() -> str:
    log = BUILD / build_key() / "nvcc.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def launcher(name: str):
    """The library's launcher ``name``, looked up once."""
    return getattr(library(), name)


def launch(name: str, *args) -> None:
    """Call one launcher on PyTorch's current stream of the current device;
    raise on a CUDA error.  The stream's handle comes from the getter that
    Triton's launcher uses, without building a ``torch.cuda.Stream``."""
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = launcher(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
