"""ctypes bindings for the native mmap zkey/wtns parser (io/native/zkparse.cc).

Port of ``tachyon_tpu/io/native.py``.  The library is built by ``g++`` at
first use into ``tachyon_tpu_torch/_build/`` (``ops/_build.host_build``,
about a second); a failed build raises with the compiler's output.  There is
no fallback: the pure-Python parse of ``io/zkey.py`` runs only when its
caller asks for it (``native=False``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from tachyon_tpu_torch.ops import _build

SRC = Path(__file__).resolve().parent / "native" / "zkparse.cc"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]


class _MappedFile(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("size", ctypes.c_uint64),
        ("fd", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path = _build.host_build(
        "zkparse", [SRC],
        lambda out: ["g++", *CXX_FLAGS, "-o", str(out / "libzkparse.so"), str(SRC)],
        "libzkparse.so")
    lib = ctypes.CDLL(str(path))
    mf = ctypes.POINTER(_MappedFile)
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    for name, args, res in (
        ("zk_mmap_open", [ctypes.c_char_p, mf], ctypes.c_int),
        ("zk_mmap_close", [mf], None),
        ("zk_find_section", [mf, u32, u32, ctypes.POINTER(u64)], u64),
        ("zk_gather_u32", [mf, u64, u64, u32, u32, u32p], ctypes.c_int),
        ("zk_gather_words", [mf, u64, u64, u32, u32, u32, u32p], ctypes.c_int),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


class NativeFile:
    """A file mapped read-only; every read is bounds-checked in C++."""

    def __init__(self, path: str):
        self._lib = library()
        self._f = _MappedFile()
        rc = self._lib.zk_mmap_open(str(path).encode(), ctypes.byref(self._f))
        if rc != 0:
            raise OSError(f"mmap failed ({rc}): {path}")

    def close(self):
        self._lib.zk_mmap_close(ctypes.byref(self._f))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def size(self) -> int:
        return self._f.size

    def find_section(self, typ: int, occurrence: int = 0):
        """(payload offset, size) of the section, or (None, 0) if absent."""
        size = ctypes.c_uint64()
        off = self._lib.zk_find_section(ctypes.byref(self._f), typ, occurrence,
                                        ctypes.byref(size))
        return (off, size.value) if off else (None, 0)

    def _check(self, rc: int, what: str, off: int):
        if rc != 0:
            raise ValueError(f"truncated file: {what} at {off} out of bounds")

    def gather_words(self, off: int, n: int, W: int, stride: int | None = None,
                     value_off: int = 0) -> np.ndarray:
        """n values of W 32-bit words (records ``stride`` bytes apart, the
        value at ``value_off``) -> (W, n) uint32 words."""
        out = np.empty((W, n), dtype=np.uint32)
        self._check(self._lib.zk_gather_words(ctypes.byref(self._f), off, n, W,
                                              stride or 4 * W, value_off, out),
                    "word gather", off)
        return out

    def gather_u32(self, off: int, n: int, stride: int, field_off: int) -> np.ndarray:
        out = np.empty((n,), dtype=np.uint32)
        self._check(self._lib.zk_gather_u32(ctypes.byref(self._f), off, n, stride,
                                            field_off, out),
                    "gather", off)
        return out

    def read_bytes(self, off: int, n: int) -> bytes:
        if off < 0 or n < 0 or off + n > self._f.size:
            raise ValueError(f"read_bytes [{off}, +{n}] exceeds file size {self._f.size}")
        return ctypes.string_at(self._f.data + off, n)
