"""ctypes bindings of the port's native prefetching batch loader
(``native/dataloader.cpp``).

The shared library is built with ``g++`` at first use into ``build/`` at
the repository root, beside the CUDA kernels' library, under a name that
carries a hash of the source and the flags: an edited source builds anew,
an unchanged one is reused, and nothing is ever written beside the source.
The build goes to a temporary name first and is renamed into place, so
processes that build at once do not read a half-written library. A failed
build raises: the caller must not hand over to another loader quietly,
since that would change the run's batches.

``NativeDataloader`` has the iterator contract of ``harness.data.
Dataloader`` and of the JAX package's ``NativeDataloader``: shuffling (epoch
e on ``std::mt19937_64(seed + e)``), bounded-queue prefetch, cycle mode and
``skip_batches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libnativeloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library, built with ``g++`` if it is not there yet; raises
    ``RuntimeError`` when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(
            f"the native loader did not build ({' '.join(cmd)}): {detail}"
        ) from e
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64,
        ]
        lib.dl_next.restype = ctypes.c_int64
        lib.dl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_void_p)]
        lib.dl_batches_per_epoch.restype = ctypes.c_int64
        lib.dl_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeDataloader:
    """The native loader over row-aligned host ``arrays`` (their leading
    dimension the rows): batches of ``batch_size`` rows, the last one
    shorter without ``drop_last``; ``cycle=True`` repeats forever;
    ``skip_batches`` fast-forwards the stream by whole batches (exact
    resume from a checkpoint)."""

    def __init__(self, arrays: Tuple[np.ndarray, ...], batch_size: int, *,
                 shuffle: bool = False, cycle: bool = False, seed: int = 0,
                 prefetch: int = 4, drop_last: bool = True,
                 skip_batches: int = 0):
        self._lib = _load()
        self.arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        self.batch_size = batch_size
        n = self.arrays[0].shape[0]
        self.n_batches = n // batch_size if drop_last else -(-n // batch_size)
        row_bytes = [a.nbytes // a.shape[0] for a in self.arrays]
        ptrs = (ctypes.c_void_p * len(self.arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays])
        rb = (ctypes.c_int64 * len(self.arrays))(*row_bytes)
        self._handle = self._lib.dl_create(
            len(self.arrays), ptrs, rb, n, batch_size, int(shuffle), seed,
            prefetch, int(drop_last), int(cycle), max(0, int(skip_batches)))

    def __len__(self):
        return self.n_batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while self._handle:
            out = tuple(np.empty((self.batch_size,) + a.shape[1:], a.dtype)
                        for a in self.arrays)
            ptrs = (ctypes.c_void_p * len(out))(
                *[o.ctypes.data_as(ctypes.c_void_p).value for o in out])
            rows = self._lib.dl_next(self._handle, ptrs)
            if rows < 0:
                return
            if rows < self.batch_size:
                out = tuple(o[:rows] for o in out)
            yield out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
