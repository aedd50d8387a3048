"""ctypes binding of the native C3D library (counterpart of
``uuo_mocap_tpu/data/c3d_native.py``).

``csrc/c3d_native.cpp`` is compiled with the host C++ compiler (``$CXX``,
else ``g++``, the compiler nvcc drives) on first use into ``_build/``, keyed
by the source's content hash as the CUDA kernels are, and loaded with
``ctypes``.  Nothing is compiled when this module is imported.  A failed
build raises with the compiler's message: there is no silent fallback to
the pure-Python parser (``data/c3d.py``), which stays available by name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "c3d_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


class _Library:
    """The compiled parser, loaded once per process."""

    lib: Optional[ctypes.CDLL] = None
    path: Optional[str] = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX); the native C3D parser cannot be built")


def build() -> ctypes.CDLL:
    """Compile ``csrc/c3d_native.cpp`` if its library is not built yet, load
    it and declare the C signatures.  Returns the loaded library."""
    if _Library.lib is not None:
        return _Library.lib
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libuuo_c3d_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    p, s = ctypes.c_void_p, ctypes.c_char_p
    signatures = {
        "uuoc3d_read": ([s], p), "uuoc3d_error": ([p], s), "uuoc3d_frames": ([p], ctypes.c_int),
        "uuoc3d_markers": ([p], ctypes.c_int), "uuoc3d_rate": ([p], ctypes.c_float),
        "uuoc3d_units": ([p], s), "uuoc3d_points": ([p], ctypes.POINTER(ctypes.c_float)),
        "uuoc3d_num_labels": ([p], ctypes.c_int), "uuoc3d_label": ([p, ctypes.c_int], s),
        "uuoc3d_free": ([p], None), "uuoc3d_prefetcher_create": ([ctypes.c_int], p),
        "uuoc3d_prefetcher_enqueue": ([p, s], None), "uuoc3d_prefetcher_wait": ([p, s], p),
        "uuoc3d_prefetcher_destroy": ([p], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _Library.lib, _Library.path = lib, path
    return lib


def _handle_to_dict(lib: ctypes.CDLL, handle: int) -> Dict[str, Any]:
    """Copy a parsed file out of its native handle and free the handle;
    raises ``ValueError`` with the parser's message when it failed."""
    try:
        err = lib.uuoc3d_error(handle)
        if err:
            raise ValueError(f"c3d parse failed: {err.decode()}")
        F, M = lib.uuoc3d_frames(handle), lib.uuoc3d_markers(handle)
        points = np.ctypeslib.as_array(lib.uuoc3d_points(handle), shape=(F, M, 4)).copy()
        labels: List[str] = [lib.uuoc3d_label(handle, i).decode()
                             for i in range(lib.uuoc3d_num_labels(handle))]
        return {
            "points": points,
            "rate": float(lib.uuoc3d_rate(handle)),
            "units": lib.uuoc3d_units(handle).decode(),
            "labels": labels,
            "first_frame": 1,
            "num_points": M,
        }
    finally:
        lib.uuoc3d_free(handle)


def read_c3d_native(filename: str) -> Dict[str, Any]:
    """Parse ``filename`` with the native library (``read_c3d``'s dict)."""
    lib = build()
    return _handle_to_dict(lib, lib.uuoc3d_read(os.fsencode(filename)))


class SequencePrefetcher:
    """Thread-pool prefetch of c3d files: enqueue the upcoming sequences, then
    ``get`` each in turn; parsing overlaps the solve of the current one."""

    def __init__(self, n_threads: int = 4):
        self._lib = build()
        self._handle = self._lib.uuoc3d_prefetcher_create(n_threads)

    def enqueue(self, path: str) -> None:
        self._lib.uuoc3d_prefetcher_enqueue(self._handle, os.fsencode(path))

    def get(self, path: str) -> Dict[str, Any]:
        """The parsed file of an enqueued ``path`` (waits for it)."""
        return _handle_to_dict(self._lib,
                               self._lib.uuoc3d_prefetcher_wait(self._handle, os.fsencode(path)))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.uuoc3d_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "SequencePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
