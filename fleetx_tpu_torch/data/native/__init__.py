"""ctypes binding of the native index builder (port of
``fleetx_tpu/data/native/__init__.py``: ``build_sample_idx`` and
``build_blending_indices``).

``index_builder.cpp`` beside this file compiles on first use with ``g++
-O3 -std=c++17 -fPIC -shared`` into ``fleetx_tpu_torch/_build/`` (the
package directory itself is never written), under a name keyed by a hash
of the source and the flags. Several processes may race on a first use:
each compiles into a private temporary file and renames it into place,
so none loads a half-written library. A missing compiler or a failed
build raises; the datasets' callers log it and take the numpy builders,
whose outputs are byte-identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "index_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
#: the blending builder keeps one count per dataset on its stack
MAX_BLENDED = 256
#: a compile of this one small file takes about a second
BUILD_TIMEOUT_S = 120


def library_path() -> str:
    """Where the library goes, keyed by the source and the flags."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libindex_builder-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build "
                           f"{os.path.basename(SOURCE)}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"index builder build failed (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


class _IndexBuilder:
    """The library, built and loaded on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib = None
        #: the loaded library's path (None until the first call)
        self.path = None

    def _ensure(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
        # the compile runs outside the lock: a racing thread compiles into
        # its own temporary file and the rename makes the second a no-op
        path = build()
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(path)
                lib.build_sample_idx.argtypes = [
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]
                lib.build_sample_idx.restype = None
                lib.build_blending_indices.argtypes = [
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int64)]
                lib.build_blending_indices.restype = None
                self._lib, self.path = lib, path
            return self._lib

    @staticmethod
    def _ptr(arr: np.ndarray, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def build_sample_idx(self, sizes: np.ndarray, doc_idx: np.ndarray,
                         seq_length: int, num_samples: int) -> np.ndarray:
        """``[num_samples+1, 2]`` (doc_idx position, token offset), equal
        to the numpy ``gpt_dataset.build_sample_idx``."""
        lib = self._ensure()
        sizes = np.ascontiguousarray(sizes, np.int32)
        doc_idx = np.ascontiguousarray(doc_idx, np.int32)
        if doc_idx.size and (doc_idx.min() < 0
                             or doc_idx.max() >= len(sizes)):
            raise ValueError("doc_idx points outside sizes")
        total = int(sizes[doc_idx].astype(np.int64).sum())
        num_samples = min(int(num_samples), (total - 1) // int(seq_length))
        out = np.empty((num_samples + 1, 2), np.int64)
        lib.build_sample_idx(
            self._ptr(sizes, ctypes.c_int32),
            self._ptr(doc_idx, ctypes.c_int32), len(doc_idx),
            int(seq_length), num_samples, self._ptr(out, ctypes.c_int64))
        return out

    def build_blending_indices(self, weights: np.ndarray,
                               num_samples: int) -> tuple:
        """(dataset index ``[n]`` int32, sample index within it ``[n]``
        int64) for weighted corpus blending."""
        lib = self._ensure()
        weights = np.ascontiguousarray(weights, np.float64)
        if not 1 <= len(weights) <= MAX_BLENDED:
            raise ValueError(f"1 to {MAX_BLENDED} blended datasets, got "
                             f"{len(weights)}")
        ds_idx = np.empty(int(num_samples), np.int32)
        ds_sample_idx = np.empty(int(num_samples), np.int64)
        lib.build_blending_indices(
            self._ptr(weights, ctypes.c_double), len(weights),
            int(num_samples), self._ptr(ds_idx, ctypes.c_int32),
            self._ptr(ds_sample_idx, ctypes.c_int64))
        return ds_idx, ds_sample_idx


index_builder = _IndexBuilder()
