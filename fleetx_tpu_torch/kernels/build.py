"""Build the port's CUDA kernels from the sources in ``csrc/``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). Libraries land in ``fleetx_tpu_torch/_build/``
under a name keyed by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused. Nothing builds at
import: the first CUDA call of a kernel's wrapper builds it, and
``build()`` compiles several missing sources at once, one ``nvcc``
process each, all started together.

A build that fails raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: kernel name → source file under csrc/
SOURCES = {"paged_attention": "paged_attention.cu",
           "fused_norm": "fused_norm.cu",
           "flash_attention": "flash_attention.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: a build of one source takes seconds; a compiler that runs this long
#: is stuck, and the build fails instead of hanging its caller
BUILD_TIMEOUT_S = 600

#: nvcc's output (register and shared-memory use from ``-Xptxas -v``) of
#: each library built by this process
build_logs: dict = {}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels in "
                       f"{CSRC_DIR})")


def library_path(name: str) -> str:
    """Where kernel ``name``'s library goes, keyed by its source, every
    header beside it (``csrc/*.cuh``, which a source may include) and the
    flags: an edited header rebuilds every library."""
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read())
    for header in sorted(n for n in os.listdir(CSRC_DIR)
                         if n.endswith(".cuh")):
        digest.update(header.encode())
        with open(os.path.join(CSRC_DIR, header), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> dict:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all running together; returns name → path."""
    names = list(names) if names is not None else list(SOURCES)
    paths = {n: library_path(n) for n in names}
    missing = [n for n in names if not os.path.exists(paths[n])]
    if not missing:
        return paths
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in missing:
        tmp = f"{paths[n]}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use.

    The build runs outside the lock: two threads that race on a first use
    both compile into private temporary files and the atomic rename makes
    the second a no-op, instead of one stalling behind the other's
    compiler under a held lock.
    """
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def loaded() -> list:
    """Names of the kernel libraries this process has loaded."""
    with _lock:
        return sorted(_libs)
