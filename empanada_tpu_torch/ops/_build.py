"""Build-at-first-use for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  ``load(name)`` compiles it
with ``nvcc`` for ``sm_90a`` into ``empanada_tpu_torch/build/`` (named by a
hash of the source, so an edited source rebuilds) and loads it with
``ctypes``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["load", "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """Compile (once per source version) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        os.makedirs(BUILD, exist_ok=True)
        so = os.path.join(BUILD, f"lib{name}-{digest}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.isfile(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _info[name] = {"seconds": time.perf_counter() - t0, "path": so, "log": log}
        _libs[name] = lib
        return lib


def build_info(name: str) -> dict:
    """Build seconds, library path and compiler log of a loaded kernel."""
    return dict(_info[name])
