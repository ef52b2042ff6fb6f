"""Build-at-first-use for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  ``load(name)`` compiles it
with ``nvcc`` for ``sm_90a`` into ``empanada_tpu_torch/build/`` (named by a
hash of the source and of the ``csrc/`` headers it includes, so an edited
source or header rebuilds) and loads it with ``ctypes``.  A failed build
raises.  ``load_all(names)`` starts one ``nvcc`` per missing source, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["load", "load_all", "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
_info: dict = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def source_digest(src: str) -> str:
    """Hash of a source and, transitively, of the local headers it
    includes (``#include "..."`` resolved beside the including file, as
    nvcc resolves them)."""
    h = hashlib.sha256()
    todo, seen = [src], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b"\0" + text)
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return h.hexdigest()[:12]


def load(name: str) -> ctypes.CDLL:
    """Compile (once per source version) and load ``csrc/<name>.cu``."""
    return load_all([name])[0]


def load_all(names) -> list:
    """Compile the sources of ``names`` that are not built yet, one
    ``nvcc`` process each, all started together, and load every one: their
    libraries, in the order of ``names``."""
    with _lock:
        started = {}
        for name in names:
            if name in _libs or name in started:
                continue
            src = os.path.join(CSRC, f"{name}.cu")
            os.makedirs(BUILD, exist_ok=True)
            so = os.path.join(BUILD, f"lib{name}-{source_digest(src)}.so")
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = None
            if not os.path.isfile(so):
                proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
            started[name] = (src, so, tmp, proc, time.perf_counter())
        try:
            for name, (src, so, tmp, proc, t0) in started.items():
                log = ""
                if proc is not None:
                    log = proc.communicate()[0]
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
                    os.replace(tmp, so)
                _libs[name] = ctypes.CDLL(so)
                _info[name] = {"seconds": time.perf_counter() - t0, "path": so, "log": log}
        finally:  # after a failure, stop the compilers still running
            for *_, proc, _ in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return [_libs[name] for name in names]


def build_info(name: str) -> dict:
    """Build seconds, library path and compiler log of a loaded kernel."""
    return dict(_info[name])
