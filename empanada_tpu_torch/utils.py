"""Device resolution, numerics switches and the stage timer shared by the
port's entry points."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

__all__ = ["resolve_device", "fp32_strict", "StageTimer"]


def resolve_device(device=None) -> torch.device:
    """Entry-point device rule: ``None`` means ``"cuda"``.

    A CUDA request without a usable GPU raises instead of carrying on
    silently on the CPU; the CPU is used only when the caller asks for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def fp32_strict() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions, so float32
    checks on the card run in full float32 (cuDNN defaults to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class StageTimer:
    """Host wall-clock per named stage (counterpart of the JAX package's
    ``utils.StageTimer``), safe to feed from several threads:

        with timer.stage("fetch"):
            ...
        timer.report()  # {name: {"total_s", "count", "mean_ms"}}
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        """Record time measured elsewhere (e.g. a worker's busy time)."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def report(self) -> dict:
        with self._lock:
            return {name: {"total_s": self.totals[name], "count": self.counts[name],
                           "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name])}
                    for name in self.totals}
