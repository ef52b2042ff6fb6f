"""Device resolution, numerics switches, the stage timer and the progress
counter shared by the port's entry points."""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import defaultdict

import torch
import torch.distributed as dist

__all__ = ["resolve_device", "local_rank", "fp32_strict", "to_host_async", "StageTimer", "Progress"]


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` where a launcher
    sets it (torchrun), else the rank of the ``torch.distributed`` world
    modulo the host's card count (0 outside a world)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    n = torch.cuda.device_count()
    return dist.get_rank() % n if n else 0


def resolve_device(device=None) -> torch.device:
    """Entry-point device rule: ``None`` means ``"cuda"``, and in a world of
    processes (``parallel.multihost``) ``cuda:<local_rank>``, this rank's
    card; a device the caller names wins.

    A CUDA request without a usable GPU raises instead of carrying on
    silently on the CPU; the CPU is used only when the caller asks for it.
    """
    if device is None:
        in_world = dist.is_available() and dist.is_initialized()
        device = f"cuda:{local_rank()}" if in_world else "cuda"
    dev = torch.device(device)
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


def to_host_async(t: torch.Tensor):
    """Start the device-to-host copy of ``t``: (host tensor, CUDA event
    recorded after the copy, or None for a tensor already on the CPU).  The
    host bytes may be read only after the event has completed, so a copy
    started before the next dispatch overlaps it."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


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

    def add(self, name: str, seconds: float, count: int = 1):
        """Record time measured elsewhere (e.g. a worker's busy time, or
        ``count`` stages of another timer)."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += count

    def report(self) -> dict:
        with self._lock:
            return {name: {"total_s": self.totals[name], "count": self.counts[name],
                           "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name])}
                    for name in self.totals}


class Progress:
    """Throttled counter on stderr (counterpart of the JAX package's
    ``utils.progress.Progress``): ``desc: 128/4096 (3.1%) 42.5/s ETA 1:33``.
    With ``enabled`` False every method does nothing, so an engine can
    hold one unconditionally.  Counts set before the first ``update`` (the
    slices a resumed sweep already has) do not enter the rate."""

    def __init__(self, total=None, desc: str = "", enabled: bool = True,
                 min_interval: float = 0.5):
        self.total = total
        self.desc = desc
        self.enabled = enabled
        self.min_interval = min_interval
        self.n = 0
        self._t0 = time.perf_counter()
        self._last = 0.0
        self._wrote = False
        self._initial = None

    def update(self, n: int = 1):
        if self._initial is None:
            self._initial = self.n
        self.n += n
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last < self.min_interval and self.n != self.total:
            return
        self._last = now
        self._render(now)

    def _render(self, now: float):
        rate = (self.n - (self._initial or 0)) / max(now - self._t0, 1e-9)
        if self.total:
            eta = int((self.total - self.n) / rate) if rate > 0 else 0
            msg = (f"{self.desc}: {self.n}/{self.total} ({100.0 * self.n / self.total:.1f}%) "
                   f"{rate:.1f}/s ETA {eta // 60}:{eta % 60:02d}")
        else:
            msg = f"{self.desc}: {self.n} ({rate:.1f}/s)"
        sys.stderr.write("\r" + msg + " " * 8)
        sys.stderr.flush()
        self._wrote = True

    def close(self):
        if self.enabled and self._wrote:
            self._render(time.perf_counter())
            sys.stderr.write("\n")
            sys.stderr.flush()
