"""Progress lines for long sweeps (counterpart of
``empanada_tpu/utils/progress.py``): rate and ETA, throttled, to stderr
unless another stream is given."""

from __future__ import annotations

import sys
import time

__all__ = ["Progress"]


class Progress:
    """Throttled counter: ``desc: 128/4096 (3.1%) 42.5/s ETA 1:33``.

    ``total``: expected updates (None for an open count); ``enabled``
    False makes every method do nothing, so an engine can hold one
    unconditionally; ``min_interval``: seconds between lines; ``stream``:
    default stderr (stdout stays machine-readable).  Counts set before the
    first ``update`` (the slices a resumed sweep already has) do not enter
    the rate."""

    def __init__(self, total=None, desc: str = "", enabled: bool = True,
                 min_interval: float = 0.5, stream=None):
        self.total = total
        self.desc = desc
        self.enabled = enabled
        self.min_interval = min_interval
        self.stream = stream if stream is not None else sys.stderr
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
            eta = (self.total - self.n) / rate if rate > 0 else 0
            msg = (f"{self.desc}: {self.n}/{self.total} ({100.0 * self.n / self.total:.1f}%) "
                   f"{rate:.1f}/s ETA {self._fmt(eta)}")
        else:
            msg = f"{self.desc}: {self.n} ({rate:.1f}/s)"
        self.stream.write("\r" + msg + " " * 8)
        self.stream.flush()
        self._wrote = True

    def close(self):
        if self.enabled and self._wrote:
            self._render(time.perf_counter())
            self.stream.write("\n")
            self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def _fmt(seconds: float) -> str:
        seconds = int(seconds)
        if seconds >= 3600:
            return f"{seconds // 3600}:{(seconds % 3600) // 60:02d}:{seconds % 60:02d}"
        return f"{seconds // 60}:{seconds % 60:02d}"
