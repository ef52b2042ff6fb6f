"""Tracing, stage timing and device timing (counterpart of
``empanada_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` scope (the CPU, and the card
  when there is one) that writes a Chrome trace, ``<logdir>/trace.json``;
- ``StageTimer``: host wall-clock per named stage, safe to feed from
  several threads; ``sync_on`` or ``sync=True`` make a stage wait for the
  card's work before it stops, so queued work is charged to its stage;
- ``device_time``: seconds per call of a function, from a chain of
  ``2 * iters`` calls differenced against a chain of ``iters``, each chain
  read back once, so the constant of one launch and one read cancels.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import threading
import time
from collections import defaultdict

import torch

__all__ = ["trace", "StageTimer", "device_time"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA's
    when a card is present); yields the profiler (``key_averages()``) and
    writes the Chrome trace ``<logdir>/trace.json`` at exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _wait_for(tree):
    """Wait until the work that produces the CUDA tensors of ``tree`` (a
    tensor, or lists, tuples and dicts of them) is done: each device's
    current stream is synchronized once."""
    for dev in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


class StageTimer:
    """Host wall-clock per named stage:

        with timer.stage("forward", sync_on=out):
            out.append(model(x))   # queued work; sync_on waits for it
        timer.report()  # {name: {"total_s", "count", "mean_ms"}}

    ``sync=True`` synchronizes the card at the exit of every stage (all
    streams), so queued work cannot leak its cost into a later stage even
    where the caller passes no ``sync_on``."""

    def __init__(self, sync: bool = False):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _wait_for(sync_on)
            elif self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
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

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()


def _perturb(args, k):
    """Default perturbation: add ``1e-4 * k`` to the last tensor argument,
    so that no two calls of a chain see the same input."""
    return args[:-1] + (args[-1] + 1e-4 * k,)


def device_time(fn, *args, iters: int = 10, trials: int = 3, perturb=None,
                stats: bool = False):
    """Best sustained seconds per call of ``fn(*args)`` on the device its
    tensors live on.

    A chain of n calls (the inputs perturbed per call by ``perturb(args,
    k)``, default ``_perturb``) sums every output into one float32 scalar
    and reads it back once; the time of a ``2 * iters`` chain minus that of
    an ``iters`` chain, over ``iters``, cancels the launch and read-back
    constant.  Each chain length runs once first as a warm-up.  Autograd
    stays as the caller set it (time an inference under ``no_grad``).  A trial
    whose difference is not positive carries no information and is
    dropped; if all are, the short chain's rate (constant included) is
    returned.  With ``stats`` a dict: ``{"s": min, "median_s", "max_s",
    "valid_trials", "jitter": (max - min) / median}``; the minimum is the
    headline, since noise only adds time.
    """
    perturb = perturb or _perturb

    def chain(n):
        acc = None
        for k in range(n):
            outs = fn(*perturb(args, k))
            total = sum(o.float().sum() for o in _leaves(outs))
            acc = total if acc is None else acc + total
        return float(acc)

    chain(iters)
    chain(2 * iters)
    diffs, fallback = [], float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        chain(iters)
        t1 = time.perf_counter()
        chain(2 * iters)
        t2 = time.perf_counter()
        diff = ((t2 - t1) - (t1 - t0)) / iters
        if diff > 0:
            diffs.append(diff)
        fallback = min(fallback, (t1 - t0) / iters)
    best = min(diffs) if diffs else max(fallback, 1e-9)
    if not stats:
        return best
    med = statistics.median(diffs) if diffs else best
    worst = max(diffs) if diffs else best
    return {"s": best, "median_s": med, "max_s": worst, "valid_trials": len(diffs),
            "jitter": (worst - best) / med if med > 0 else 0.0}
