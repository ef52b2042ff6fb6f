"""The port's profiling utilities (``empanada_tpu_torch/utils``) against
the JAX package's contracts (``empanada_tpu/utils``), on the CPU:
``StageTimer`` (keys, ``add``, ``reset``, ``sync_on`` and ``sync``),
``device_time`` (chains, perturbation, the stats dict), ``trace`` (a
Chrome trace), ``Progress`` (JAX's lines, to any stream) and
``probe_device_count``, and the names the old ``utils`` module gave."""

import io
import json
import time

import pytest
import torch

import empanada_tpu.utils.progress as jax_progress
from empanada_tpu.utils import Progress as JaxProgress
from empanada_tpu.utils import StageTimer as JaxStageTimer
from empanada_tpu_torch import utils
from empanada_tpu_torch.utils import progress as port_progress
from empanada_tpu_torch.utils import Progress, StageTimer, device_time, probe_device_count, trace


def test_old_names_still_import():
    for name in ("resolve_device", "local_rank", "fp32_strict", "to_host_async",
                 "StageTimer", "Progress"):
        assert hasattr(utils, name), name


def test_stage_timer_report_add_reset():
    port, jax = StageTimer(sync=True), JaxStageTimer(sync=False)
    for timer in (port, jax):
        with timer.stage("a"):
            time.sleep(0.002)
        timer.add("b", 0.5)
    got, want = port.report(), jax.report()
    assert sorted(got) == sorted(want) == ["a", "b"]
    for name in got:
        assert sorted(got[name]) == sorted(want[name]) == ["count", "mean_ms", "total_s"]
    assert got["a"]["count"] == 1 and got["a"]["total_s"] >= 0.002
    assert got["b"] == {"total_s": 0.5, "count": 1, "mean_ms": 500.0}
    port.add("b", 1.0, count=3)
    assert port.report()["b"]["count"] == 4
    port.reset()
    assert port.report() == {}


def test_stage_timer_sync_on_waits_for_the_tensors(monkeypatch):
    waited = []
    monkeypatch.setattr("empanada_tpu_torch.utils.profiling._wait_for", waited.append)
    timer = StageTimer()
    out = {"x": [torch.ones(2)]}
    with timer.stage("fwd", sync_on=out):
        pass
    with timer.stage("post"):
        pass
    assert waited == [out] and timer.report()["fwd"]["count"] == 1


def test_device_time_contract():
    calls = []

    def fn(x):
        calls.append(float(x[0]))
        return {"y": x * 2, "z": [x.sum()]}

    x = torch.zeros(4)
    best = device_time(fn, x, iters=2, trials=3)
    assert isinstance(best, float) and best > 0
    # warm-ups of 2 and 4 calls, then 3 trials of 2 + 4, each chain
    # perturbed by 1e-4 * k
    assert len(calls) == 6 + 3 * 6
    assert calls[:6] == pytest.approx([0, 1e-4, 0, 1e-4, 2e-4, 3e-4])
    st = device_time(fn, x, iters=2, trials=2, stats=True,
                     perturb=lambda a, k: (a[0] + k,))
    assert sorted(st) == ["jitter", "max_s", "median_s", "s", "valid_trials"]
    assert st["s"] <= st["median_s"] <= st["max_s"] and st["valid_trials"] <= 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    events = json.load(open(tmp_path / "t" / "trace.json"))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


class _Clock:
    """A shared fake ``time.perf_counter`` for both packages' modules."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("total,initial", [(10, 0), (None, 0), (5000, 3)])
def test_progress_prints_jax_lines(monkeypatch, total, initial):
    clock = _Clock()
    monkeypatch.setattr(port_progress.time, "perf_counter", clock)
    monkeypatch.setattr(jax_progress.time, "perf_counter", clock)
    streams = {}
    for name, cls in (("port", Progress), ("jax", JaxProgress)):
        clock.t = 100.0
        stream = io.StringIO()
        bar = cls(total=total, desc="xy", stream=stream, min_interval=0.5)
        bar.n = initial
        for _ in range(4):
            clock.t += 0.75
            bar.update(2)
        with bar:
            pass
        streams[name] = stream.getvalue()
    assert streams["port"] == streams["jax"] and streams["port"].endswith("\n")
    assert "xy: " in streams["port"]


def test_progress_disabled_prints_nothing():
    stream = io.StringIO()
    bar = Progress(total=3, enabled=False, stream=stream)
    bar.update(3)
    bar.close()
    assert stream.getvalue() == "" and bar.n == 3


def test_probe_device_count():
    n = probe_device_count(timeout=120)
    assert n == torch.cuda.device_count()
