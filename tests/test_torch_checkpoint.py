"""Checkpoint/resume of the port's 3D sweeps (``stitch/checkpoint.py`` and
``MultiChipEngine3d``'s ``checkpoint_dir`` / ``resume``), on the CPU.

A sweep crashed mid-batch (a ``MatcherWorker`` that raises after n slices,
as ``tests/test_checkpoint_resume.py`` crashes the JAX engine) and resumed
must be bit-identical to an uninterrupted one; ``infer_orthoplane`` skips
the axes it finished; a checkpoint of another volume or configuration
raises; and a directory written by either package resumes in the other to
the uninterrupted result (the JAX engine on a one-device mesh, streamed
path, whose result the port's equals)."""

import os
import time

import numpy as np
import pytest

import empanada_tpu.parallel.data_parallel as jax_dp
from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from empanada_tpu.core.labeling import FlatInstances as JaxFlat
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu.stitch import checkpoint as jax_ckpt
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.parallel import data_parallel as dp
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from empanada_tpu_torch.stitch import checkpoint as ckpt
from test_torch_ortho import CFG, ENGINE_KW, _volume, assert_same_trackers

KW = dict(ENGINE_KW, batch_size=4)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def volume():
    return _volume((10, 64, 80), seed=70)


def _port(models, **kw):
    return MultiChipEngine3d(CFG, models[2], device="cpu", **{**KW, **kw})


def _jax(models, **kw):
    model, variables, _ = models
    return JaxEngine3d(CFG, model_and_variables=(model, variables), sweep_fused=False,
                       mesh=create_mesh(1), **{**KW, **kw})


def _crashing(worker_cls, n):
    """``worker_cls`` whose ``put`` raises once ``n`` slices went through
    (counted over every worker made from it).  Each put waits for the
    matcher thread to take its slice, so the slices saved before the crash,
    and so the resume point, do not depend on the thread's timing."""
    count = [0]

    class CrashWorker(worker_cls):
        def put(self, item):
            if count[0] >= n:
                raise RuntimeError("simulated crash")
            count[0] += 1
            self.n_put = getattr(self, "n_put", 0) + 1
            super().put(item)
            deadline = time.monotonic() + 60
            while len(self.rle_stack) < self.n_put and time.monotonic() < deadline:
                time.sleep(0.001)

    return CrashWorker


def _segments(cdir, axis):
    return sorted(f for f in os.listdir(cdir) if f.startswith(f"forward_{axis}."))


def _saved_slices(cdir, axis):
    return ckpt.ForwardCheckpoint(cdir, axis, {}).load() if _segments(cdir, axis) else []


def _crash(monkeypatch, module, run, n):
    monkeypatch.setattr(module, "MatcherWorker", _crashing(module.MatcherWorker, n))
    with pytest.raises(RuntimeError, match="simulated crash"):
        run()
    monkeypatch.undo()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert_same_trackers(got[1], want[1])


def _random_stack(rng, n_slices, labels=(1, 2)):
    stack = []
    for _ in range(n_slices):
        seg = {}
        for c in labels:
            k = int(rng.integers(0, 4))
            lens = rng.integers(1, 4, k)
            offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
            starts = np.sort(rng.choice(1000, int(offsets[-1]), replace=False)).astype(np.int64)
            boxes = rng.integers(0, 50, (k, 4)).astype(np.int64)
            seg[c] = FlatInstances(c * 1000 + 1 + rng.permutation(20)[:k].astype(np.int64),
                                   boxes, offsets, starts,
                                   rng.integers(1, 5, int(offsets[-1])).astype(np.int64))
        stack.append(seg)
    return stack


def _same_flat(a, b):
    for f in ("labels", "boxes", "offsets", "starts", "runs"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.int64 and np.array_equal(x, y), f


def test_forward_state_round_trip(tmp_path):
    """The columnar file of either package loads in the other; segments
    append, load contiguous, refuse a gap and are removed."""
    stack = _random_stack(np.random.default_rng(0), 5)
    stack[2][1] = FlatInstances.empty()
    meta = {"axis_name": "xy", "n": 5}
    path = str(tmp_path / "state.npz")
    ckpt.save_forward_state(path, stack, meta)
    got, got_meta = ckpt.load_forward_state(path)
    jax_got, jax_meta = jax_ckpt.load_forward_state(path)
    assert got_meta == jax_meta == meta
    for g, j, want in zip(got, jax_got, stack):
        assert list(g) == list(j) == [1, 2]
        for c in want:
            _same_flat(g[c], want[c])
            _same_flat(JaxFlat.from_dict(j[c]), want[c])
    # the JAX package's file (its dict form) loads in the port; the dict
    # form saves too
    as_dicts = [{c: f.to_dict() for c, f in seg.items()} for seg in stack]
    jax_ckpt.save_forward_state(path, as_dicts, meta)
    ckpt.save_forward_state(str(tmp_path / "dicts.npz"), as_dicts, meta)
    for p in (path, str(tmp_path / "dicts.npz")):
        for g, want in zip(ckpt.load_forward_state(p)[0], stack):
            for c in want:
                _same_flat(g[c], want[c])

    fc = ckpt.ForwardCheckpoint(str(tmp_path), "xz", meta)
    fc.append(stack[:2])
    fc.append(stack[2:])
    loaded = ckpt.ForwardCheckpoint(str(tmp_path), "xz", meta).load()
    assert len(loaded) == 5
    _same_flat(loaded[3][2], stack[3][2])
    os.replace(tmp_path / "forward_xz.00001.npz", tmp_path / "forward_xz.00000.npz")
    with pytest.raises(ValueError, match="mixed runs"):
        ckpt.ForwardCheckpoint(str(tmp_path), "xz", meta).load()
    fc.remove()
    assert not _segments(str(tmp_path), "xz")


@pytest.mark.parametrize("axis,resident", [("xy", "auto"), ("yz", "auto"), ("yz", False)],
                         ids=["xy", "yz", "yz-host"])
def test_crash_resume_bit_identical(models, volume, monkeypatch, tmp_path, axis, resident):
    """Crashed after 6 slices (saved every 2; mid-batch at B = 4), the
    resumed sweep restarts at the batch boundary with its median context,
    drops the slices it has, and equals an uninterrupted sweep; the axis's
    forward state is removed at its end."""
    cdir = str(tmp_path / "ckpt")
    want = _port(models).infer_on_axis(volume, axis)
    _crash(monkeypatch, dp, lambda: _port(models, volume_resident=resident).infer_on_axis(
        volume, axis, checkpoint_dir=cdir, checkpoint_every=2), n=6)
    assert len(_saved_slices(cdir, axis)) == 6  # resumes at slice 4, drops 2
    eng = _port(models, volume_resident=resident)
    got = eng.infer_on_axis(volume, axis, checkpoint_dir=cdir, resume=True)
    assert not eng.last_fused
    _assert_same(got, want)
    assert not _segments(cdir, axis)


def test_orthoplane_resume_skips_finished_axes(models, monkeypatch, tmp_path):
    """Crashed in the yz sweep, after xy and xz saved their trackers: the
    resume loads xy and xz, sweeps only yz (from its forward state) and
    equals the uninterrupted pipelined run."""
    vol = _volume((8, 64, 80), seed=80)
    cdir = str(tmp_path / "ckpt")
    want = _port(models, batch_size=24).infer_orthoplane(vol)
    _crash(monkeypatch, dp, lambda: _port(models, batch_size=24).infer_orthoplane(
        vol, checkpoint_dir=cdir, checkpoint_every=4), n=8 + 64 + 30)
    assert sorted(f for f in os.listdir(cdir) if f.endswith(".meta.json")) == [
        "trackers_xy.meta.json", "trackers_xz.meta.json"]
    assert len(_saved_slices(cdir, "yz")) == 28  # resumes at plane 24, drops 4

    eng = _port(models, batch_size=24)
    swept = []
    streamed = eng._infer_streamed
    monkeypatch.setattr(eng, "_infer_streamed",
                        lambda v, axis, *a: swept.append(axis) or streamed(v, axis, *a))
    got = eng.infer_orthoplane(vol, checkpoint_dir=cdir, resume=True)
    assert swept == ["yz"]
    assert [eng.last_axis_stats[a]["path"] for a in got] == ["checkpoint", "checkpoint",
                                                            "streamed"]
    for axis in want:
        assert_same_trackers(got[axis], want[axis])
    assert not _segments(cdir, "yz")
    # every axis finished: a second resume sweeps nothing
    swept.clear()
    again = eng.infer_orthoplane(vol, checkpoint_dir=cdir, resume=True)
    assert swept == [] and all(len(again[a][0].instances) == len(want[a][0].instances)
                               for a in want)


def test_stale_checkpoint_raises(models, volume, monkeypatch, tmp_path):
    """A forward state or finished trackers of another volume, or of
    another batch, are refused."""
    other = _volume(volume.shape, seed=71)
    cdir = str(tmp_path / "ckpt")
    _crash(monkeypatch, dp, lambda: _port(models).infer_on_axis(
        volume, "xy", checkpoint_dir=cdir, checkpoint_every=2), n=6)
    for eng, vol in ((_port(models), other), (_port(models, batch_size=2), volume)):
        with pytest.raises(ValueError, match="different run configuration"):
            eng.infer_on_axis(vol, "xy", checkpoint_dir=cdir, resume=True)
    odir = str(tmp_path / "ortho")
    small = _volume((6, 48, 48), seed=1)
    _port(models).infer_orthoplane(small, checkpoint_dir=odir)
    with pytest.raises(ValueError, match="different run configuration"):
        _port(models).infer_orthoplane(_volume((6, 48, 48), seed=2), checkpoint_dir=odir,
                                       resume=True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(models, volume, monkeypatch, tmp_path, writer):
    """A checkpoint directory that one package wrote before a crash resumes
    in the other to the uninterrupted result (the JAX streamed sweep)."""
    cdir = str(tmp_path / "ckpt")
    want = _jax(models).infer_on_axis(volume, "xy")
    if writer == "jax":
        _crash(monkeypatch, jax_dp, lambda: _jax(models).infer_on_axis(
            volume, "xy", checkpoint_dir=cdir, checkpoint_every=2), n=6)
        assert len(_saved_slices(cdir, "xy")) == 6
        got = _port(models).infer_on_axis(volume, "xy", checkpoint_dir=cdir, resume=True)
    else:
        _crash(monkeypatch, dp, lambda: _port(models).infer_on_axis(
            volume, "xy", checkpoint_dir=cdir, checkpoint_every=2), n=6)
        assert len(_saved_slices(cdir, "xy")) == 6
        got = _jax(models).infer_on_axis(volume, "xy", checkpoint_dir=cdir, resume=True)
    _assert_same(got, want)
    assert not _segments(cdir, "xy")
