"""The port's host stitching copies (``empanada_tpu_torch.core`` /
``.stitch``) against the JAX package's (``empanada_tpu.core`` / ``.stitch``)
on the same seeded panoptic stacks: per-slice flat segs, forward-matched
segs, backward-matched trackers and the filled volume must be identical,
with the port's native library and with its numpy path.  A C3 regression
case holds the native matcher core to its contract on arrays that need a
dtype or layout conversion."""

import gc

import numpy as np
import pytest
import torch

from empanada_tpu.ops.postprocess import encode_runs_packed as jax_encode
from empanada_tpu.stitch import filters as jfilters
from empanada_tpu.stitch import patterns as jpat
from empanada_tpu.stitch.tracker import InstanceTracker as JaxTracker
from empanada_tpu.stitch.tracker import to_box3d as jax_to_box3d
from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.ops.postprocess import encode_runs_packed
from empanada_tpu_torch.stitch import filters, patterns
from empanada_tpu_torch.stitch.tracker import InstanceTracker, to_box3d

LABELS, DIV, THINGS = [1, 2], 1000, [1]


def _stack(seed, z=8, h=48, w=56, n=14):
    """Drifting discs of class 1 (some touching, some split into two parts
    so connected components relabel them), class-2 stuff and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0, h, n), rng.uniform(0, w, n)
    r = rng.uniform(3, 8, n)
    vy, vx = rng.normal(0, 1.5, n), rng.normal(0, 1.5, n)
    pan = np.zeros((z, h, w), np.int32)
    for s in range(z):
        pan[s, rng.random((h, w)) < 0.02] = 2 * DIV
        for i in range(n):
            disc = (yy - cy[i] - s * vy[i]) ** 2 + (xx - cx[i] - s * vx[i]) ** 2 < r[i] ** 2
            pan[s][disc] = DIV + 1 + (i + s // 3) % 40
        pan[s, :, w // 2] = np.where(rng.random(h) < 0.5, 0, pan[s, :, w // 2])
    return pan


def _same_flat(got, want):
    for name in ("labels", "boxes", "offsets", "starts", "runs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def _same_instances(got, want):
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k]["box"]) == tuple(want[k]["box"])
        np.testing.assert_array_equal(got[k]["starts"], want[k]["starts"])
        np.testing.assert_array_equal(got[k]["runs"], want[k]["runs"])


def _sweep(pat, flt, tracker_cls, items, shape, workers=None):
    """Forward matching through a MatcherWorker, backward matching,
    tracking, filters and the volume fill: returns (forward-matched segs
    as FlatInstances copies, trackers, filled volume)."""
    matchers = pat.create_matchers(THINGS, DIV, 0.25, 0.25)
    worker = pat.MatcherWorker(matchers, LABELS, DIV, THINGS, build_workers=workers)
    for item in items:
        worker.put(item)
    stack = worker.finish()
    forward = [{c: FlatInstances(f.labels.copy(), f.boxes.copy(), f.offsets.copy(),
                                 f.starts.copy(), f.runs.copy()) for c, f in seg.items()}
               for seg in stack]
    trackers = [tracker_cls(label, DIV, shape, "xy") for label in LABELS]
    for index, seg in pat.backward_matching(stack, matchers, shape[0]):
        pat.update_trackers(seg, index, trackers)
    pat.finish_tracking(trackers)
    for t in trackers:
        flt.remove_small_objects(t, min_size=20)
        flt.remove_pancakes(t, min_span=2)
    vol = np.zeros(shape, np.int32)
    pat.fill_panoptic_volume(vol, trackers)
    return forward, trackers, vol


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_stitch_matches_jax(monkeypatch, packed, use_native):
    monkeypatch.setattr(native, "use_native", use_native)
    pan = _stack(seed=int(packed) + 2 * int(use_native))
    shape = pan.shape
    w = shape[-1]
    if packed:
        rows = encode_runs_packed(torch.from_numpy(pan), 16).numpy()
        assert rows.tobytes() == np.asarray(jax_encode(pan, 16)).tobytes()
        assert rows[..., -1].max() <= 16  # no overflow: every slice goes packed
        items = [("packed", rows[s], w) for s in range(len(pan))]
    else:
        items = [pan[s].astype(np.int64) for s in range(len(pan))]

    # per-slice flat segs
    for item in items:
        want = jpat.build_flat_seg(item, LABELS, DIV, THINGS)
        got = patterns.build_flat_seg(item, LABELS, DIV, THINGS)
        assert list(got) == list(want)
        for c in LABELS:
            _same_flat(got[c], want[c])

    fw_want, tr_want, vol_want = _sweep(jpat, jfilters, JaxTracker, items, shape, 0)
    fw_got, tr_got, vol_got = _sweep(patterns, filters, InstanceTracker, items, shape, 2)
    for got, want in zip(fw_got, fw_want):
        for c in LABELS:
            _same_flat(got[c], want[c])
    for got, want in zip(tr_got, tr_want):
        _same_instances(got.instances, want.instances)
    np.testing.assert_array_equal(vol_got, vol_want)
    assert len(tr_got[0].instances) >= 5  # something was tracked through z


def test_match_flat_core_c3_regression():
    """C3: the JAX binding passes pointers of inline temporaries (arrays
    converted to int64 inside the call expression) to C.  The port keeps
    every converted array as a named local, so inputs that need a
    conversion (int32 fields, strided views) give exactly the result of
    clean int64 inputs, call after call, with allocations in between."""
    pan = _stack(seed=5, z=2)
    segs = [patterns.build_flat_seg(pan[s].astype(np.int64), LABELS, DIV, THINGS)[1]
            for s in range(2)]

    def messy(f):
        strided = np.empty((len(f.starts), 2), np.int64)
        strided[:, 0] = f.starts
        assert not strided[:, 0].flags.c_contiguous
        return FlatInstances(f.labels, f.boxes.astype(np.int32), f.offsets.astype(np.int32),
                             strided[:, 0], f.runs.astype(np.int32))

    want = native.match_flat_core(segs[0], segs[1], 0.25)
    assert (want[0] >= 0).sum() >= 3  # real matches
    for _ in range(20):
        got = native.match_flat_core(messy(segs[0]), messy(segs[1]), 0.25)
        [np.ones(1 << 16) for _ in range(8)]  # churn the allocator
        gc.collect()
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g, e)


def test_tracker_axes():
    """The tracker takes the three sweep axes (the yz finish is held to the
    JAX tracker in test_torch_ortho.py) and refuses another name; the 3D
    boxes of a slice's 2D box are the JAX tracker's."""
    with pytest.raises(ValueError, match="'zx'"):
        InstanceTracker(1, DIV, (4, 8, 8), "zx")
    for axis in ("xy", "xz", "yz"):
        assert InstanceTracker(1, DIV, (4, 8, 8), axis).axis == axis
        assert to_box3d(3, (1, 2, 5, 6), axis) == jax_to_box3d(3, (1, 2, 5, 6), axis)
