"""The port's resident volume, whole-sweep fused path and pipelined
``infer_orthoplane`` against the JAX package's, in float32 on the CPU (the
JAX engine on a one-device mesh).

- On thing-only configs the port's fused sweeps equal the JAX fused path
  (``sweep_fused=True, volume_resident=True``), and on every config the
  port's fused, resident-streamed and host-streamed sweeps equal the JAX
  streamed path: trackers (ids, boxes, starts, runs), filled volumes and
  dropped centres.
- Fault C1 of the JAX fused path (``native.match_sweep`` matches every
  label, so a class outside ``thing_list`` gets fresh ids across slices):
  a volume whose semantic regions vanish on every other slice shows the
  JAX fused trackers differing from the JAX streamed ones, and the port's
  equal to the streamed ones.
- ``_sweep_eligible`` gives the JAX engine's answers of its pipelined
  mode (the port fuses a sweep of few batches too); the port's
  ``native.match_sweep`` gives JAX's on random packed rows, "fallback"
  included; a sweep whose rows overflow their run capacity takes the
  per-slice path and still gives the streamed result.
"""

import numpy as np
import pytest

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from empanada_tpu.core import native as jax_native
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu_torch.core import native
from empanada_tpu_torch.parallel import data_parallel as dp
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from empanada_tpu_torch.utils import StageTimer
from test_torch_ortho import CFG, ENGINE_KW, OPTIONS, SHAPE, _volume, assert_same_trackers

AXES = ("xy", "xz", "yz")
# background and two classes: a thing (1) and a stuff class (2)
CFG_STUFF = {**CFG, "class_names": {1: "mito", 2: "stuff"}, "labels": [1, 2],
             "thing_list": [1]}
STUFF_PR = {**SMALL_PR, "num_classes": 3}


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def volume():
    return _volume(SHAPE, seed=60)


def _jax(models, fused, cfg=CFG, **kw):
    """The JAX engine on a one-device mesh: fused path and resident volume
    (``fused``) or the streamed path from the host."""
    model, variables, _ = models
    kw = {"sweep_fused": fused, "volume_resident": fused, **kw}
    return JaxEngine3d(cfg, model_and_variables=(model, variables), mesh=create_mesh(1), **kw)


def _port(models, cfg=CFG, **kw):
    return MultiChipEngine3d(cfg, models[2], device="cpu", **kw)


@pytest.fixture(scope="module")
def results(models, volume):
    """Per ``OPTIONS`` entry: the JAX streamed sweeps of the three axes
    (made once: the JAX engine compiles once per plane shape)."""
    cache = {}

    def get(option):
        if option not in cache:
            jeng = _jax(models, False, **ENGINE_KW, **OPTIONS[option])
            cache[option] = {axis: (jeng.infer_on_axis(volume, axis), jeng.last_overflow)
                             for axis in AXES}
        return cache[option]
    return get


def _assert_same(got, want):
    (gstack, gtr), (wstack, wtr) = got, want
    assert gstack.dtype == np.int32
    np.testing.assert_array_equal(gstack, wstack)
    assert_same_trackers(gtr, wtr)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("option", ["default", "fine-boundaries"])
def test_fused_matches_jax_fused(models, volume, option, axis):
    """B = 24 leaves a padded tail batch on every axis (8 xy slices, 64 xz
    and 80 yz planes)."""
    jeng = _jax(models, True, **ENGINE_KW, **OPTIONS[option])
    teng = _port(models, **ENGINE_KW, **OPTIONS[option])
    want = jeng.infer_on_axis(volume, axis)
    got = teng.infer_on_axis(volume, axis)
    assert teng.last_fused and teng.fallbacks == 0
    assert teng.last_batch_size == jeng.last_batch_size == 24
    assert teng.last_overflow == jeng.last_overflow
    _assert_same(got, want)
    assert sum(len(t.instances) for t in got[1]) >= 1
    assert {"upload", "forward_dispatch", "post_dispatch", "fetch",
            "host_decode+enqueue", "backward_matching"} <= set(teng.last_timing)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_fused_and_streamed_match_jax_streamed(models, volume, results, option):
    """Per axis the port's fused, resident-streamed and host-streamed
    sweeps equal the JAX streamed sweep; then the pipelined
    ``infer_orthoplane`` equals the three, with one upload of the volume."""
    want = results(option)
    kw = {**ENGINE_KW, **OPTIONS[option]}
    engines = {"fused": _port(models, **kw),
               "resident": _port(models, sweep_fused=False, **kw),
               "host": _port(models, sweep_fused=False, volume_resident=False, **kw)}
    for axis in AXES:
        (wstack, wtr), w_over = want[axis]
        for name, teng in engines.items():
            got = teng.infer_on_axis(volume, axis)
            assert teng.last_fused == (name == "fused")
            assert teng.last_overflow == w_over
            _assert_same(got, (wstack, wtr))
    assert engines["host"]._resident is None
    assert engines["resident"]._resident[1] is volume

    peng = _port(models, **kw)  # "auto": every axis eligible when pipelined
    uploads = []
    resident = peng._resident_volume
    peng._resident_volume = lambda v: uploads.append(peng._resident is None) or resident(v)
    timer = StageTimer()
    got = peng.infer_orthoplane(volume, timer=timer)
    assert list(got) == list(AXES) and uploads == [True, False, False]
    for axis in AXES:
        assert_same_trackers(got[axis], want[axis][0][1])
        stats = peng.last_axis_stats[axis]
        assert stats["path"] == "pipelined" and not stats["fallback"]
        assert stats["batch"] == 24 and stats["dispatch_s"] > 0 and stats["host_s"] > 0
        # each axis's own stages, while the caller's timer sums the three
        assert stats["timing"]["fetch"]["count"] == 1
    assert peng.last_overflow == max(w[1] for w in want.values())
    for stage, total in timer.report().items():
        parts = [peng.last_axis_stats[a]["timing"].get(stage) for a in AXES]
        assert total["count"] == sum(p["count"] for p in parts if p)
        assert total["total_s"] == pytest.approx(sum(p["total_s"] for p in parts if p))


def _c1_volume():
    """SHAPE's textured slices with every other slice a flat 128: the
    random-weight models see no region of the class there, so a matcher
    finds no target for the next textured slice's region."""
    vol = _volume((6, 64, 80), seed=60)
    vol[1::2] = 128
    return vol


@pytest.mark.parametrize("case", ["semantic-only", "stuff-class"])
def test_c1_regression(models, case):
    """Fault C1: the JAX fused path matches classes outside ``thing_list``
    across slices, so their regions take fresh ids where the streamed path
    (and the reference) keep the class id; the port's fused path keeps
    the streamed result.  Median window 1, so the flat slices stay flat."""
    kw = dict(ENGINE_KW, median_kernel_size=1, batch_size=2, min_size=0, min_extent=0,
              stuff_area=16)
    if case == "semantic-only":
        cfg, kw["semantic_only"] = CFG, True
        jmodels = models
        label = 1
    else:
        cfg, label = CFG_STUFF, 2
        model, variables = jax_init("PanopticDeepLabPR", STUFF_PR, size=64, seed=2)
        jmodels = (model, variables, port_model("PanopticDeepLabPR", STUFF_PR, variables))
    vol = _c1_volume()
    jax_fused = _jax(jmodels, True, cfg=cfg, **kw).infer_on_axis(vol, "xy")
    want = _jax(jmodels, False, cfg=cfg, **kw).infer_on_axis(vol, "xy")
    teng = _port(jmodels, cfg=cfg, **kw)
    got = teng.infer_on_axis(vol, "xy")
    assert teng.last_fused
    _assert_same(got, want)
    streamed_ids = sorted(want[1][cfg["labels"].index(label)].instances)
    fused_ids = sorted(jax_fused[1][cfg["labels"].index(label)].instances)
    assert streamed_ids == [label * 1000]
    assert fused_ids != streamed_ids and all(i > label * 1000 for i in fused_ids)


BUDGETS = {"jax-defaults": (1 << 30, 256 << 20), "small-fused": (1 << 16, 256 << 20),
           "small-resident": (1 << 30, 100_000)}


@pytest.mark.parametrize("budgets", list(BUDGETS))
@pytest.mark.parametrize("sweep_fused", ["auto", False])
@pytest.mark.parametrize("volume_resident", ["auto", False])
def test_sweep_eligible_matches_jax(models, monkeypatch, sweep_fused, volume_resident,
                                    budgets):
    """Over shapes (a stack too large for the small residency budget, a
    row too wide for int16 columns, a float volume), batches and byte
    budgets (the module's, patched down): the JAX engine's answers in
    ``infer_orthoplane``'s pipelined mode, which the port gives for every
    sweep; JAX's standalone sweep of fewer than 3 batches stays streamed."""
    fused_budget, resident_budget = BUDGETS[budgets]
    monkeypatch.setattr(dp, "SWEEP_FUSED_MAX_BYTES", fused_budget)
    monkeypatch.setattr(dp, "RESIDENT_MAX_BYTES", resident_budget)
    shapes = [((8, 64, 80), np.uint8), ((40, 64, 64), np.uint16), ((2, 4, 40000), np.uint8),
              ((8, 64, 80), np.float32)]
    vols = [np.zeros(s, d) for s, d in shapes]
    answers = []
    for batch in (None, 2, 24):
        kw = dict(batch_size=batch, sweep_fused=sweep_fused, volume_resident=volume_resident)
        jeng = _jax(models, False, sweep_fused_max_bytes=fused_budget,
                    resident_max_bytes=resident_budget, **kw)
        teng = _port(models, **kw)
        for vol in vols:
            for axis in range(3):
                got = teng._sweep_eligible(vol, axis)
                assert got == jeng._sweep_eligible(vol, axis, pipelined=True), (
                    kw, vol.shape, vol.dtype, axis)
                n_batches = -(-vol.shape[axis] // teng._resolve_batch(vol.shape, axis))
                assert jeng._sweep_eligible(vol, axis) == (got and n_batches >= 3)
                answers.append(got)
    assert (True in answers) == (sweep_fused is not False and volume_resident is not False
                                 and budgets != "small-fused")
    assert teng._resident is None  # asking uploads nothing


def _packed_stack(rng, n_slices, h, w, rcap, n_labels=7, base=1001):
    """Random blob slices packed as ``encode_runs_packed`` lays them out:
    per row [starts(R) | values(R) | count]."""
    rows = np.zeros((n_slices, h, 2 * rcap + 1), np.int16)
    for s in range(n_slices):
        seg = np.zeros((h, w), np.int64)
        for i in range(int(rng.integers(0, n_labels))):
            cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
            ry, rx = rng.integers(2, 7), rng.integers(2, 7)
            yy, xx = np.ogrid[:h, :w]
            seg[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = base + i
        for y in range(h):
            b = np.flatnonzero(np.concatenate([[True], seg[y][1:] != seg[y][:-1]]))
            rows[s, y, :len(b)] = b[:rcap]
            rows[s, y, rcap:rcap + len(b)] = seg[y][b][:rcap]
            rows[s, y, -1] = len(b)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_sweep_matches_jax(seed):
    """Byte-identical per-slice results to the JAX package's binding on
    random packed stacks (thing matching, with and without connected
    components), "fallback" on a row over its capacity and on ids over a
    connected class's window; without matching, each slice equals its
    ``packed_build_flat``."""
    rng = np.random.default_rng(seed)
    h = w = 48
    for trial in range(4):
        rows = _packed_stack(rng, int(rng.integers(2, 9)), h, w, rcap=16)
        for fc, thr in ((True, (0.25, 0.25)), (False, (0.05, 0.5))):
            want = jax_native.match_sweep(rows, w, 1000, 2000, fc, *thr, 1001)
            got = native.match_sweep(rows, w, 1000, 2000, fc, *thr, 1001)
            assert isinstance(got, list) and len(got) == len(want) == len(rows)
            for g, x in zip(got, want):
                for a, b in zip(g, x):
                    assert a.dtype == b.dtype and np.array_equal(a, b), (seed, trial)
        unmatched = native.match_sweep(rows, w, 1000, 2000, False, 0.25, 0.25, 1001,
                                       match=False)
        for s, fields in enumerate(unmatched):
            for a, b in zip(fields, native.packed_build_flat(rows[s], w, 1000, 2000, False)):
                assert np.array_equal(a, b), (seed, trial, s)
    rows = _packed_stack(rng, 3, h, w, rcap=16, n_labels=9)
    rows[1, 5, -1] = 17  # one row past its 16-run capacity
    assert native.match_sweep(rows, w, 1000, 2000, True, 0.25, 0.25, 1001) == "fallback"
    assert jax_native.match_sweep(rows, w, 1000, 2000, True, 0.25, 0.25, 1001) == "fallback"
    rows[1, 5, -1] = 0
    # a window of 2 ids holds no slice of several blobs
    assert native.match_sweep(rows, w, 1001, 1003, True, 0.25, 0.25, 1002) == "fallback"
    assert jax_native.match_sweep(rows, w, 1001, 1003, True, 0.25, 0.25, 1002) == "fallback"


@pytest.mark.parametrize("axis", ["xy", "yz"])
@pytest.mark.parametrize("case", ["row-overflow", "numpy-stitching"])
def test_fused_per_slice_path(models, volume, results, monkeypatch, axis, case):
    """With a run capacity of 4 (the port's capacity rule patched down)
    some slices' rows overflow: the fused sweep takes the per-slice path
    (dense maps for those slices only), counts one fallback and equals the
    streamed sweep at the same capacity.  With ``native.use_native`` off
    the host half takes the per-slice path by rule, not as a fallback, and
    equals the JAX streamed sweep."""
    if case == "row-overflow":
        monkeypatch.setattr(MultiChipEngine3d, "_max_runs", lambda self, w: min(4, w))
        want = _port(models, sweep_fused=False, volume_resident=False,
                     **ENGINE_KW).infer_on_axis(volume, axis)
    else:
        monkeypatch.setattr(native, "use_native", False)
        want = results("default")[axis][0]
    teng = _port(models, **ENGINE_KW)
    got = teng.infer_on_axis(volume, axis)
    assert teng.last_fused
    assert teng.fallbacks == (case == "row-overflow")
    _assert_same(got, want)
