"""The port's batched 3D xy sweep against the JAX package's, in float32 on
the CPU: the same small PanopticDeepLabPR weights (flax init, carried over
by the weight bridge) through ``MultiChipEngine3d`` of both packages (the
JAX one on a one-device mesh, streamed path: ``sweep_fused=False``,
``volume_resident=False``; the port's streamed path too, its batches sliced
from the resident volume).  Tracker instances (ids, boxes, runs) and the
filled panoptic stacks must be identical; the random-weight fixtures hold
no PointRend top-k ties or Hungarian ties (PARITY "Known divergences" 2
and 8), so no tie class needs to be excused."""

import numpy as np
import pytest

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu_torch.core import native
from empanada_tpu_torch.parallel import data_parallel as dp
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

CFG = {
    "class_names": {1: "mito"},
    "labels": [1],
    "thing_list": [1],
    "model": "unused",
    "padding_factor": 16,
    "norms": {"mean": 0.57571, "std": 0.12765},
}
ENGINE_KW = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=64,
                 confidence_thr=0.5, save_panoptic=True)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


def _volume(z, shape, seed):
    return np.stack([make_blob_image(shape, n_blobs=5, seed=seed + i) for i in range(z)])


def _instances(trackers):
    return [{int(k): (tuple(int(b) for b in v["box"]), np.asarray(v["starts"]),
                      np.asarray(v["runs"]))
             for k, v in t.instances.items()} for t in trackers]


def _assert_same(got, want):
    (gstack, gtr), (wstack, wtr) = got, want
    assert gstack.dtype == np.int32 and gstack.shape == wstack.shape
    np.testing.assert_array_equal(gstack, wstack)
    gi, wi = _instances(gtr), _instances(wtr)
    assert [sorted(d) for d in gi] == [sorted(d) for d in wi]
    for gd, wd in zip(gi, wi):
        for k in wd:
            assert gd[k][0] == wd[k][0], k
            np.testing.assert_array_equal(gd[k][1], wd[k][1])
            np.testing.assert_array_equal(gd[k][2], wd[k][2])


def _run_both(models, vol, jax_kw=(), **kw):
    model, variables, tmodel = models
    jeng = JaxEngine3d(CFG, model_and_variables=(model, variables), sweep_fused=False,
                       volume_resident=False, mesh=create_mesh(1), **ENGINE_KW, **kw,
                       **dict(jax_kw))
    teng = MultiChipEngine3d(CFG, tmodel, device="cpu", sweep_fused=False, **ENGINE_KW, **kw)
    want = jeng.infer_on_axis(vol, "xy")
    got = teng.infer_on_axis(vol, "xy")
    assert teng.last_batch_size == jeng.last_batch_size
    assert teng.last_overflow == jeng.last_overflow
    return got, want, teng


@pytest.mark.parametrize("z,use_native", [(10, True), (10, False), (2, True)],
                         ids=["z10-tail-native", "z10-tail-numpy", "z2-under-ks"])
def test_xy_sweep_matches_jax(models, monkeypatch, z, use_native):
    """Z = 10 at B = 4 pads the last batch (padded slices must not reach the
    matcher); Z = 2 < ks leaves every slice unmedianed."""
    monkeypatch.setattr(native, "use_native", use_native)
    got, want, teng = _run_both(models, _volume(z, (64, 80), seed=20), batch_size=4)
    _assert_same(got, want)
    assert sum(len(t.instances) for t in got[1]) >= 2  # instances, not a blank run
    timing = teng.last_timing
    assert {"forward_dispatch", "post_dispatch", "fetch", "backward_matching"} <= set(timing)


@pytest.mark.parametrize("kw", [dict(fine_boundaries=True), dict(semantic_only=True)],
                         ids=["fine-boundaries", "semantic-only"])
def test_xy_sweep_options_match_jax(models, kw):
    """The engine options the CLI passes: instance maps upsampled to full
    resolution before grouping, and no thing classes (the matchers and
    trackers see semantic ids only)."""
    got, want, _ = _run_both(models, _volume(6, (64, 80), seed=50), batch_size=4, **kw)
    _assert_same(got, want)
    assert sum(len(t.instances) for t in got[1]) >= 1


@pytest.mark.parametrize("case", ["row-overflow-dense-fallback", "dense-transfer"])
def test_xy_sweep_dense_paths(models, monkeypatch, case):
    """Rows with more runs than the packed capacity send their slice's dense
    map instead: at a capacity of R = 8 runs (the port's capacity rule
    patched down, the JAX engine's ``max_runs_per_row``) two of these six
    slices overflow and four go packed.  Ids past 65535 (label_divisor
    40000, two classes) send every slice dense."""
    vol = _volume(6, (64, 80), seed=30)
    if case == "dense-transfer":
        got, want, teng = _run_both(models, vol, batch_size=4, label_divisor=40000)
        assert teng._max_runs(80) == 0
    else:
        monkeypatch.setattr(MultiChipEngine3d, "_max_runs", lambda self, w: min(8, w))
        got, want, _ = _run_both(models, vol, jax_kw=dict(max_runs_per_row=8), batch_size=4)
    _assert_same(got, want)


def test_xy_sweep_narrow_clamps_max_runs(models):
    """A 24-px-wide volume clamps the packed run capacity to the width and
    still matches; the auto batch resolves as the JAX engine's does."""
    got, want, teng = _run_both(models, _volume(5, (64, 24), seed=40))
    assert teng._max_runs(24) == 24
    _assert_same(got, want)


def test_engine_rules(models, tmp_path):
    """Checkpointing (A6d), the fused path's knobs (A6c), scale 2 (A6e)
    and stores (item 8) are taken; a scale that is not a power of 2, float
    volumes and unknown axes are refused."""
    _, _, tmodel = models
    eng = MultiChipEngine3d(CFG, tmodel, device="cpu", batch_size=2)
    vol = np.zeros((2, 32, 32), np.uint8)
    ckpt_dir = tmp_path / "ckpt"
    stack, trackers = eng.infer_on_axis(vol, "xy", checkpoint_dir=str(ckpt_dir))
    assert stack is None and [t.class_id for t in trackers] == [1]
    assert not list(ckpt_dir.iterdir())  # a finished axis leaves no forward state
    assert set(eng.infer_orthoplane(vol, resume=True)) == {"xy", "xz", "yz"}
    with pytest.raises(ValueError, match="axis 'zx'"):
        eng.infer_on_axis(vol, "zx")
    assert (eng.sweep_fused, eng.volume_resident) == ("auto", "auto")
    assert (dp.SWEEP_FUSED_MAX_BYTES, dp.RESIDENT_MAX_BYTES) == (1 << 30, 256 << 20)
    assert MultiChipEngine3d(CFG, tmodel, device="cpu", volume_resident=False).sweep_fused
    for knob, value in (("sweep_fused", "always"), ("sweep_fused", True),
                        ("volume_resident", True), ("volume_resident", 0)):
        with pytest.raises(ValueError, match=knob):
            MultiChipEngine3d(CFG, tmodel, device="cpu", **{knob: value})
    store = MultiChipEngine3d(CFG, tmodel, device="cpu", batch_size=2, save_panoptic=True,
                              store_url=str(tmp_path / "store"), chunk_size=(2, 16, 16))
    assert store.infer_on_axis(vol, "xy")[0].chunks == (2, 16, 16)
    with pytest.raises(TypeError, match="float"):
        eng.infer_on_axis(np.zeros((2, 32, 32), np.float32), "xy")
    assert MultiChipEngine3d(CFG, tmodel, device="cpu", inference_scale=2).inference_scale == 2
    with pytest.raises(ValueError, match="power of 2"):
        MultiChipEngine3d(CFG, tmodel, device="cpu", inference_scale=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiChipEngine3d(CFG, tmodel)  # no GPU here: the default device raises
