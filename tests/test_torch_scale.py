"""``inference_scale`` 2 and the padding-512 configs through the port's
``MultiChipEngine3d`` and render engine, against the JAX package's on the
CPU in float32 (one-device mesh): the xy and xz sweeps at scale 2 with a
depth that is not a multiple of the batch, with the port's default paths
("auto", which stream at scale 2 as JAX's do) and streamed; the checkpoint
meta carries the scale; and NucleoNet_base_v2's padding of 512 (a 600 x
700 slice pads to 1024 x 1024) through the 2D render engine and an xy
sweep, at small widths.  Maps, stacks and trackers must be equal."""

import numpy as np
import pytest

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu.engine import PanopticDeepLabRenderEngine as JaxEngine
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu_torch import api
from empanada_tpu_torch.engine import PanopticDeepLabRenderEngine
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from test_torch_ortho import CFG, _volume, assert_same_trackers

KW = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=64,
          confidence_thr=0.5, save_panoptic=True, batch_size=4)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def jax_scale2(models):
    model, variables, _ = models
    return JaxEngine3d(CFG, model_and_variables=(model, variables), inference_scale=2,
                       sweep_fused=False, mesh=create_mesh(1), **KW)


@pytest.fixture(scope="module")
def volume():
    return _volume((9, 40, 52), seed=90)  # 9 slices: B = 4 leaves a tail batch


@pytest.mark.parametrize("axis", ["xy", "xz"])
@pytest.mark.parametrize("knobs", [{}, dict(sweep_fused=False, volume_resident=False)])
def test_scale2_sweep_matches_jax(models, jax_scale2, volume, axis, knobs):
    eng = MultiChipEngine3d(CFG, models[2], device="cpu", inference_scale=2, **KW, **knobs)
    got_stack, got = eng.infer_on_axis(volume, axis)
    want_stack, want = jax_scale2.infer_on_axis(volume, axis)
    assert not eng.last_fused  # the slices are downsampled on the host
    np.testing.assert_array_equal(got_stack, want_stack)
    assert_same_trackers(got, want)
    assert sum(len(t.instances) for t in got) >= 1
    assert eng.last_overflow == jax_scale2.last_overflow


def test_scale2_auto_batch_and_checkpoint_meta(models, volume, tmp_path):
    """The auto batch counts the downsampled slices' pixels, as JAX's
    does; the meta records the scale, and a checkpointed sweep at scale 2
    runs."""
    eng = MultiChipEngine3d(CFG, models[2], device="cpu", inference_scale=2,
                            **dict(KW, batch_size=None))
    jax_auto = JaxEngine3d(CFG, model_and_variables=models[:2], inference_scale=2,
                           mesh=create_mesh(1), **dict(KW, batch_size=None))
    for shape in ((9, 40, 52), (64, 1024, 1000)):
        assert [eng._resolve_batch(shape, a) for a in range(3)] == \
            [jax_auto._resolve_batch(shape, a) for a in range(3)]
    meta = eng._checkpoint_meta(volume, "xy")
    assert meta["inference_scale"] == 2
    assert meta == {k: v for k, v in jax_auto._checkpoint_meta(volume, "xy").items()
                    if k in meta}
    eng.infer_on_axis(volume, "xy", checkpoint_dir=str(tmp_path), checkpoint_every=4)
    with pytest.raises(ValueError):
        MultiChipEngine3d(CFG, models[2], device="cpu", inference_scale=3)


# ---- padding 512 (NucleoNet_base_v2, DropNet_base_v1) -------------------


@pytest.mark.parametrize("name", ["NucleoNet_base_v2"])
def test_padding_512_matches_jax(models, name):
    cfg = api.load_config(name)
    assert cfg["padding_factor"] == 512
    model, variables, tmodel = models
    small = {**CFG, "padding_factor": cfg["padding_factor"], "norms": cfg["norms"],
             "class_names": cfg["class_names"]}
    kw = dict(thing_list=cfg["thing_list"], padding_factor=512, max_centers=64,
              confidence_thr=0.5)
    img = make_blob_image((600, 700), n_blobs=30, seed=11)
    x = api.Preprocessor(**cfg["norms"])(img)["image"]
    got = PanopticDeepLabRenderEngine(tmodel, device="cpu", **kw)(x, img.shape)
    want = JaxEngine(model, variables, **kw)(x, img.shape)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 3
    vol = np.stack([make_blob_image((600, 700), n_blobs=30, seed=20 + z) for z in range(3)])
    ekw = dict(KW, batch_size=2)
    eng = MultiChipEngine3d(small, tmodel, device="cpu", **ekw)
    got_stack, got_tr = eng.infer_on_axis(vol, "xy")
    want_stack, want_tr = JaxEngine3d(small, model_and_variables=(model, variables),
                                      sweep_fused=False, mesh=create_mesh(1),
                                      **ekw).infer_on_axis(vol, "xy")
    np.testing.assert_array_equal(got_stack, want_stack)
    assert_same_trackers(got_tr, want_tr)
