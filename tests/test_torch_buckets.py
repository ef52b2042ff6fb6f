"""``shape_buckets`` in the port against the JAX package (ROADMAP C10), in
float32 on the CPU with the same weights.  With the flag an image pads to
the next size of ``bucket_dim``'s ladder instead of the next multiple of
the padding factor, and the padding changes the result (the ASPP pooling
is a global mean over the padded input).  At 110 x 110 with padding 16 the
plain pad is 112 and the bucket 128, so the maps at each setting must equal
JAX's at the same setting, and the two settings must differ."""

import numpy as np
import pytest

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.engine import BCEngine as JaxBCEngine
from empanada_tpu.engine import BCEngine3d as JaxBCEngine3d
from empanada_tpu.engine import PanopticDeepLabRenderEngine as JaxEngine
from empanada_tpu.engine import PanopticDeepLabRenderEngine3d as JaxEngine3d
from empanada_tpu_torch import api
from empanada_tpu_torch.api import Preprocessor
from empanada_tpu_torch.engine import (
    BCEngine,
    BCEngine3d,
    PanopticDeepLabRenderEngine,
    PanopticDeepLabRenderEngine3d,
)
from empanada_tpu_torch.ops.postprocess import bucket_dim
from test_torch_ortho import _volume, assert_same_trackers

NORMS = {"mean": 0.57571, "std": 0.12765}
CFG = {"model_name": "tiny", "class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
       "model": "unused", "padding_factor": 16, "norms": NORMS}
ENGINE_KW = dict(thing_list=[1], padding_factor=16, coarse_boundaries=True,
                 max_centers=64, nms_threshold=0.1, confidence_thr=0.5)
KW2D = dict(nms_kernel=3, max_centers=32, confidence_thr=0.5)
SIDE = 110  # off the ladder: 112 padded, 128 bucketed
TOL = 1e-5  # the BC maps are float32 sigmoids (tests/test_torch_bc.py)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def bc_models():
    model, variables = jax_init("PanopticDeepLabBC", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabBC", SMALL_PR, variables)


def _image(seed, side=SIDE):
    return make_blob_image((side, side), n_blobs=6, seed=seed)


def _prep(img):
    return Preprocessor(**NORMS)(img)["image"]


def test_the_side_is_off_the_ladder():
    assert SIDE + (-SIDE) % 16 == 112 and bucket_dim(SIDE, 16) == 128


@pytest.fixture(scope="module")
def render_maps(models):
    """{buckets: (port map, JAX map)} of one 110² slice."""
    model, variables, tmodel = models
    x = _prep(_image(seed=11))
    out = {}
    for buckets in (False, True):
        got = PanopticDeepLabRenderEngine(tmodel, device="cpu", shape_buckets=buckets,
                                          **ENGINE_KW)(x, size=(SIDE, SIDE))
        want = JaxEngine(model, variables, shape_buckets=buckets,
                         **ENGINE_KW)(x, size=(SIDE, SIDE))
        out[buckets] = (got, want)
    return out


@pytest.mark.parametrize("buckets", [False, True])
def test_render_engine_matches_jax(render_maps, buckets):
    got, want = render_maps[buckets]
    assert got.shape == want.shape == (SIDE, SIDE)
    np.testing.assert_array_equal(got, want)


def test_the_bucket_changes_the_map(render_maps):
    assert (render_maps[True][0] != render_maps[False][0]).any()


def test_render_engine3d_matches_jax(models):
    model, variables, tmodel = models
    xs = [_prep(_image(seed=20 + i)) for i in range(4)]
    maps = []
    for eng in (PanopticDeepLabRenderEngine3d(tmodel, device="cpu", shape_buckets=True,
                                              median_kernel_size=3, **ENGINE_KW),
                JaxEngine3d(model, variables, shape_buckets=True, median_kernel_size=3,
                            **ENGINE_KW)):
        outs = [eng(x, size=(SIDE, SIDE)) for x in xs]
        maps.append(np.stack([o for o in outs if o is not None] + eng.end()))
    assert maps[0].shape == (4, SIDE, SIDE)
    np.testing.assert_array_equal(*maps)


@pytest.mark.parametrize("tile_size", [0, 64])
def test_engine2d_matches_jax(models, tile_size):
    """Untiled, and tiled (each tile of 64 + its overlap bucketed)."""
    model, variables, tmodel = models
    img = _image(seed=12)
    kw = dict(KW2D, shape_buckets=True, tile_size=tile_size)
    got = api.Engine2d(CFG, model=tmodel, device="cpu", **kw).infer(img)
    want = jax_api.Engine2d(CFG, model_and_variables=(model, variables), **kw).infer(img)
    assert got.dtype == np.int64 and got.shape == (SIDE, SIDE)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 2


def test_engine3d_matches_jax(models):
    model, variables, tmodel = models
    vol = _volume((5, 70, 90), seed=13)
    kw = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=32,
              confidence_thr=0.5, shape_buckets=True, save_panoptic=True)
    got_stack, got = api.Engine3d(CFG, model=tmodel, device="cpu",
                                  **kw).infer_on_axis(vol, "xy")
    want_stack, want = jax_api.Engine3d(CFG, model_and_variables=(model, variables),
                                        **kw).infer_on_axis(vol, "xy")
    np.testing.assert_array_equal(got_stack, want_stack)
    assert_same_trackers(got, want)


def test_bc_engines_match_jax(bc_models):
    model, variables, tmodel = bc_models
    xs = [_prep(_image(seed=30 + i)) for i in range(3)]
    got = BCEngine(tmodel, device="cpu", shape_buckets=True)(xs[0])
    want = JaxBCEngine(model, variables, shape_buckets=True)(xs[0])
    plain = BCEngine(tmodel, device="cpu")(xs[0])
    assert got.shape == want.shape == (SIDE, SIDE, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(got - plain).max() > 100 * TOL
    stacks = []
    for eng in (BCEngine3d(tmodel, device="cpu", shape_buckets=True, median_kernel_size=3),
                JaxBCEngine3d(model, variables, shape_buckets=True, median_kernel_size=3)):
        outs = [eng(x, size=(SIDE, SIDE)) for x in xs]
        stacks.append(np.stack([o for o in outs if o is not None] + eng.end()))
    assert stacks[0].shape == (3, SIDE, SIDE, 2)
    np.testing.assert_allclose(*stacks, rtol=0, atol=TOL)
