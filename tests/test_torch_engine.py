"""The whole slice of the PyTorch port in float32 on the CPU: a small
PanopticDeepLabPR with the same weights (flax init, carried over by the
weight bridge) served through the JAX package's render engines and the
port's.  The panoptic maps must be identical: slices of odd size through the
2D engines, a z-stack through the 3D engines with the median queue and
``end()``."""

import jax
import numpy as np
import pytest
import torch

from _torch_port import SMALL_PR, jax_init, port_model
from conftest import make_blob_image
from empanada_tpu.api.utils import Preprocessor as JaxPreprocessor
from empanada_tpu.engine import PanopticDeepLabRenderEngine as JaxEngine
from empanada_tpu.engine import PanopticDeepLabRenderEngine3d as JaxEngine3d
from empanada_tpu_torch.api import Preprocessor
from empanada_tpu_torch.engine import (
    MedianQueue,
    PanopticDeepLabRenderEngine,
    PanopticDeepLabRenderEngine3d,
)

NORMS = dict(mean=0.57571, std=0.12765)
ENGINE_KW = dict(thing_list=[1], padding_factor=16, coarse_boundaries=True,
                 max_centers=64, nms_threshold=0.1, confidence_thr=0.5)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


def _image(shape, seed, n_blobs=6):
    img = make_blob_image(shape, n_blobs=n_blobs, seed=seed)
    want = JaxPreprocessor(**NORMS)(img)["image"]
    got = Preprocessor(**NORMS)(img)["image"]
    np.testing.assert_array_equal(got, want)
    return got


def _same(got, want):
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,upsampling", [((150, 173), 1), ((64, 80), 2)])
def test_render_engine_2d(models, shape, upsampling):
    model, variables, tmodel = models
    jeng = JaxEngine(model, variables, **ENGINE_KW)
    teng = PanopticDeepLabRenderEngine(tmodel, device="cpu", **ENGINE_KW)
    img = _image(shape, seed=3)
    size = tuple(s * upsampling for s in shape)
    want = jeng(img, size=size, upsampling=upsampling)
    got = teng(img, size=size, upsampling=upsampling)
    _same(got, want)
    assert len(np.unique(got[got > 0])) >= 2  # instances, not a blank map
    # dispatch returns the unfetched device tensor
    pan = teng.dispatch(img, size=size, upsampling=upsampling)
    assert isinstance(pan, torch.Tensor) and pan.dtype == torch.int32
    assert teng.dropped_centers() == jeng.dropped_centers() == 0


def test_render_engine_update_params_and_overflow(models):
    model, variables, tmodel = models
    jeng = JaxEngine(model, variables, **ENGINE_KW)
    teng = PanopticDeepLabRenderEngine(tmodel, device="cpu", **ENGINE_KW)
    img = _image((96, 96), seed=5)
    for params in (dict(confidence_thr=0.7, nms_threshold=0.05, max_centers=2),
                   dict(nms_kernel=3, stuff_area=8)):
        jeng.update_params(**params)
        teng.update_params(**params)
        _same(teng(img, size=img.shape[1:]), jeng(img, size=img.shape[1:]))
        assert teng.dropped_centers() == jeng.dropped_centers()
    assert teng.dropped_centers() > 0  # max_centers=2 drops centers
    teng.reset_overflow()
    assert teng.dropped_centers() == 0
    with pytest.raises(ValueError, match="power of 2"):
        teng(img, size=img.shape[1:], upsampling=3)


def test_render_engine_3d_stack(models):
    model, variables, tmodel = models
    jeng = JaxEngine3d(model, variables, median_kernel_size=3, **ENGINE_KW)
    teng = PanopticDeepLabRenderEngine3d(tmodel, median_kernel_size=3, device="cpu",
                                         **ENGINE_KW)
    stack = [_image((90, 101), seed=10 + z) for z in range(5)]
    want, got = [], []
    for img in stack:
        w, g = jeng(img, size=img.shape[1:]), teng(img, size=img.shape[1:])
        assert (w is None) == (g is None)
        want += [] if w is None else [w]
        got += [] if g is None else [g]
    want += jeng.end()
    got += teng.end()
    assert len(got) == len(want) == len(stack)
    for g, w in zip(got, want):
        _same(g, w)
    # end() clears the queue: a reused engine starts again from passthrough
    _same(teng(stack[0], size=stack[0].shape[1:]), jeng(stack[0], size=stack[0].shape[1:]))


def test_median_queue():
    q = MedianQueue(3)
    vals = [torch.full((1, 2, 2, 1), float(v)) for v in (5, 1, 3, 9)]
    outs = []
    for v in vals:
        q.enqueue({"sem": v})
        o = q.get_next(["sem"])
        outs.append(None if o is None else float(o["sem"][0, 0, 0, 0]))
    # passthrough, fill, median(5, 1, 3), median(1, 3, 9): raw slices only
    assert outs == [5.0, None, 3.0, 3.0]
    assert [float(o["sem"][0, 0, 0, 0]) for o in q.end()] == [9.0]
    assert len(q.queue) == 0
    with pytest.raises(ValueError):
        MedianQueue(4)


def test_jax_stays_on_cpu():
    # both packages run here on the CPU: the parity above is a CPU statement
    assert jax.default_backend() == "cpu"
