"""The boundary-contour model and the plain-model engines of the port
against the JAX package's, in float32 on the CPU with the same weights
(seeded values in the flax tree, carried by the weight bridge):
``PanopticDeepLabBC``, ``BCEngine{,3d}``, ``bc_watershed`` (2D and 3D, the
mask and the grayscale flood) and the watershed floods themselves,
``PanopticDeepLabEngine{,3d}`` on a plain ``PanopticDeepLab``,
``logits_to_prob`` and ``get_panoptic_segmentation``.  Sigmoid and
probability maps within 1e-5; labels and panoptic maps equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu.engine import BCEngine as JaxBCEngine
from empanada_tpu.engine import BCEngine3d as JaxBCEngine3d
from empanada_tpu.engine import PanopticDeepLabEngine as JaxPlainEngine
from empanada_tpu.engine import PanopticDeepLabEngine3d as JaxPlainEngine3d
from empanada_tpu.ops import postprocess as jpp
from empanada_tpu.stitch import watershed as jws
from empanada_tpu_torch.api import Preprocessor
from empanada_tpu_torch.engine import (
    BCEngine,
    BCEngine3d,
    PanopticDeepLabEngine,
    PanopticDeepLabEngine3d,
)
from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.stitch import watershed as ws
from test_torch_ortho import _volume

TOL = 1e-5
NORMS = {"mean": 0.57571, "std": 0.12765}
PLAIN = {k: v for k, v in SMALL_PR.items() if k != "subdivision_num_points"}


def _slices(z, shape, seed):
    pre = Preprocessor(**NORMS)
    return [pre(make_blob_image(shape, n_blobs=6, seed=seed + i))["image"] for i in range(z)]


# ---- the BC model and its engines ----------------------------------------


@pytest.fixture(scope="module")
def bc_models():
    model, variables = jax_init("PanopticDeepLabBC", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabBC", SMALL_PR, variables)


def test_bc_model_matches_jax(bc_models):
    """Both heads refined by their PointRend heads (K = 256 of 64² maps:
    the dense step, then the sparse one); the flax model's unused center and
    offset heads hold no parameters and the port builds none."""
    model, variables, tmodel = bc_models
    assert not hasattr(tmodel, "ins_center") and not hasattr(tmodel, "ins_xy")
    x = np.random.default_rng(3).normal(0, 1, (1, 64, 64, 1)).astype(np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["cnt_logits", "sem_logits"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=TOL)


def test_bc_engine_matches_jax(bc_models):
    model, variables, tmodel = bc_models
    image = _slices(1, (70, 90), seed=20)[0]
    got = BCEngine(tmodel, device="cpu")(image)
    want = JaxBCEngine(model, variables)(image)
    assert got.shape == want.shape == (70, 90, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def bc_stacks(bc_models):
    """(port, JAX) BCEngine3d outputs over a 7-slice stack, drained."""
    model, variables, tmodel = bc_models
    stacks = []
    for eng in (BCEngine3d(tmodel, device="cpu", median_kernel_size=3),
                JaxBCEngine3d(model, variables, median_kernel_size=3)):
        outs = [eng(x, size=(70, 90)) for x in _slices(7, (70, 90), seed=30)]
        stacks.append(np.stack([o for o in outs if o is not None] + eng.end()))
    return stacks


def test_bc_engine3d_matches_jax(bc_stacks):
    got, want = bc_stacks
    assert got.shape == want.shape == (7, 70, 90, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bc_engine3d_stack_through_the_watershed(bc_stacks):
    """The stack in uint8 scale, channel first, through both packages'
    ``bc_watershed``: the same labels."""
    vol = (bc_stacks[0].transpose(3, 0, 1, 2) * 255).astype(np.uint8)
    kw = dict(thres1=0.6, thres2=0.4, thres3=0.55, seed_thres=4, min_size=8)
    got, want = ws.bc_watershed(vol, **kw), jws.bc_watershed(vol, **kw)
    assert got.dtype == want.dtype and got.shape == (7, 70, 90)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 4


# ---- the watershed -------------------------------------------------------


def _bc_volume(shape, seed):
    """(2, ...) uint8 maps with real objects: the foreground of seeded
    blobs, and its gradient magnitude as the boundary."""
    vol = _volume(shape, seed=seed) if len(shape) == 3 else make_blob_image(
        shape, n_blobs=12, seed=seed)
    sem = ndimage.gaussian_filter(255.0 - vol, 1.0)
    sem = (sem - sem.min()) / (sem.max() - sem.min())
    grad = ndimage.gaussian_gradient_magnitude(sem, 1.0)
    return np.stack([sem * 255, grad / grad.max() * 255]).astype(np.uint8)


@pytest.mark.parametrize("flood", ["gray", "mask"])
@pytest.mark.parametrize("shape", [(96, 110), (8, 48, 56)], ids=["2d", "3d"])
def test_bc_watershed_matches_jax(shape, flood):
    vol = _bc_volume(shape, seed=40)
    kw = dict(thres1=0.6, thres2=0.3, thres3=0.45, seed_thres=4, min_size=8,
              use_mask_wts=flood == "mask")
    got, want = ws.bc_watershed(vol, **kw), jws.bc_watershed(vol, **kw)
    assert got.dtype == want.dtype and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 4  # several instances, not a blank map
    assert got[got > 0].min() > 1000  # ids past the label divisor


@pytest.mark.parametrize("connectivity", [1, 2])
def test_watershed_floods_match_jax(connectivity):
    rng = np.random.default_rng(41)
    image = ndimage.gaussian_filter(rng.random((30, 40)), 2).astype(np.float32)
    mask = image > np.quantile(image, 0.3)
    markers = np.zeros(image.shape, np.int64)
    markers[tuple(rng.integers(0, 30, 6)), tuple(rng.integers(0, 40, 6))] = np.arange(1, 7)
    np.testing.assert_array_equal(ws.gray_watershed(image, markers, mask, connectivity),
                                  jws.gray_watershed(image, markers, mask, connectivity))
    np.testing.assert_array_equal(ws.mask_watershed(mask, markers, connectivity),
                                  jws.mask_watershed(mask, markers, connectivity))
    seg = np.array([[0, 3, 3], [300, 0, 7]], np.int64)
    np.testing.assert_array_equal(ws.size_threshold(seg.copy(), 2),
                                  jws.size_threshold(seg.copy(), 2))
    for top in (200, 300, 70000, 2**33):
        assert ws.cast2dtype(np.array([top])).dtype == jws.cast2dtype(np.array([top])).dtype


# ---- the plain engines ---------------------------------------------------


@pytest.fixture(scope="module")
def plain_models():
    model, variables = jax_init("PanopticDeepLab", PLAIN, size=64)
    return model, variables, port_model("PanopticDeepLab", PLAIN, variables)


KW = dict(thing_list=[1], nms_kernel=3, max_centers=32, confidence_thr=0.5)


def test_plain_engine_matches_jax(plain_models):
    model, variables, tmodel = plain_models
    image = _slices(1, (64, 80), seed=50)[0]
    eng = PanopticDeepLabEngine(tmodel, device="cpu", **KW)
    jeng = JaxPlainEngine(model, variables, **KW)
    out, jout = eng.infer(image), jeng.infer(image)
    np.testing.assert_allclose(out["sem"].numpy(), np.asarray(jout["sem"]), rtol=0, atol=TOL)
    got, want = eng(image), jeng(image)
    assert got.dtype == np.int32 and got.shape == (64, 80)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 2


def test_plain_engine3d_matches_jax(plain_models):
    model, variables, tmodel = plain_models
    stacks = []
    for eng in (PanopticDeepLabEngine3d(tmodel, device="cpu", median_kernel_size=3, **KW),
                JaxPlainEngine3d(model, variables, median_kernel_size=3, **KW)):
        outs = [eng(x) for x in _slices(7, (64, 80), seed=60)]
        stacks.append(np.stack([o for o in outs if o is not None] + eng.end()))
    assert stacks[0].shape == (7, 64, 80)
    np.testing.assert_array_equal(*stacks)


# ---- postprocess ---------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
def test_logits_to_prob_matches_jax(channels):
    x = np.random.default_rng(70).normal(0, 3, (2, 9, 11, channels)).astype(np.float32)
    np.testing.assert_allclose(pp.logits_to_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(jpp.logits_to_prob(jnp.asarray(x))),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_get_panoptic_segmentation_matches_jax(num_classes):
    rng = np.random.default_rng(71 + num_classes)
    h, w = 40, 48
    sem = rng.integers(0, num_classes, (1, h, w)).astype(np.int32)
    sem = ndimage.median_filter(sem, size=(1, 5, 5))
    ctr = ndimage.gaussian_filter(rng.random((1, h, w, 1)), (0, 3, 3, 0)).astype(np.float32)
    ctr = ctr / ctr.max()
    offsets = rng.normal(0, 4, (1, h, w, 2)).astype(np.float32)
    args = ([1], 1000, 20, 0, 0.5, 5, num_classes, 32)
    got = pp.get_panoptic_segmentation(torch.from_numpy(sem), torch.from_numpy(ctr),
                                       torch.from_numpy(offsets), *args)
    want = jpp.get_panoptic_segmentation(jnp.asarray(sem), jnp.asarray(ctr),
                                         jnp.asarray(offsets), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) >= 3
