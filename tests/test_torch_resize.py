"""The port's ``resize_by_factor`` (cv2's bilinear downsample computed in
numpy) against the JAX package's, which calls ``cv2.resize(...,
INTER_LINEAR)``: uint8 bit for bit over a seeded grid of shapes 1-1100 px
and scales 2-64, and a hypothesis search; uint16, int16, float32 and
float64 bit for bit (tolerance 0) over a seeded grid, odd sides and sides
of 1 among them; int32, which cv2 refuses, raises in both packages;
``VolumeDataset`` at scale 2 yields the JAX dataset's slices, uint8 and
uint16, on every axis."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from empanada_tpu.api.utils import Preprocessor as JaxPreprocessor
from empanada_tpu.data.volume import VolumeDataset as JaxVolumeDataset
from empanada_tpu.data.volume import resize_by_factor as jax_resize
from empanada_tpu_torch.api import Preprocessor
from empanada_tpu_torch.data.volume import VolumeDataset, resize_by_factor

NORMS = {"mean": 0.57571, "std": 0.12765}


def _cases(n, seed):
    rng = np.random.default_rng(seed)
    edge = [(1, 1), (1, 7), (9, 1), (2, 2), (3, 5), (1100, 3), (2, 1100), (64, 64), (1024, 1024)]
    for h, w in edge:
        yield h, w, 2
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(1, 1101, 2))
        yield h, w, int(2 ** rng.integers(1, 7))


@pytest.mark.parametrize("seed", range(4))
def test_uint8_bit_exact_grid(seed):
    rng = np.random.default_rng(100 + seed)
    for h, w, k in _cases(60, seed):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        got, want = resize_by_factor(img, k), jax_resize(img, k)
        assert got.dtype == np.uint8 and got.shape == want.shape, (h, w, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, k)}")


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 300), w=st.integers(1, 300), log_k=st.integers(1, 6),
       seed=st.integers(0, 2 ** 31 - 1), smooth=st.booleans())
def test_uint8_bit_exact_hypothesis(h, w, log_k, seed, smooth):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if smooth:  # EM-like gradients, where rounding ties are likelier
        img = ((np.add.outer(np.arange(h), np.arange(w)) * 7) % 256).astype(np.uint8)
    np.testing.assert_array_equal(resize_by_factor(img, 2 ** log_k),
                                  jax_resize(img, 2 ** log_k))


def test_scale_one_is_identity_for_any_integer():
    img = np.arange(12, dtype=np.uint16).reshape(3, 4)
    assert resize_by_factor(img, 1) is img


def _other(rng, dtype, shape):
    if np.dtype(dtype).kind == "f":
        return (rng.random(shape) * rng.choice([1.0, 1000.0])).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32, np.float64, np.int32])
def test_other_dtypes_equal_cv2_or_raise(dtype):
    """Every dtype cv2 resizes equals it bit for bit at scales 2-64 (exact
    2x, odd sides and sides of 1 among the shapes); int32 raises in both
    packages, and the port's error names the dtype."""
    rng = np.random.default_rng(5)
    for h, w, k in list(_cases(25, 7)) + [(37, 53, 2), (1023, 1021, 2), (1024, 1024, 2)]:
        img = _other(rng, dtype, (h, w))
        if dtype == np.int32 and (-(-h // k), -(-w // k)) != (h, w):
            with pytest.raises(cv2.error):
                jax_resize(img, k)
            with pytest.raises(TypeError, match="int32"):
                resize_by_factor(img, k)
            continue
        got, want = resize_by_factor(img, k), jax_resize(img, k)
        assert got.dtype == want.dtype and got.shape == want.shape, (h, w, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, k)}")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_volume_dataset_scale_2_matches_jax(dtype):
    rng = np.random.default_rng(9)
    vol = rng.integers(0, np.iinfo(dtype).max, (5, 45, 70), dtype=dtype, endpoint=True)
    for axis in range(3):
        got = list(VolumeDataset(vol, axis, Preprocessor(**NORMS), scale=2, start=1))
        want = list(JaxVolumeDataset(vol, axis, JaxPreprocessor(**NORMS), scale=2, start=1))
        assert len(got) == len(want) == vol.shape[axis] - 1
        for g, w in zip(got, want):
            assert g["index"] == w["index"] and g["size"] == w["size"]
            np.testing.assert_array_equal(g["image"], w["image"])
