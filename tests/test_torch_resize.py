"""The port's ``resize_by_factor`` (cv2's bilinear downsample computed in
numpy) against the JAX package's, which calls ``cv2.resize(...,
INTER_LINEAR)``: uint8 bit for bit over a seeded grid of shapes 1-1100 px
and scales 2-64, and a hypothesis search; any other dtype either equals
cv2 or raises; ``VolumeDataset`` at scale 2 yields the JAX dataset's
slices."""

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


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_other_dtypes_equal_cv2_or_raise(dtype):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 1000, (37, 53)).astype(dtype)
    try:
        got = resize_by_factor(img, 2)
    except NotImplementedError as exc:
        assert np.dtype(dtype).name in str(exc)
        return
    np.testing.assert_array_equal(got, jax_resize(img, 2))


def test_volume_dataset_scale_2_matches_jax():
    rng = np.random.default_rng(9)
    vol = rng.integers(0, 256, (5, 45, 70), dtype=np.uint8)
    for axis in range(3):
        got = list(VolumeDataset(vol, axis, Preprocessor(**NORMS), scale=2, start=1))
        want = list(JaxVolumeDataset(vol, axis, JaxPreprocessor(**NORMS), scale=2, start=1))
        assert len(got) == len(want) == vol.shape[axis] - 1
        for g, w in zip(got, want):
            assert g["index"] == w["index"] and g["size"] == w["size"]
            np.testing.assert_array_equal(g["image"], w["image"])
