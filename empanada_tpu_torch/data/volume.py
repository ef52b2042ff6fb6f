"""Volume slicing dataset + pad helper (counterpart of
``empanada_tpu/data/volume.py``).

Slices are taken along an axis of a numpy array (or any array-like with
numpy-style indexing, such as ``core.chunked.ChunkedArray``), downsampled
by a power-of-two ``scale`` and normalised by the given preprocessor.  The
JAX package downsamples with cv2's bilinear resize; the port does not
depend on cv2 and computes cv2's fixed-point arithmetic for uint8 in numpy,
bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

from empanada_tpu_torch.core.masks import take

__all__ = ["linear_taps", "resize_linear_u8", "resize_by_factor", "factor_pad_numpy",
           "VolumeDataset"]


# cv2's fixed-point resize: weights in units of 2^-11
_COEF_SCALE = 2048


def linear_taps(n_in: int, n_out: int, clamp_fraction: bool = True,
                float_weights: bool = False):
    """cv2 ``INTER_LINEAR`` taps of one axis: for each output index the two
    source indices and their integer weights.  The source position is
    computed in double and rounded to float32, its fraction ``f`` in
    float32; the weights are ``round(2048 (1 - f))`` and ``round(2048 f)``
    (half to even) and the indices clamp into the source.  Along x
    (``clamp_fraction``) a position before the first or past the last
    source pixel also takes ``f = 0``; along y cv2 keeps its fraction.
    ``float_weights`` gives the weights as cv2's float path keeps them:
    float32 ``1 - f`` and ``f``."""
    scale = 1.0 / (n_out / n_in)
    pos = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    f = pos - i0.astype(np.float32)
    if clamp_fraction:
        f[(i0 < 0) | (i0 >= n_in - 1)] = 0
    w0, w1 = np.float32(1) - f, f
    if not float_weights:
        w0 = np.rint(w0 * np.float32(_COEF_SCALE)).astype(np.int64)
        w1 = np.rint(w1 * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w0, w1


def resize_linear_u8(image: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(image, (w, h), INTER_LINEAR) of a uint8 (H, W) image at
    any output size, bit for bit: an integer horizontal pass with 11-bit
    weights, then cv2's vertical pass ``((b0 (r0 >> 4)) >> 16) +
    ((b1 (r1 >> 4)) >> 16) + 2 >> 2``."""
    (h, w), (nh, nw) = image.shape, out_hw
    x0, x1, a0, a1 = linear_taps(w, nw, clamp_fraction=True)
    y0, y1, b0, b1 = linear_taps(h, nh, clamp_fraction=False)
    src = image.astype(np.int64)
    rows = src[:, x0] * a0 + src[:, x1] * a1                 # (h, nw)
    out = (((b0[:, None] * (rows[y0] >> 4)) >> 16)
           + ((b1[:, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_by_factor(image: np.ndarray, scale_factor: int = 1) -> np.ndarray:
    """Bilinear downsample of an (H, W) uint8 image to (ceil(H / s),
    ceil(W / s)), bit-identical to the JAX package's ``cv2.resize(...,
    INTER_LINEAR)`` (``resize_linear_u8``).  Other dtypes take cv2's float
    path, which this does not reproduce, and raise at a scale above 1."""
    if scale_factor == 1:
        return image
    if image.dtype != np.uint8:
        raise NotImplementedError(
            f"resize_by_factor of a {image.dtype} image: only uint8 is bit-identical "
            "to the JAX package's cv2 resize; scale 1 takes any integer dtype")
    h, w = image.shape
    dh, dw = math.ceil(h / scale_factor), math.ceil(w / scale_factor)
    if (dh, dw) == (h, w):
        return image.copy()
    return resize_linear_u8(image, (dh, dw))


def factor_pad_numpy(image: np.ndarray, factor: int = 128) -> np.ndarray:
    """Bottom/right zero pad to a multiple of factor (transforms.py:23)."""
    h, w = image.shape[:2]
    pad_bottom = (-h) % factor
    pad_right = (-w) % factor
    if image.ndim == 3:
        padding = ((0, pad_bottom), (0, pad_right), (0, 0))
    elif image.ndim == 2:
        padding = ((0, pad_bottom), (0, pad_right))
    else:
        raise Exception(f"unsupported ndim {image.ndim}")
    return np.pad(image, padding)


class VolumeDataset:
    """Iterable of {'index', 'image', 'size'} slices along an axis."""

    def __init__(self, array, axis: int = 0, tfs=None, scale: int = 1,
                 start: int = 0):
        if not math.log2(scale).is_integer():
            raise Exception(f"Image rescaling must be log base 2, got {scale}")
        self.array = array
        self.axis = axis
        self.tfs = tfs
        self.scale = scale
        # first slice index the iteration yields
        self.start = start

    def __len__(self):
        return self.array.shape[self.axis]

    def __getitem__(self, idx: int) -> dict:
        # a ChunkedArray reads only the chunks the slice crosses
        image = np.asarray(take(self.array, idx, self.axis))
        h, w = image.shape
        image = resize_by_factor(image, self.scale)
        assert (image.shape[0] * self.scale) >= h
        assert (image.shape[1] * self.scale) >= w
        if self.tfs is not None:
            image = self.tfs(image=image)["image"]
        return {"index": idx, "image": image, "size": (h, w)}

    def __iter__(self):
        for idx in range(self.start, len(self)):
            yield self[idx]
