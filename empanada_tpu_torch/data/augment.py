"""Host-side augmentation pipeline without cv2 (counterpart of
``empanada_tpu/data/augment.py``).

The same transform vocabulary and calling convention
(``tf(image=..., mask=..., rng=...) -> {"image", "mask"}``, name dispatch
through ``create_augmentations``), and the same draws: one numpy
``default_rng(seed)`` is shared by the composed transforms, and each
transform draws what the JAX package's draws, in its order (the
``rng.random()`` of a skipped transform included), so one seed gives the
same parameters in both packages.

The JAX package calls cv2; its arithmetic is reproduced here in numpy:

- ``resize_linear`` (RandomScale's image): cv2 ``INTER_LINEAR``.  uint8
  in cv2's fixed point (11-bit weights, ``data/volume.py``) at any output
  size, bit for bit; other dtypes in cv2's float32 path (within one grey
  level of cv2 for uint16, 1e-5 relative for float32);
- ``resize_nearest`` (RandomScale's mask): cv2 ``INTER_NEAREST``, exact;
- ``warp_affine`` (Rotate): the image as cv2's float32 ``warpAffine``
  (coordinates and the two lerps as fused multiply-adds, the last columns
  of a row past a multiple of 16 in cv2's scalar form), the int32 mask as
  its ``INTER_NEAREST`` fixed point (``AB_BITS`` 10); border codes 0
  (constant 0), 1 (replicate), 2 (reflect) and 4 (reflect 101);
- ``gaussian_blur`` (GaussianBlur): cv2's bit-exact uint8 path (8-bit
  fixed-point kernels of 3, 5 or 7 taps, reflect-101 border), exact.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from empanada_tpu_torch.data.volume import factor_pad_numpy, linear_taps, resize_linear_u8

__all__ = ["Compose", "create_augmentations", "AUGMENTATIONS", "resize_linear",
           "resize_nearest", "rotation_matrix", "warp_affine", "gaussian_blur"]


# ----- cv2 arithmetic ------------------------------------------------------


def resize_linear(image: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(image, (w, h), INTER_LINEAR) of an (H, W) image."""
    if image.dtype == np.uint8:
        return resize_linear_u8(image, out_hw)
    # cv2's float path: float32 weights 1 - f and f, float32 sums
    (h, w), (nh, nw) = image.shape, out_hw
    x0, x1, fa0, fa1 = linear_taps(w, nw, clamp_fraction=True, float_weights=True)
    y0, y1, fb0, fb1 = linear_taps(h, nh, clamp_fraction=False, float_weights=True)
    src = image.astype(np.float32)
    rows = src[:, x0] * fa0 + src[:, x1] * fa1
    out = rows[y0] * fb0[:, None] + rows[y1] * fb1[:, None]
    return _store(out, image.dtype)


def _store(values: np.ndarray, dtype) -> np.ndarray:
    """cv2's saturate_cast from float32: round half to even and clip for
    integer types, as is for floats."""
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(values), info.min, info.max).astype(dtype)
    return values.astype(dtype)


def resize_nearest(mask: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(mask, (w, h), INTER_NEAREST): source index
    ``min(floor(i * in / out), in - 1)`` with the ratio in double."""
    (h, w), (nh, nw) = mask.shape, out_hw
    sy = np.minimum(np.floor(np.arange(nh) * (1.0 / (nh / h))).astype(np.int64), h - 1)
    sx = np.minimum(np.floor(np.arange(nw) * (1.0 / (nw / w))).astype(np.int64), w - 1)
    return mask[sy][:, sx]


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, ``angle`` in degrees,
    counter-clockwise; the centre is rounded to float32 as cv2's Point2f."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> list:
    """warpAffine's inverse of the forward map ``m`` (in double)."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _border(idx: np.ndarray, n: int, mode: int) -> np.ndarray:
    """cv2's borderInterpolate of indices; -1 marks BORDER_CONSTANT."""
    if mode == 0:
        return np.where((idx >= 0) & (idx < n), idx, -1)
    if mode == 1 or n == 1:
        return np.clip(idx, 0, n - 1)
    delta = 1 if mode == 4 else 0
    idx = idx.copy()
    while True:
        out = (idx < 0) | (idx >= n)
        if not out.any():
            return idx
        lo = idx < 0
        idx[lo] = -idx[lo] - 1 + delta
        hi = idx >= n
        idx[hi] = n - 1 - (idx[hi] - n) - delta


def _taps(image, iy, ix, mode, border_value):
    y = _border(iy, image.shape[0], mode)
    x = _border(ix, image.shape[1], mode)
    ok = (y >= 0) & (x >= 0)
    v = np.full(iy.shape, border_value, np.float32)
    v[ok] = image[y[ok], x[ok]]
    return v


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


WARP_VECTOR = 16  # pixels of a row that cv2's vector loop takes at a time


def warp_affine(image: np.ndarray, m: np.ndarray, nearest: bool = False,
                border_mode: int = 0, border_value=0) -> np.ndarray:
    """cv2.warpAffine(image, m, (w, h), INTER_LINEAR or INTER_NEAREST,
    borderMode, borderValue) of an (H, W) image onto its own size."""
    h, w = image.shape
    mi = _invert_affine(m)
    if nearest:
        ab = 1 << 10  # AB_BITS
        x0 = np.rint([(mi[1] * y + mi[2]) * ab for y in range(h)]).astype(np.int64) + ab // 2
        y0 = np.rint([(mi[4] * y + mi[5]) * ab for y in range(h)]).astype(np.int64) + ab // 2
        adelta = np.rint([mi[0] * x * ab for x in range(w)]).astype(np.int64)
        bdelta = np.rint([mi[3] * x * ab for x in range(w)]).astype(np.int64)
        sx = (x0[:, None] + adelta[None]) >> 10
        sy = (y0[:, None] + bdelta[None]) >> 10
        y = _border(sy, h, border_mode)
        x = _border(sx, w, border_mode)
        ok = (y >= 0) & (x >= 0)
        out = np.full((h, w), border_value, dtype=image.dtype)
        out[ok] = image[y[ok], x[ok]]
        return out
    m32 = np.asarray(mi, np.float64).astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None], (h, w))
    vec = (w // WARP_VECTOR) * WARP_VECTOR
    coords = []
    for c0, c1, c2 in ((m32[0], m32[1], m32[2]), (m32[3], m32[4], m32[5])):
        row = (ys * c1 + c2).astype(np.float32)  # per row, two roundings
        s = _fma(c0, xs, np.broadcast_to(row, (h, w)))
        tail = (_fma(xs[:, vec:], c0, np.broadcast_to((ys * c1).astype(np.float32),
                                                      (h, w - vec))) + c2)
        s[:, vec:] = tail.astype(np.float32)
        coords.append(s)
    sx, sy = coords
    ix = np.floor(sx).astype(np.int64)
    iy = np.floor(sy).astype(np.int64)
    a = (sx - ix.astype(np.float32)).astype(np.float32)
    b = (sy - iy.astype(np.float32)).astype(np.float32)
    p00 = _taps(image, iy, ix, border_mode, border_value)
    p01 = _taps(image, iy, ix + 1, border_mode, border_value)
    p10 = _taps(image, iy + 1, ix, border_mode, border_value)
    p11 = _taps(image, iy + 1, ix + 1, border_mode, border_value)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return _store(_fma(b, v1 - v0, v0), image.dtype)


_SMALL_GAUSSIAN = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                   7: (8, 28, 56, 72, 56, 28, 8)}


def gaussian_blur(image: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(image, (k, k), 0) of a uint8 (H, W) image, k in
    {3, 5, 7}: cv2's bit-exact fixed point, kernels in units of 2^-8,
    reflect-101 border, the two passes summed exactly and rounded once."""
    if image.dtype != np.uint8 or ksize not in _SMALL_GAUSSIAN:
        raise NotImplementedError(
            f"gaussian_blur of a {image.dtype} image at ksize {ksize}: only uint8 "
            f"at {sorted(_SMALL_GAUSSIAN)} reproduces cv2 bit for bit")
    kern = np.array(_SMALL_GAUSSIAN[ksize], np.int64)
    r = ksize // 2
    h, w = image.shape
    src = np.pad(image.astype(np.int64), r, mode="reflect")
    rows = sum(kern[i] * src[:, i:i + w] for i in range(ksize))
    out = sum(kern[i] * rows[i:i + h] for i in range(ksize))
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


# ----- transforms ----------------------------------------------------------


class _Transform:
    def __call__(self, image, mask=None, rng=None):
        raise NotImplementedError


class Compose:
    """The transforms in order, sharing one ``default_rng(seed)``."""

    def __init__(self, transforms, seed: Optional[int] = None):
        self.transforms = transforms
        self.rng = np.random.default_rng(seed)

    def __call__(self, image, mask=None):
        for tf in self.transforms:
            out = tf(image=image, mask=mask, rng=self.rng)
            image = out["image"]
            mask = out.get("mask", mask)
        out = {"image": image}
        if mask is not None:
            out["mask"] = mask
        return out


class RandomScale(_Transform):
    def __init__(self, scale_limit=(-0.9, 1.0), p=0.5):
        self.scale_limit = scale_limit
        self.p = p

    def __call__(self, image, mask=None, rng=None):
        if rng.random() > self.p:
            return {"image": image, "mask": mask}
        scale = 1.0 + rng.uniform(*self.scale_limit)
        h, w = image.shape[:2]
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        image = resize_linear(image, (nh, nw))
        if mask is not None:
            mask = resize_nearest(mask.astype(np.int32), (nh, nw))
        return {"image": image, "mask": mask}


# cv2 border codes -> np.pad modes (configs give the cv2 integers)
_BORDER_MODES = {
    0: "constant",    # cv2.BORDER_CONSTANT
    1: "edge",        # cv2.BORDER_REPLICATE
    2: "symmetric",   # cv2.BORDER_REFLECT
    4: "reflect",     # cv2.BORDER_REFLECT_101
}


class PadIfNeeded(_Transform):
    def __init__(self, min_height, min_width, border_mode=0, p=1.0):
        self.min_height = min_height
        self.min_width = min_width
        if border_mode not in _BORDER_MODES:
            raise ValueError(f"unsupported border_mode {border_mode}; "
                             f"supported cv2 codes: {sorted(_BORDER_MODES)}")
        self.border_mode = border_mode

    def __call__(self, image, mask=None, rng=None):
        h, w = image.shape[:2]
        pb = max(0, self.min_height - h)
        pr = max(0, self.min_width - w)
        pt, pl = pb // 2, pr // 2
        pad = ((pt, pb - pt), (pl, pr - pl))
        mode = _BORDER_MODES[self.border_mode]
        image = np.pad(image, pad, mode=mode)
        if mask is not None:
            mask = np.pad(mask, pad, mode=mode)
        return {"image": image, "mask": mask}


class RandomCrop(_Transform):
    def __init__(self, height, width, p=1.0):
        self.height = height
        self.width = width

    def __call__(self, image, mask=None, rng=None):
        h, w = image.shape[:2]
        assert h >= self.height and w >= self.width, "pad before cropping"
        y = int(rng.integers(0, h - self.height + 1))
        x = int(rng.integers(0, w - self.width + 1))
        image = image[y:y + self.height, x:x + self.width]
        if mask is not None:
            mask = mask[y:y + self.height, x:x + self.width]
        return {"image": image, "mask": mask}


class CenterCrop(_Transform):
    def __init__(self, height, width, p=1.0):
        self.height = height
        self.width = width

    def __call__(self, image, mask=None, rng=None):
        h, w = image.shape[:2]
        assert h >= self.height and w >= self.width, "pad before cropping"
        y = (h - self.height) // 2
        x = (w - self.width) // 2
        image = image[y:y + self.height, x:x + self.width]
        if mask is not None:
            mask = mask[y:y + self.height, x:x + self.width]
        return {"image": image, "mask": mask}


class Rotate(_Transform):
    def __init__(self, limit=180, border_mode=0, p=0.5):
        self.limit = limit
        self.p = p
        if border_mode not in _BORDER_MODES:
            raise ValueError(f"unsupported border_mode {border_mode}; "
                             f"supported cv2 codes: {sorted(_BORDER_MODES)}")
        self.border_mode = border_mode

    def __call__(self, image, mask=None, rng=None):
        if rng.random() > self.p:
            return {"image": image, "mask": mask}
        angle = float(rng.uniform(-self.limit, self.limit))
        h, w = image.shape[:2]
        m = rotation_matrix((w / 2, h / 2), angle, 1.0)
        image = warp_affine(image, m, border_mode=self.border_mode)
        if mask is not None:
            mask = warp_affine(mask.astype(np.int32), m, nearest=True,
                               border_mode=self.border_mode)
        return {"image": image, "mask": mask}


class RandomBrightnessContrast(_Transform):
    def __init__(self, brightness_limit=0.3, contrast_limit=0.3, p=0.5):
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.p = p

    def __call__(self, image, mask=None, rng=None):
        if rng.random() > self.p:
            return {"image": image, "mask": mask}
        alpha = 1.0 + float(rng.uniform(-self.contrast_limit, self.contrast_limit))
        beta = float(rng.uniform(-self.brightness_limit, self.brightness_limit))
        img = image.astype(np.float32)
        floating = np.issubdtype(image.dtype, np.floating)
        scale = 1.0 if floating else float(np.iinfo(image.dtype).max)
        img = img * alpha + beta * scale
        if not floating:
            img = np.clip(img, 0, scale)
        return {"image": img.astype(image.dtype), "mask": mask}


class HorizontalFlip(_Transform):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, image, mask=None, rng=None):
        if rng.random() <= self.p:
            image = image[:, ::-1].copy()
            if mask is not None:
                mask = mask[:, ::-1].copy()
        return {"image": image, "mask": mask}


class VerticalFlip(_Transform):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, image, mask=None, rng=None):
        if rng.random() <= self.p:
            image = image[::-1].copy()
            if mask is not None:
                mask = mask[::-1].copy()
        return {"image": image, "mask": mask}


class GaussianBlur(_Transform):
    def __init__(self, blur_limit=(3, 7), p=0.5):
        self.blur_limit = blur_limit
        self.p = p

    def __call__(self, image, mask=None, rng=None):
        if rng.random() > self.p:
            return {"image": image, "mask": mask}
        k = int(rng.integers(self.blur_limit[0] // 2, self.blur_limit[1] // 2 + 1)) * 2 + 1
        return {"image": gaussian_blur(image, k), "mask": mask}


class GaussNoise(_Transform):
    def __init__(self, var_limit=(10.0, 50.0), p=0.5):
        self.var_limit = var_limit
        self.p = p

    def __call__(self, image, mask=None, rng=None):
        if rng.random() > self.p:
            return {"image": image, "mask": mask}
        sigma = math.sqrt(float(rng.uniform(*self.var_limit)))
        if np.issubdtype(image.dtype, np.floating):
            # var_limit is on the 0-255 scale: scaled to a [0, 1] image
            noise = rng.normal(0, sigma / 255.0, image.shape[:2])
            img = np.clip(image.astype(np.float32) + noise, 0.0, 1.0)
        else:
            noise = rng.normal(0, sigma, image.shape[:2])
            img = np.clip(image.astype(np.float32) + noise, 0, np.iinfo(image.dtype).max)
        return {"image": img.astype(image.dtype), "mask": mask}


class FactorPad(_Transform):
    def __init__(self, factor=128, p=1.0):
        self.factor = factor

    def __call__(self, image, mask=None, rng=None):
        image = factor_pad_numpy(image, self.factor)
        if mask is not None:
            mask = factor_pad_numpy(mask, self.factor)
        return {"image": image, "mask": mask}


class Normalize(_Transform):
    """(image - mean max) / (std max), max the dtype's maximum (1 for
    floats): the inference preprocessing."""

    def __init__(self, mean=0.5, std=0.2, p=1.0):
        self.mean = mean
        self.std = std

    def __call__(self, image, mask=None, rng=None):
        maxv = 1.0 if np.issubdtype(image.dtype, np.floating) else float(
            np.iinfo(image.dtype).max)
        image = (image.astype(np.float32) - self.mean * maxv) / (self.std * maxv)
        return {"image": image, "mask": mask}


AUGMENTATIONS = {
    "RandomScale": RandomScale,
    "PadIfNeeded": PadIfNeeded,
    "RandomCrop": RandomCrop,
    "CenterCrop": CenterCrop,
    "Rotate": Rotate,
    "RandomBrightnessContrast": RandomBrightnessContrast,
    "HorizontalFlip": HorizontalFlip,
    "VerticalFlip": VerticalFlip,
    "GaussianBlur": GaussianBlur,
    "GaussNoise": GaussNoise,
    "FactorPad": FactorPad,
    "Normalize": Normalize,
}


def create_augmentations(aug_specs, seed: Optional[int] = None) -> Compose:
    """Name-dispatch a config list like
    ``[{"aug": "RandomCrop", "height": 256, "width": 256}, ...]``."""
    tfs = []
    for spec in aug_specs:
        spec = dict(spec)
        name = spec.pop("aug")
        tfs.append(AUGMENTATIONS[name](**spec))
    return Compose(tfs, seed=seed)
