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

- ``resize_linear`` (RandomScale's image): cv2 ``INTER_LINEAR`` at any
  output size, bit for bit for every dtype cv2 resizes (``data/volume.py``,
  the one routine the volume downsample also runs);
- ``resize_nearest`` (RandomScale's mask): cv2 ``INTER_NEAREST``, exact;
- ``warp_affine`` (Rotate): uint8, uint16 and float32 images as cv2's
  float32 ``warpAffine`` (coordinates and the two lerps as fused
  multiply-adds, the last columns of a row past a multiple of 16 in cv2's
  scalar form), int16 images as its fixed-point remap (1/32-pixel
  coordinates, float32 bilinear weights), the int32 mask as its
  ``INTER_NEAREST`` fixed point (``AB_BITS`` 10); border codes 0
  (constant 0), 1 (replicate), 2 (reflect) and 4 (reflect 101);
- ``gaussian_blur`` (GaussianBlur): cv2's 3-, 5- and 7-tap kernels with
  reflect-101 borders, bit for bit: uint8 and uint16 in cv2's fixed point
  (exact sums, rounded half up once), int16 and float32 in its float32
  separable filter (the row pass, then the column pass, each as cv2's
  vector code orders and fuses it; int16 rounded half to even), float64
  in its float64 one (rows fused in loops of four pixels, columns not).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from empanada_tpu_torch.data.volume import (factor_pad_numpy, fma32, fma64,
                                             resize_linear, saturate_cast)

__all__ = ["Compose", "create_augmentations", "AUGMENTATIONS", "resize_linear",
           "resize_nearest", "rotation_matrix", "warp_affine", "gaussian_blur"]


# ----- cv2 arithmetic ------------------------------------------------------


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


WARP_VECTOR = 16  # pixels of a row that cv2's vector loop takes at a time


def _fixed_coords(mi: list, h: int, w: int, round_delta: int):
    """warpAffine's fixed-point source coordinates (``AB_BITS`` 10) of every
    output pixel, plus ``round_delta``, in units of 2^-10."""
    ab = 1 << 10
    x0 = np.rint([(mi[1] * y + mi[2]) * ab for y in range(h)]).astype(np.int64) + round_delta
    y0 = np.rint([(mi[4] * y + mi[5]) * ab for y in range(h)]).astype(np.int64) + round_delta
    adelta = np.rint([mi[0] * x * ab for x in range(w)]).astype(np.int64)
    bdelta = np.rint([mi[3] * x * ab for x in range(w)]).astype(np.int64)
    return x0[:, None] + adelta[None], y0[:, None] + bdelta[None]


def warp_affine(image: np.ndarray, m: np.ndarray, nearest: bool = False,
                border_mode: int = 0, border_value=0) -> np.ndarray:
    """cv2.warpAffine(image, m, (w, h), INTER_LINEAR or INTER_NEAREST,
    borderMode, borderValue) of an (H, W) image onto its own size."""
    h, w = image.shape
    mi = _invert_affine(m)
    if nearest:
        sx, sy = (c >> 10 for c in _fixed_coords(mi, h, w, 1 << 9))
        y = _border(sy, h, border_mode)
        x = _border(sx, w, border_mode)
        ok = (y >= 0) & (x >= 0)
        out = np.full((h, w), border_value, dtype=image.dtype)
        out[ok] = image[y[ok], x[ok]]
        return out
    if image.dtype == np.int16:
        # cv2's remap of 16S: coordinates in 1/32 pixel (INTER_BITS 5), the
        # float32 bilinear table, the four taps summed in order
        cx, cy = (c >> 5 for c in _fixed_coords(mi, h, w, 1 << 4))
        sx, sy = cx >> 5, cy >> 5
        fx = (cx & 31).astype(np.float32) * np.float32(1 / 32)
        fy = (cy & 31).astype(np.float32) * np.float32(1 / 32)
        one = np.float32(1)
        out = (_taps(image, sy, sx, border_mode, border_value) * ((one - fy) * (one - fx))
               + _taps(image, sy, sx + 1, border_mode, border_value) * ((one - fy) * fx)
               + _taps(image, sy + 1, sx, border_mode, border_value) * (fy * (one - fx))
               + _taps(image, sy + 1, sx + 1, border_mode, border_value) * (fy * fx))
        return saturate_cast(out, np.int16)
    m32 = np.asarray(mi, np.float64).astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None], (h, w))
    vec = (w // WARP_VECTOR) * WARP_VECTOR
    coords = []
    for c0, c1, c2 in ((m32[0], m32[1], m32[2]), (m32[3], m32[4], m32[5])):
        row = (ys * c1 + c2).astype(np.float32)  # per row, two roundings
        s = fma32(c0, xs, np.broadcast_to(row, (h, w)))
        tail = (fma32(xs[:, vec:], c0, np.broadcast_to((ys * c1).astype(np.float32),
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
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    return saturate_cast(fma32(b, v1 - v0, v0), image.dtype)


# cv2's small Gaussian kernels (sigma 0) in units of 2^-8
_SMALL_GAUSSIAN = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                   7: (8, 28, 56, 72, 56, 28, 8)}
BLUR_DTYPES = (np.uint8, np.uint16, np.int16, np.float32, np.float64)


def _vector_width(w: int) -> int:
    """The pixels of a row of ``w`` that cv2's float32 filter loops take in
    vectors: 16 at a time, then 8 once."""
    vec = w // 16 * 16
    return vec + 8 if w - vec >= 8 else vec


def _blur_rows_f32(s: list, k: list, w: int) -> np.ndarray:
    """cv2's float32 row pass over the shifted rows ``s`` (one a tap).  Its
    vector loops (``_vector_width``) fuse the multiply-adds; of the pixels
    past them the 5-tap filter takes pairs (fused) and a last single one
    (not fused), the 7-tap filter fours (fused) and single ones (the sixth
    tap fused, the others not)."""
    n = len(s)
    if n == 3:  # every product exact: the order is all there is
        return s[1] * k[1] + (s[0] + s[2]) * k[0]
    if n == 5:
        def row(t, fused):
            centre = (fma32(t[2], k[2], (t[1] + t[3]) * k[1]) if fused
                      else t[2] * k[2] + (t[1] + t[3]) * k[1])
            return centre + (t[0] + t[4]) * k[0]
        step = 2
    else:
        def row(t, fused):
            # cv2's single pixels fuse only the sixth tap
            out = t[0] * k[0]
            for i in range(1, n):
                out = fma32(t[i], k[i], out) if fused or i == 5 else out + t[i] * k[i]
            return out
        step = 4
    out = row(s, True)
    vec = _vector_width(w)
    plain = vec + (w - vec) // step * step
    if plain < w:
        out[:, plain:] = row([t[:, plain:] for t in s], False)
    return out


def _blur_columns(rows: np.ndarray, k: list, h: int, w: int) -> np.ndarray:
    """cv2's symmetric float32 column pass: fused in its vector loops
    (``_vector_width``), not fused past them."""
    n = len(k)
    r = n // 2
    t = [rows[i:i + h] for i in range(n)]

    def col(t, fused):
        out = t[r] * k[r]
        for j in range(1, r + 1):
            out = (fma32(t[r + j] + t[r - j], k[r + j], out) if fused
                   else out + (t[r + j] + t[r - j]) * k[r + j])
        return out
    out = col(t, True)
    vec = _vector_width(w)
    if vec < w:
        out[:, vec:] = col([v[:, vec:] for v in t], False)
    return out


def _blur_rows_f64(s: list, k: list, w: int) -> np.ndarray:
    """cv2's float64 row pass over the shifted rows ``s``: its loop of four
    pixels sums the taps in order, fused; the pixels past it, not fused."""
    out = s[0] * k[0]
    for i in range(1, len(s)):
        out = fma64(s[i], k[i], out)
    vec = w // 4 * 4
    if vec < w:
        tail = s[0][:, vec:] * k[0]
        for i in range(1, len(s)):
            tail = tail + s[i][:, vec:] * k[i]
        out[:, vec:] = tail
    return out


def gaussian_blur(image: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(image, (k, k), 0) of an (H, W) image, k in {3, 5,
    7}, bit for bit (module docstring)."""
    if image.dtype not in BLUR_DTYPES or ksize not in _SMALL_GAUSSIAN:
        raise NotImplementedError(
            f"gaussian_blur of a {image.dtype} image at ksize {ksize}: cv2's arithmetic is "
            f"reproduced for {', '.join(np.dtype(d).name for d in BLUR_DTYPES)} at "
            f"{sorted(_SMALL_GAUSSIAN)}")
    kern = _SMALL_GAUSSIAN[ksize]
    r = ksize // 2
    h, w = image.shape
    ys = _border(np.arange(-r, h + r), h, 4)
    xs = _border(np.arange(-r, w + r), w, 4)
    if image.dtype == np.float64:
        # cv2's float64 filter: rows as _blur_rows_f64, then the symmetric
        # column pass unfused; a line of pixels along its length only
        k = [v / 256 for v in kern]
        if h == 1 and w == 1:
            return image.copy()
        if h > 1:
            src = image[ys][:, xs] if w > 1 else image[ys]
            rows = _blur_rows_f64([src[:, i:i + w] for i in range(ksize)], k, w) if w > 1 \
                else src
            t = [rows[i:i + h] for i in range(ksize)]
            out = t[r] * k[r]
            for j in range(1, r + 1):
                out = out + (t[r + j] + t[r - j]) * k[r + j]
            return out
        src = image[:, xs]
        return _blur_rows_f64([src[:, i:i + w] for i in range(ksize)], k, w)
    k = [np.float32(v / 256) for v in kern]
    if image.dtype == np.float32:
        if h == 1 or w == 1:
            # cv2 filters a line of pixels along its length only
            if w > 1:
                src = image[:, xs]
                return _blur_rows_f32([src[:, i:i + w] for i in range(ksize)], k, w)
            return _blur_columns(image[ys], k, h, 1) if h > 1 else image.copy()
        src = image[ys][:, xs]
        rows = _blur_rows_f32([src[:, i:i + w] for i in range(ksize)], k, w)
        if ksize == 3:  # cv2's 3-tap column filter: every product exact
            return (rows[:-2] + rows[2:]) * k[0] + rows[1:-1] * k[1]
        return _blur_columns(rows, k, h, w)
    src = image.astype(np.int64)[ys][:, xs]
    rows = sum(kern[i] * src[:, i:i + w] for i in range(ksize))
    if image.dtype == np.int16:
        # cv2 filters int16 in float32; its row sums are exact
        out = _blur_columns((rows / 256.0).astype(np.float32), k, h, w)
        return np.clip(np.rint(out), -32768, 32767).astype(np.int16)
    # uint8, uint16: cv2's fixed point, the exact sum in units of 2^-16
    # rounded half up
    out = sum(kern[i] * rows[i:i + h] for i in range(ksize))
    return ((out + (1 << 15)) >> 16).astype(image.dtype)


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
