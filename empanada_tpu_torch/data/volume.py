"""Volume slicing dataset + pad helper (counterpart of
``empanada_tpu/data/volume.py``).

Slices are taken along an axis of a numpy array (or any array-like with
numpy-style indexing, such as ``core.chunked.ChunkedArray``), downsampled
by a power-of-two ``scale`` and normalised by the given preprocessor.  The
JAX package downsamples with ``cv2.resize(INTER_LINEAR)``; the port does
not depend on cv2 and computes its arithmetic in numpy, bit for bit, for
every dtype cv2 resizes (``resize_linear``):

- uint8: cv2's own fixed point (11-bit weights);
- uint16, int16, float32 and float64 images of at least 2 x 2 pixels: the
  Intel IPP linear resize that cv2 hands them to.  The source position is
  ``(d + 0.5) in / out - 0.5`` in double (one rounding for float64, two
  otherwise), each pass is the fused multiply-add ``a + f (b - a)``
  (float32 with ``f`` rounded to float32, or float64), rows before
  columns, integers rounded half to even.  Where a tap of an int16 image
  falls outside it (the border rows and columns), that pass is
  ``a + rint(f (b - a))`` on the source pixels instead;
- those dtypes with a side of 1 pixel: cv2's own float path (float32
  weights ``1 - f`` and ``f``, float32 sums, float64 for float64).

cv2 refuses every other dtype (int8, int32, float16, ...); so does the
port, naming it.
"""

from __future__ import annotations

import math

import numpy as np

from empanada_tpu_torch.core.masks import take

__all__ = ["linear_taps", "resize_linear_u8", "resize_linear", "resize_by_factor",
           "fma32", "fma64", "saturate_cast", "factor_pad_numpy", "VolumeDataset"]


# cv2's fixed-point resize: weights in units of 2^-11
_COEF_SCALE = 2048
# the dtypes cv2.resize takes
RESIZE_DTYPES = (np.uint8, np.uint16, np.int16, np.float32, np.float64)


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


# ----- correctly rounded fused multiply-add ---------------------------------


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a b + c`` rounded once, as a hardware FMA gives it.  The
    product of two float32 is exact in float64; the float64 sum rounds a
    second time, which can only go wrong where it lands on a float32
    midpoint (its low 29 mantissa bits exactly 1 << 28): there the sum's
    exact error picks the side."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32).astype(np.float64)
                                    for v in (a, b, c)))
    s = a * b + c
    out = s.astype(np.float32)
    mid = (s.view(np.int64) & ((1 << 29) - 1)) == (1 << 28)
    if mid.any():
        idx = np.nonzero(mid)
        err = _two_sum(a[idx] * b[idx], c[idx])[1]
        r = out[idx]
        below = r.astype(np.float64) < s[idx]
        r = np.where((err > 0) & below, np.nextafter(r, np.float32(np.inf)), r)
        r = np.where((err < 0) & ~below, np.nextafter(r, np.float32(-np.inf)), r)
        out[idx] = r
    return out


_SPLIT = 134217729.0  # 2^27 + 1, Dekker's splitter


def _two_prod(a, b):
    """(p, e) with p = fl(a b) and p + e = a b exactly (Dekker)."""
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    t = _SPLIT * b
    bh = t - (t - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a, b, c) -> np.ndarray:
    """float64 ``a b + c`` rounded once (Boldo and Melquiond's emulation:
    exact product and sums, the low part rounded to odd, then one rounding
    to nearest)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64) for v in (a, b, c)))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, ul)
    vh, vl = _two_sum(uh, th)
    z, e = _two_sum(tl, vl)
    odd = (e != 0) & ((z.view(np.int64) & 1) == 0)
    if odd.any():
        z = np.where(odd, np.nextafter(z, np.where(e > 0, np.inf, -np.inf)), z)
    return vh + z


# ----- cv2.resize(INTER_LINEAR) ---------------------------------------------


def _ipp_taps(n_in: int, n_out: int, once: bool):
    """IPP's linear taps of one axis: both source indices (clamped), the
    fraction in double and whether a tap lies outside the source.  The
    position ``(d + 0.5) n_in / n_out - 0.5`` is rounded once (``once``,
    the float64 path) or after the product and again after the sum."""
    if once:
        num, den = (n_in / n_out).as_integer_ratio()
        # (2d + 1) num / (2 den) - 1/2 as one correctly rounded division
        pos = np.array([((2 * d + 1) * num - den) / (2 * den) for d in range(n_out)])
    else:
        pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    outside = (i0 < 0) | (i0 >= n_in - 1)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), pos - i0, outside


def saturate_cast(values: np.ndarray, dtype) -> np.ndarray:
    """cv2's saturate_cast: round half to even and clip for integer types."""
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(values), info.min, info.max).astype(dtype)
    return values.astype(dtype)


def _resize_small(image: np.ndarray, out_hw) -> np.ndarray:
    """cv2's own float path (an image with a side of 1 pixel): float32
    weights 1 - f and f, float32 sums (float64 for a float64 image)."""
    (h, w), (nh, nw) = image.shape, out_hw
    x0, x1, a0, a1 = linear_taps(w, nw, clamp_fraction=True, float_weights=True)
    y0, y1, b0, b1 = linear_taps(h, nh, clamp_fraction=False, float_weights=True)
    wt = np.float64 if image.dtype == np.float64 else np.float32
    src = image.astype(wt)
    a0, a1, b0, b1 = (v.astype(wt) for v in (a0, a1, b0, b1))
    rows = src[:, x0] * a0 + src[:, x1] * a1
    return saturate_cast(rows[y0] * b0[:, None] + rows[y1] * b1[:, None], image.dtype)


def resize_linear(image: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(image, (w, h), INTER_LINEAR) of an (H, W) image of any
    dtype cv2 resizes, at any output size, bit for bit (module
    docstring)."""
    (h, w), (nh, nw) = image.shape, tuple(out_hw)
    if (nh, nw) == (h, w):
        return image.copy()
    if image.dtype == np.uint8:
        return resize_linear_u8(image, out_hw)
    if image.dtype not in RESIZE_DTYPES:
        raise TypeError(f"cv2.resize takes no {image.dtype} image (it takes "
                        f"{', '.join(np.dtype(d).name for d in RESIZE_DTYPES)})")
    if h == 1 or w == 1:
        return _resize_small(image, out_hw)
    if image.dtype == np.float64:
        x0, x1, fx, _ = _ipp_taps(w, nw, once=True)
        y0, y1, fy, _ = _ipp_taps(h, nh, once=True)
        a = image[:, x0]
        rows = fma64(fx, image[:, x1] - a, a)
        a = rows[y0]
        return fma64(fy[:, None], rows[y1] - a, a)
    x0, x1, fx, x_out = _ipp_taps(w, nw, once=False)
    y0, y1, fy, y_out = _ipp_taps(h, nh, once=False)
    fx, fy = fx.astype(np.float32), fy.astype(np.float32)
    src = image.astype(np.float32)
    a = src[:, x0]
    rows = fma32(fx, src[:, x1] - a, a)
    a = rows[y0]
    out = fma32(fy[:, None], rows[y1] - a, a)
    if image.dtype == np.int16:
        out = np.rint(out)
        # a tap outside the image: a + rint(f (b - a)) on the source pixels
        if y_out.any():
            r = src[y0[y_out]]
            a = r[:, x0]
            out[y_out] = a + np.rint((fx.astype(np.float64) * (r[:, x1] - a)).astype(np.float32))
        if x_out.any():
            c = src[:, x0[x_out]]
            a = c[y0]
            out[:, x_out] = a + np.rint(
                (fy[:, None].astype(np.float64) * (c[y1] - a)).astype(np.float32))
    return saturate_cast(out, image.dtype)


def resize_by_factor(image: np.ndarray, scale_factor: int = 1) -> np.ndarray:
    """Bilinear downsample of an (H, W) image to (ceil(H / s), ceil(W / s)),
    bit-identical to the JAX package's ``cv2.resize(..., INTER_LINEAR)``
    (``resize_linear``); a dtype cv2 refuses raises as it does."""
    if scale_factor == 1:
        return image
    h, w = image.shape
    return resize_linear(image, (math.ceil(h / scale_factor), math.ceil(w / scale_factor)))

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
