"""Resize and sampling ops with explicit align-corners semantics
(counterpart of ``empanada_tpu/ops/interpolate.py``).

Public functions take NHWC tensors, as the JAX package's do.  Bilinear
resizes are separable two-tap passes (height, then width): each pass
computes in float32 and rounds to the input dtype, which is what the JAX
package's two interpolation-matrix einsums do for bf16 input.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bilinear_resize",
    "bilinear_resize_nchw",
    "grid_sample",
    "nearest_resize",
    "point_sample",
    "point_sample_packed",
    "resize_taps",
]


def resize_taps(in_size: int, out_size: int, align_corners: bool,
                zeros_padding: bool = False):
    """1-D bilinear taps: ``out[o] = w0[o] * x[i0[o]] + w1[o] * x[i1[o]]``.

    The same source positions and weights as the JAX package's dense
    interpolation matrices.  ``zeros_padding`` lets an out-of-range tap
    contribute 0 (grid_sample's zero padding) instead of clamping the
    source position to the border.
    """
    out_pos = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = out_pos * (in_size - 1) / (out_size - 1)
    else:
        src = (out_pos + 0.5) * (in_size / out_size) - 0.5
    if not zeros_padding:
        src = np.clip(src, 0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    w1 = (src - i0).astype(np.float32)
    w0 = np.float32(1.0) - w1
    i1 = i0 + 1
    ok0 = (i0 >= 0) & (i0 < in_size)
    ok1 = (i1 >= 0) & (i1 < in_size)
    w0 = np.where(ok0, w0, np.float32(0.0)).astype(np.float32)
    w1 = np.where(ok1, w1, np.float32(0.0)).astype(np.float32)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.clip(i1, 0, in_size - 1)
    return i0, i1, w0, w1


def _resize_axis(x: torch.Tensor, axis: int, out_size: int, align_corners: bool,
                 zeros_padding: bool) -> torch.Tensor:
    i0, i1, w0, w1 = resize_taps(x.shape[axis], out_size, align_corners,
                                 zeros_padding)
    dev = x.device
    shape = [1] * x.ndim
    shape[axis] = out_size
    w0 = torch.from_numpy(w0).to(dev).view(shape)
    w1 = torch.from_numpy(w1).to(dev).view(shape)
    a = x.index_select(axis, torch.from_numpy(i0).to(dev)).float()
    b = x.index_select(axis, torch.from_numpy(i1).to(dev)).float()
    return (a * w0 + b * w1).to(x.dtype)


def _resize(x, axes, out_hw, align_corners, zeros_padding):
    for axis, size in zip(axes, out_hw):
        if x.shape[axis] != size:
            x = _resize_axis(x, axis, int(size), align_corners, zeros_padding)
    return x


def bilinear_resize(x: torch.Tensor, out_hw, align_corners: bool = False,
                    zeros_padding: bool = False) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to ``out_hw``."""
    return _resize(x, (1, 2), out_hw, align_corners, zeros_padding)


def bilinear_resize_nchw(x: torch.Tensor, out_hw, align_corners: bool = False,
                         zeros_padding: bool = False) -> torch.Tensor:
    """``bilinear_resize`` for the models' internal NCHW tensors."""
    return _resize(x, (2, 3), out_hw, align_corners, zeros_padding)


def nearest_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of an NHWC tensor: source index floor(i * in / out)."""
    h, w = x.shape[1], x.shape[2]
    out_h, out_w = out_hw
    if (out_h, out_w) == (h, w):
        return x
    iy = np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64)
    ix = np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64)
    x = x.index_select(1, torch.from_numpy(iy).to(x.device))
    return x.index_select(2, torch.from_numpy(ix).to(x.device))


def _bilinear_gather(features, px, py, corner):
    """Sample NHWC ``features`` at float pixel coords (N, P) with zero
    padding; ``corner(iy, ix)`` returns the (N, P, C) values of one tap."""
    ix0 = torch.floor(px).to(torch.int64)
    iy0 = torch.floor(py).to(torch.int64)
    wx = (px - ix0.to(px.dtype)).to(features.dtype)[..., None]
    wy = (py - iy0.to(py.dtype)).to(features.dtype)[..., None]
    v00 = corner(iy0, ix0)
    v01 = corner(iy0, ix0 + 1)
    v10 = corner(iy0 + 1, ix0)
    v11 = corner(iy0 + 1, ix0 + 1)
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )


def _corner_fn(features):
    n, h, w, c = features.shape
    flat = features.reshape(n, h * w, c)

    def corner(iy, ix):
        valid = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * valid[..., None].to(features.dtype)

    return corner


def grid_sample(features: torch.Tensor, coords: torch.Tensor, mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Sample NHWC ``features`` at normalized (x, y) coords in [-1, 1]
    (N, P, 2) with zero padding -> (N, P, C).  ``mode="nearest"`` takes the
    pixel whose centre is nearest, rounding half to even, as the JAX
    package's ``grid_sample`` does.  Both modes carry gradients to
    ``features``."""
    n, h, w, c = features.shape

    def to_pix(v, size):
        if align_corners:
            return (v + 1.0) * (size - 1) / 2.0
        return ((v + 1.0) * size - 1.0) / 2.0

    px = to_pix(coords[..., 0], w)
    py = to_pix(coords[..., 1], h)
    if mode == "nearest":
        return _corner_fn(features)(torch.round(py).to(torch.int64),
                                    torch.round(px).to(torch.int64))
    if mode != "bilinear":
        raise ValueError(f"grid_sample mode {mode!r}: expected 'bilinear' or 'nearest'")
    return _bilinear_gather(features, px, py, _corner_fn(features))


def point_sample(features: torch.Tensor, point_coords: torch.Tensor,
                 mode: str = "bilinear", align_corners: bool = False) -> torch.Tensor:
    """``grid_sample`` at (x, y) coords in [0, 1] (N, P, 2)."""
    return grid_sample(features, 2.0 * point_coords - 1.0, mode=mode,
                       align_corners=align_corners)


def point_sample_packed(features: torch.Tensor, point_coords: torch.Tensor) -> torch.Tensor:
    """``point_sample`` for coords in [0, 1] (grid pixel centers): a plain
    four-corner gather.  The JAX package packs the corners into one wide
    row because TPU gathers pay per gather; a GPU gather does not."""
    return point_sample(features, point_coords)
