"""Training targets (counterpart of ``empanada_tpu/data/targets.py``):
Gaussian center heatmaps and per-pixel offsets for Panoptic-DeepLab, and
Sobel contour maps for the boundary-contour model.

The JAX package blurs the heatmap with cv2's float ``GaussianBlur``
(``ksize=(0, 0)``, ``BORDER_CONSTANT``); here it is a separable
correlation in float64 with cv2's kernel: ``cvRound(8 sigma + 1) | 1``
taps (49 at sigma 6) of ``exp(-x^2 / (2 sigma^2))`` normalised to sum 1,
rounded to float32.  The result agrees with cv2's float32 sums within
1e-6.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.signal import convolve2d

__all__ = ["gaussian_kernel", "gaussian_blur", "heatmap_and_offsets", "seg_to_instance_bd"]


def gaussian_kernel(sigma: float) -> np.ndarray:
    """cv2's ``getGaussianKernel`` at ``ksize = 0`` for a float image:
    ``cvRound(8 sigma + 1) | 1`` taps, float32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2
    v = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (v / v.sum()).astype(np.float32)


def gaussian_blur(image: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of a float (H, W) image with zero padding
    (cv2 ``BORDER_CONSTANT``), float32."""
    k = gaussian_kernel(sigma).astype(np.float64)
    out = ndimage.correlate1d(image.astype(np.float64), k, axis=1, mode="constant")
    return ndimage.correlate1d(out, k, axis=0, mode="constant").astype(np.float32)


def heatmap_and_offsets(sl2d: np.ndarray, heatmap_sigma: float = 6):
    """Instance seg (h, w) -> heatmap (h, w, 1) and offsets (h, w, 2).

    A 1 at each instance's centroid (truncated to integers), blurred with
    sigma ``heatmap_sigma`` and scaled to peak 1; offsets are (dy, dx) from
    each pixel to its own instance's centroid, zero outside instances.
    """
    h, w = sl2d.shape
    heatmap = np.zeros((h, w), dtype=np.float32)
    centers = np.zeros((2, h, w), dtype=np.float32)

    labels = np.unique(sl2d)
    labels = labels[labels > 0]
    if len(labels):
        coms = ndimage.center_of_mass(np.ones_like(sl2d), sl2d, labels)
        for label, (y, x) in zip(labels, coms):
            heatmap[int(y), int(x)] = 1
            mask = sl2d == label
            centers[0][mask] = y
            centers[1][mask] = x

    heatmap = gaussian_blur(heatmap, heatmap_sigma)
    hmax = heatmap.max()
    if hmax > 0:
        heatmap = heatmap / hmax

    yindices = np.arange(0, h, dtype=np.float32)
    xindices = np.arange(0, w, dtype=np.float32)
    offsets = np.zeros_like(centers)
    offsets[0] = centers[0] - yindices[:, None]
    offsets[1] = centers[1] - xindices[None, :]
    offsets[:, sl2d == 0] = 0
    return heatmap[..., None], offsets.transpose(1, 2, 0)


def seg_to_instance_bd(seg: np.ndarray, tsz_h: int = 1, do_bg: bool = True) -> np.ndarray:
    """Instance contours: (z, h, w) labels -> (z, h, w) uint8.

    ``do_bg=True``: Sobel edges dilated by a (2 tsz_h + 1) square (borders
    against the background count).  ``do_bg=False``: only pixels whose
    (2 tsz_h + 1) window holds two different nonzero labels.
    """
    sz = seg.shape
    bd = np.zeros(sz, np.uint8)
    tsz = tsz_h * 2 + 1

    if not do_bg:
        mm = int(seg.max())
        for z in range(sz[0]):
            slide = np.pad(seg[z], tsz_h, mode="reflect").astype(np.int64)
            p0 = ndimage.maximum_filter(slide, size=tsz)[tsz_h:-tsz_h, tsz_h:-tsz_h]
            masked = np.where(slide == 0, mm + 1, slide)
            p1 = ndimage.minimum_filter(masked, size=tsz)[tsz_h:-tsz_h, tsz_h:-tsz_h]
            bd[z] = ((p0 != 0) & (p1 != 0) & (p0 != p1)).astype(np.uint8)
        return bd

    sobel = np.array([1, 0, -1])
    sobel_x = sobel.reshape(3, 1)
    sobel_y = sobel.reshape(1, 3)
    struct = np.ones((tsz, tsz), dtype=bool)
    for z in range(sz[0]):
        slide = seg[z]
        edge_x = convolve2d(slide, sobel_x, "same", boundary="symm")
        edge_y = convolve2d(slide, sobel_y, "same", boundary="symm")
        edge = np.maximum(np.abs(edge_x), np.abs(edge_y))
        bd[z] = ndimage.binary_dilation(edge != 0, structure=struct).astype(np.uint8)
    return bd
