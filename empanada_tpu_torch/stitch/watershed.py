"""Boundary-contour (BC) watershed segmentation (counterpart of
``empanada_tpu/stitch/watershed.py``).

Seeds are the connected components of (semantic > thres1 & boundary <
thres2), size-filtered; the flood mask is semantic > thres3.  The flood is
the sequential heap watershed of the port's host library
(``csrc/core_kernels.cpp``): a grayscale priority flood in skimage's order,
or the binary-mask variant.  It has no Python twin: a failed build raises.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from empanada_tpu_torch.core import native

__all__ = ["bc_watershed", "mask_watershed", "gray_watershed", "cast2dtype", "size_threshold"]


def cast2dtype(segm: np.ndarray) -> np.ndarray:
    """``segm`` in the smallest unsigned dtype that holds its largest label."""
    mid = np.max(segm)
    m_type = np.uint64
    if mid < 2**8:
        m_type = np.uint8
    elif mid < 2**16:
        m_type = np.uint16
    elif mid < 2**32:
        m_type = np.uint32
    return segm.astype(m_type)


def size_threshold(seg: np.ndarray, thres: int) -> np.ndarray:
    """Zero the labeled objects smaller than ``thres`` voxels, in place."""
    if thres is None or thres <= 0:
        return seg
    labels, counts = np.unique(seg, return_counts=True)
    small = labels[(counts < thres) & (labels > 0)]
    if len(small):
        seg[np.isin(seg, small)] = 0
    return seg


def _neighborhood_offsets(shape, connectivity=1) -> np.ndarray:
    """Flat-index offsets of the neighborhood in an array of ``shape``."""
    struct = ndimage.generate_binary_structure(len(shape), connectivity)
    center = np.array([s // 2 for s in struct.shape])
    strides = np.array([int(np.prod(shape[i + 1:])) for i in range(len(shape))])
    offsets = [int(((idx - center) * strides).sum()) for idx in np.argwhere(struct)
               if (idx - center).any()]
    return np.array(offsets, dtype=np.int64)


def _run_watershed(image, mask, markers, connectivity=1):
    """Pad by one, flatten, flood, crop.  ``image`` None: the mask flood."""
    pad = [(1, 1)] * mask.ndim
    mask_p = np.pad(mask.astype(np.uint8), pad)
    out = np.ascontiguousarray(np.pad(markers.astype(np.int64), pad).reshape(-1))
    offsets = _neighborhood_offsets(mask_p.shape, connectivity)
    marker_locs = np.flatnonzero(out)
    if image is None:
        native.mask_watershed(mask_p.reshape(-1), marker_locs, offsets, out)
    else:
        img_p = np.pad(image.astype(np.float32), pad)
        native.gray_watershed(img_p.reshape(-1), mask_p.reshape(-1), marker_locs, offsets,
                              out)
    return out.reshape(mask_p.shape)[tuple(slice(1, -1) for _ in range(mask.ndim))]


def mask_watershed(mask, markers, connectivity=1):
    """Binary-mask watershed: the markers grow over ``mask`` in insertion
    order."""
    return _run_watershed(None, mask, markers, connectivity)


def gray_watershed(image, markers, mask, connectivity=1):
    """Seeded watershed in skimage's order: lowest ``image`` values first."""
    return _run_watershed(image, mask, markers, connectivity)


def bc_watershed(volume: np.ndarray, thres1: float = 0.9, thres2: float = 0.8,
                 thres3: float = 0.85, seed_thres: int = 32, min_size: int = 128,
                 label_divisor: int = 1000, use_mask_wts: bool = False) -> np.ndarray:
    """Foreground and boundary probability maps ``volume`` (2, ...) in
    uint8 scale -> instance labels (``label_divisor`` + id), in the smallest
    unsigned dtype that holds them."""
    if volume.shape[0] != 2:
        raise ValueError(f"volume of shape {volume.shape}: expected (2, ...) maps")
    semantic, boundary = volume[0], volume[1]
    seed_map = (semantic > int(255 * thres1)) * (boundary < int(255 * thres2))
    foreground = semantic > int(255 * thres3)

    struct = ndimage.generate_binary_structure(semantic.ndim, semantic.ndim)
    seed, _ = ndimage.label(seed_map, structure=struct)
    seed = size_threshold(seed.astype(np.int64), seed_thres)

    if use_mask_wts:
        segm = mask_watershed(foreground, seed)
    else:
        segm = gray_watershed(-semantic.astype(np.float32), seed, foreground)
    segm = segm.astype(np.uint32)
    if min_size is not None:
        segm = size_threshold(segm, min_size)
    segm[segm > 0] += label_divisor
    return cast2dtype(segm)
