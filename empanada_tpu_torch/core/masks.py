"""Array slicing and dense binary-mask helpers (counterpart of
``empanada_tpu/core/masks.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["take", "put", "crop_and_binarize", "mask_iou", "mask_ioa"]


def take(array, indices, axis: int = 0):
    """Slice ``array`` at ``indices`` along ``axis`` (works on any array-like
    that supports numpy-style tuple indexing, e.g. chunked stores)."""
    sel = tuple(slice(None) if n != axis else indices for n in range(array.ndim))
    return array[sel]


def put(array, indices, value, axis: int = 0):
    """Assign ``value`` at ``indices`` along ``axis``, in place."""
    sel = tuple(slice(None) if n != axis else indices for n in range(array.ndim))
    array[sel] = value


def crop_and_binarize(mask: np.ndarray, box, label) -> np.ndarray:
    """Crop ``mask`` to ``box`` and binarize where equal to ``label``."""
    ndim = len(box) // 2
    slices = tuple(slice(box[i], box[i + ndim]) for i in range(ndim))
    return mask[slices] == label


def mask_iou(mask1, mask2) -> float:
    inter = np.count_nonzero(np.logical_and(mask1, mask2))
    union = np.count_nonzero(np.logical_or(mask1, mask2))
    return inter / union if union > 0 else 0.0


def mask_ioa(mask1, mask2) -> float:
    inter = np.count_nonzero(np.logical_and(mask1, mask2))
    area = np.count_nonzero(mask2)
    return inter / area if area > 0 else 0.0
