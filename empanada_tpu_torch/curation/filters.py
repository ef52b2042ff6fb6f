"""Label filters (counterpart of ``empanada_tpu/curation/filters.py``):
remove small labels and labels touching the border, per image, per 2D
slice of a stack or over a whole volume."""

from __future__ import annotations

import numpy as np

__all__ = ["filter_out_small_label_areas", "remove_boundary_labels", "apply_label_filter"]


def filter_out_small_label_areas(img: np.ndarray, minimum_area_allowed: int):
    """Zero the labels of at most ``minimum_area_allowed`` pixels (voxels),
    in place; returns (img, number removed)."""
    labels, counts = np.unique(img, return_counts=True)
    keep = labels > 0
    small = labels[keep][counts[keep] <= minimum_area_allowed]
    if len(small):
        img[np.isin(img, small)] = 0
    return img, len(small)


def remove_boundary_labels(labels: np.ndarray):
    """Zero the labels touching any face of the array, in place; returns
    (labels, number removed)."""
    border_ids = set()
    for axis in range(labels.ndim):
        for sl in (0, -1):
            face = np.take(labels, sl, axis=axis)
            border_ids.update(int(v) for v in np.unique(face) if v > 0)
    if border_ids:
        labels[np.isin(labels, list(border_ids))] = 0
    return labels, len(border_ids)


def apply_label_filter(labels: np.ndarray, mode: str = "image", **kwargs):
    """``filter="small"`` (with ``minimum_area_allowed``) or ``"boundary"``,
    over the whole array (``mode`` "image" or "volume") or each 2D slice of
    a stack ("patches"); returns (labels, number removed)."""
    filt = kwargs.pop("filter", "small")
    if filt == "small":
        def fn(a):
            return filter_out_small_label_areas(a, kwargs["minimum_area_allowed"])
    else:
        fn = remove_boundary_labels
    if mode == "patches" and labels.ndim == 3:
        total = 0
        for z in range(labels.shape[0]):
            labels[z], n = fn(labels[z])
            total += n
        return labels, total
    return fn(labels)
