"""Segmentation export (counterpart of ``empanada_tpu/curation/export.py``):
label volumes as one TIFF a slice or one multipage TIFF, optionally with
the grey images beside them."""

from __future__ import annotations

import os

import numpy as np

from empanada_tpu_torch.data.imwrite import imwrite

__all__ = ["export_segmentations"]


def _to_saveable(arr: np.ndarray) -> np.ndarray:
    """uint8, uint16, int32 and float32 as they are; any other dtype as
    uint16 when its maximum is below 2^16, else int32."""
    if arr.dtype in (np.uint8, np.uint16, np.int32, np.float32):
        return arr
    if arr.max() < 2 ** 16:
        return arr.astype(np.uint16)
    return arr.astype(np.int32)


def export_segmentations(labels: np.ndarray, save_dir: str, prefix: str = "seg",
                         as_stack: bool = False, image: np.ndarray | None = None,
                         impaths=None) -> list:
    """Write a (d, h, w) (or (h, w)) label volume, and ``image`` beside it,
    under ``save_dir``: ``<prefix>.tiff`` (+ ``<prefix>_image.tiff``) with
    ``as_stack``, else one TIFF a slice named after ``impaths`` or
    ``<prefix>_<i:05d>``.  Returns the paths written."""
    os.makedirs(save_dir, exist_ok=True)
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = labels[None]
    if image is not None:
        image = np.asarray(image)
        if image.ndim == 2:
            image = image[None]
    written = []
    if as_stack:
        written.append(imwrite(os.path.join(save_dir, f"{prefix}.tiff"),
                               [_to_saveable(sl) for sl in labels]))
        if image is not None:
            written.append(imwrite(os.path.join(save_dir, f"{prefix}_image.tiff"), image))
        return written
    for i, sl in enumerate(labels):
        if impaths is not None and i < len(impaths):
            name = os.path.splitext(os.path.basename(impaths[i]))[0]
        else:
            name = f"{prefix}_{i:05d}"
        written.append(imwrite(os.path.join(save_dir, f"{name}.tiff"), _to_saveable(sl)))
        if image is not None:
            written.append(imwrite(os.path.join(save_dir, f"{name}_image.tiff"), image[i]))
    return written
