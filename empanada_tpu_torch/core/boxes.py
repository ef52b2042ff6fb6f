"""Bounding-box math for 2D (y1,x1,y2,x2) and 3D (z1,y1,x1,z2,y2,x2) boxes.

The helpers the matcher and the tracker use (counterpart of
``empanada_tpu/core/boxes.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["merge_boxes", "overlapping_box_pairs"]


def merge_boxes(box1, box2):
    """Smallest box enclosing both inputs."""
    n = len(box1)
    ndim = n // 2
    return tuple(
        min(box1[i], box2[i]) if i < ndim else max(box1[i], box2[i]) for i in range(n)
    )


def overlapping_box_pairs(boxes1, boxes2=None, chunk: int = 1024) -> np.ndarray:
    """(k, 2) index pairs of boxes with positive intersection.

    The nonzero pattern of the pairwise box intersection, without an
    (n, m) float matrix.  Integer boxes above a small
    size threshold go through the native sweep-line kernel
    (csrc/core_kernels.cpp box_overlap_pairs) — output-sensitive, i.e.
    near-linear on real instance sets instead of the quadratic boolean
    pass; otherwise rows are processed in chunks with a bool overlap test
    per dimension, memory O(chunk * m) (the reference's numba double
    loop, array_utils.py:178, had the same screening role).
    """
    boxes1 = np.asarray(boxes1)
    boxes2 = boxes1 if boxes2 is None else np.asarray(boxes2)
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.empty((0, 2), dtype=np.int64)

    from empanada_tpu_torch.core import native

    if (
        len(boxes1) * len(boxes2) > 16384
        and np.issubdtype(boxes1.dtype, np.integer)
        and np.issubdtype(boxes2.dtype, np.integer)
        and native.available()
    ):
        return native.box_overlap_pairs(
            boxes1, None if boxes2 is boxes1 else boxes2
        )
    ndim = boxes1.shape[1] // 2

    lo2 = boxes2[:, :ndim]           # (m, ndim)
    hi2 = boxes2[:, ndim:]
    out_r, out_c = [], []
    for r0 in range(0, len(boxes1), chunk):
        b1 = boxes1[r0 : r0 + chunk]
        overlap = np.ones((len(b1), len(boxes2)), dtype=bool)
        for i in range(ndim):
            # positive intersection extent: min(hi) > max(lo) — also rejects
            # degenerate zero-extent boxes, matching box_intersection > 0
            hi = np.minimum(b1[:, i + ndim, None], hi2[None, :, i])
            lo = np.maximum(b1[:, i, None], lo2[None, :, i])
            overlap &= hi > lo
        r, c = np.nonzero(overlap)
        out_r.append(r + r0)
        out_c.append(c)
    return np.stack([np.concatenate(out_r), np.concatenate(out_c)], axis=1)
