"""In-place tracker filters on RLEs (counterpart of
``empanada_tpu/stitch/filters.py``: the two that the 3D engine applies)."""

from __future__ import annotations

import numpy as np

__all__ = ["remove_small_objects", "remove_pancakes"]


def remove_small_objects(object_tracker, min_size: int = 64):
    """Delete instances with fewer than ``min_size`` voxels."""
    for instance_id in list(object_tracker.instances.keys()):
        size = int(np.asarray(object_tracker.instances[instance_id]["runs"]).sum())
        if size < min_size:
            del object_tracker.instances[instance_id]


def remove_pancakes(object_tracker, min_span: int = 4):
    """Delete instances whose 3D box extent is < min_span on any axis."""
    for instance_id in list(object_tracker.instances.keys()):
        box = object_tracker.instances[instance_id]["box"]
        spans = (box[3] - box[0], box[4] - box[1], box[5] - box[2])
        if any(span < min_span for span in spans):
            del object_tracker.instances[instance_id]
