"""3D instance tracking: accumulates per-slice 2D instances into 3D RLEs
along an axis (counterpart of ``empanada_tpu/stitch/tracker.py``).

The 2D -> 3D flat-index conversion is axis dependent:
- xy: the 2D flat index maps directly, offset by ``index2d * H * W``;
- xz: run starts are re-raveled with the fixed y plane inserted (runs stay
  intact because x remains the fastest axis).
The yz axis, whose runs must be exploded to voxels and re-encoded at
``finish``, is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

from empanada_tpu_torch.core.boxes import merge_boxes
from empanada_tpu_torch.core.labeling import FlatInstances

__all__ = ["InstanceTracker", "to_box3d"]

AXIS_NUMS = {"xy": 0, "xz": 1}


def to_box3d(index2d: int, box, axis: str):
    h1, w1, h2, w2 = box
    if axis == "xy":
        return (index2d, h1, w1, index2d + 1, h2, w2)
    return (h1, index2d, w1, h2, index2d + 1, w2)


class InstanceTracker:
    """Instances of one class across the slices of one axis:
    ``instances[label] = {"box": 3D box, "starts": ..., "runs": ...}``,
    lists of per-slice arrays until ``finish`` concatenates and sorts them."""

    def __init__(self, class_id, label_divisor, shape3d, axis="xy"):
        if axis not in AXIS_NUMS:
            raise NotImplementedError(
                f"axis {axis!r}: the port tracks xy and xz; yz (its re-encoding "
                "finish) is still to be ported")
        self.class_id = class_id
        self.label_divisor = label_divisor
        self.shape3d = tuple(shape3d)
        self.axis = axis
        self.finished = False
        self.instances = {}

    def update(self, flat: FlatInstances, index2d: int):
        """Add one slice's instances (all runs converted in one pass)."""
        assert not self.finished, "Cannot update tracker after calling finish!"
        shape2d = tuple(s for i, s in enumerate(self.shape3d) if i != AXIS_NUMS[self.axis])
        if self.axis == "xy":
            starts_all = flat.starts + index2d * math.prod(shape2d)
        else:
            ycoords, xcoords = np.unravel_index(flat.starts, shape2d)
            starts_all = np.ravel_multi_index(
                (ycoords, np.full_like(ycoords, index2d), xcoords), self.shape3d)
        bounds = flat.offsets
        boxes2d = flat.boxes.tolist()
        for k, label in enumerate(flat.labels.tolist()):
            box = to_box3d(index2d, boxes2d[k], self.axis)
            starts = starts_all[bounds[k]: bounds[k + 1]]
            runs = flat.runs[bounds[k]: bounds[k + 1]]
            inst = self.instances.get(label)
            if inst is None:
                self.instances[label] = {"box": box, "starts": [starts], "runs": [runs]}
            else:
                inst["box"] = merge_boxes(box, inst["box"])
                inst["starts"].append(starts)
                inst["runs"].append(runs)

    def finish(self):
        for inst in self.instances.values():
            if not isinstance(inst["starts"], list):
                continue
            starts = np.concatenate(inst["starts"])
            runs = np.concatenate(inst["runs"])
            order = np.argsort(starts, kind="stable")
            inst["starts"] = starts[order]
            inst["runs"] = runs[order]
        self.finished = True
