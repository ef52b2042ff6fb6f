"""3D instance tracking: accumulates per-slice 2D instances into 3D RLEs
along an axis (counterpart of ``empanada_tpu/stitch/tracker.py``).

The 2D -> 3D flat-index conversion is axis dependent:
- xy: the 2D flat index maps directly, offset by ``index2d * H * W``;
- xz: run starts are re-raveled with the fixed y plane inserted (runs stay
  intact because x remains the fastest axis);
- yz: x becomes the slice plane, so every voxel's index changes: runs are
  exploded to voxels at ``update`` and re-encoded at ``finish``.

The yz finish sorts every instance's voxels in one pass under the key
``voxel + k * (prod + 1)`` (k the instance's position) and run-length
encodes the keys.  A voxel is below ``prod``, so the keys of two instances
are at least 2 apart and no run can cross from one instance to the next.
(The JAX package keys with stride ``prod``: when one instance holds voxel
``prod - 1`` and the next holds voxel 0, their keys are adjacent and
``rle_encode`` merges the two into one run.)
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from empanada_tpu_torch.core.boxes import merge_boxes
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.core.rle import rle_decode, rle_encode, rle_to_string, string_to_rle

__all__ = ["InstanceTracker", "to_box3d"]

AXIS_NUMS = {"xy": 0, "xz": 1, "yz": 2}


def to_box3d(index2d: int, box, axis: str):
    h1, w1, h2, w2 = box
    if axis == "xy":
        return (index2d, h1, w1, index2d + 1, h2, w2)
    if axis == "xz":
        return (h1, index2d, w1, h2, index2d + 1, w2)
    return (h1, w1, index2d, h2, w2, index2d + 1)


class InstanceTracker:
    """Instances of one class across the slices of one axis:
    ``instances[label] = {"box": 3D box, "starts": ..., "runs": ...}``,
    lists of per-slice arrays until ``finish`` concatenates and sorts them."""

    def __init__(self, class_id, label_divisor, shape3d, axis="xy"):
        if axis not in AXIS_NUMS:
            raise ValueError(f"axis {axis!r}: expected one of {list(AXIS_NUMS)}")
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
        runs_all, bounds = flat.runs, flat.offsets
        if self.axis == "xy":
            starts_all = flat.starts + index2d * math.prod(shape2d)
        elif self.axis == "xz":
            ycoords, xcoords = np.unravel_index(flat.starts, shape2d)
            starts_all = np.ravel_multi_index(
                (ycoords, np.full_like(ycoords, index2d), xcoords), self.shape3d)
        else:  # yz: explode to voxels, re-encode at finish
            # pixel p = z * H + y of the (Z, H) plane is voxel p * W + x
            starts_all = rle_decode(flat.starts, flat.runs) * self.shape3d[2] + index2d
            runs_all = np.ones_like(starts_all)
            bounds = np.concatenate([[0], np.cumsum(flat.areas)])
        boxes2d = flat.boxes.tolist()
        for k, label in enumerate(flat.labels.tolist()):
            box = to_box3d(index2d, boxes2d[k], self.axis)
            starts = starts_all[bounds[k]: bounds[k + 1]]
            runs = runs_all[bounds[k]: bounds[k + 1]]
            inst = self.instances.get(label)
            if inst is None:
                self.instances[label] = {"box": box, "starts": [starts], "runs": [runs]}
            else:
                inst["box"] = merge_boxes(box, inst["box"])
                inst["starts"].append(starts)
                inst["runs"].append(runs)

    def finish(self):
        if self.axis == "yz":
            self._finish_yz()
            return
        for inst in self.instances.values():
            if not isinstance(inst["starts"], list):
                continue
            starts = np.concatenate(inst["starts"])
            runs = np.concatenate(inst["runs"])
            order = np.argsort(starts, kind="stable")
            inst["starts"] = starts[order]
            inst["runs"] = runs[order]
        self.finished = True

    def _finish_yz(self):
        """Sort and re-encode every pending instance's voxels in one pass
        (module docstring: the keys ``voxel + k * (prod + 1)``)."""
        pending = [v for v in self.instances.values() if isinstance(v["starts"], list)]
        if pending:
            stride = math.prod(self.shape3d) + 1
            chunks = [c for v in pending for c in v["starts"]]
            lens = np.fromiter(map(len, chunks), np.int64, count=len(chunks))
            ids = np.repeat(np.arange(len(pending), dtype=np.int64),
                            [len(v["starts"]) for v in pending])
            keys = np.concatenate(chunks) + np.repeat(ids, lens) * stride
            keys.sort(kind="stable")
            starts_all, runs_all = rle_encode(keys)
            run_ids = starts_all // stride
            starts_all = starts_all - run_ids * stride
            bounds = np.searchsorted(run_ids, np.arange(len(pending) + 1))
            for k, inst in enumerate(pending):
                inst["starts"] = starts_all[bounds[k]: bounds[k + 1]]
                inst["runs"] = runs_all[bounds[k]: bounds[k + 1]]
        self.finished = True

    def write_to_json(self, savepath: str):
        """Finish if needed, then write the tracker as the JSON of the JAX
        package's tracker (RLEs as "start run ..." strings), atomically: a
        crash mid-write leaves no truncated file that passes a resume's
        existence check."""
        if not self.finished:
            self.finish()
        save_dict = {"class_id": self.class_id, "label_divisor": self.label_divisor,
                     "shape3d": list(self.shape3d), "axis": self.axis, "finished": True,
                     "instances": {str(k): {"box": [int(b) for b in attrs["box"]],
                                            "rle": rle_to_string(attrs["starts"],
                                                                 attrs["runs"])}
                                   for k, attrs in self.instances.items()}}
        tmp = savepath + ".tmp"
        with open(tmp, "w") as handle:
            json.dump(save_dict, handle, indent=2)
        os.replace(tmp, savepath)

    def load_from_json(self, fpath: str):
        """Replace this tracker by the one ``write_to_json`` saved."""
        with open(fpath) as handle:
            load_dict = json.load(handle)
        self.class_id = load_dict["class_id"]
        self.label_divisor = load_dict["label_divisor"]
        self.shape3d = tuple(load_dict["shape3d"])
        self.axis = load_dict["axis"]
        self.finished = load_dict.get("finished", True)
        self.instances = {}
        for k, attrs in load_dict["instances"].items():
            starts, runs = string_to_rle(attrs["rle"])
            self.instances[int(k)] = {"box": tuple(attrs["box"]), "starts": starts,
                                      "runs": runs}
