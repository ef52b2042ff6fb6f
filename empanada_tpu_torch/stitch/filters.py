"""In-place tracker filters (counterpart of
``empanada_tpu/stitch/filters.py``): small-object and pancake removal work
on the RLEs; the morphological clean-ups (erosion, dilation, hole filling)
go through a dense volume and ``scipy.ndimage``, then re-split each thing
instance into its connected components."""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from empanada_tpu_torch.core.labeling import extract_runs, runs_to_regions
from empanada_tpu_torch.stitch.rle_seg import rle_seg_to_pan_seg

__all__ = [
    "remove_small_objects",
    "remove_pancakes",
    "regions_3d",
    "erode",
    "dilate",
    "fill_holes_in_segmentation",
]


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


def _tracker_to_dense(object_tracker, volume_shape):
    return rle_seg_to_pan_seg({0: object_tracker.instances}, volume_shape)


def regions_3d(mask: np.ndarray) -> dict:
    """Per-label ``{"box": (z1, y1, x1, z2, y2, x2), "starts", "runs"}`` of a
    (d, h, w) volume, from the row runs of its (d * h, w) view (a run never
    wraps a row there, so the boxes fall out of the run extents); flat
    touching runs are joined."""
    d, h, w = mask.shape
    v, r, cs, ce = extract_runs(mask.reshape(d * h, w))
    if len(v) == 0:
        return {}
    order = np.argsort(v, kind="stable")
    v, r, cs, ce = v[order], r[order], cs[order], ce[order]
    z, y = r // h, r % h
    group_idx = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
    bounds = np.concatenate([group_idx, [len(v)]])
    z1, z2 = np.minimum.reduceat(z, group_idx), np.maximum.reduceat(z, group_idx) + 1
    y1, y2 = np.minimum.reduceat(y, group_idx), np.maximum.reduceat(y, group_idx) + 1
    x1, x2 = np.minimum.reduceat(cs, group_idx), np.maximum.reduceat(ce, group_idx)
    starts_flat = r * w + cs
    lens = ce - cs
    out = {}
    for k, label in enumerate(v[group_idx]):
        s, n = starts_flat[bounds[k]:bounds[k + 1]], lens[bounds[k]:bounds[k + 1]]
        if len(s) > 1:
            touch = s[1:] == s[:-1] + n[:-1]
            if touch.any():
                keep = np.flatnonzero(np.concatenate([[True], ~touch]))
                ends = np.maximum.reduceat(s + n, keep)
                s = s[keep]
                n = ends - s
        out[int(label)] = {
            "box": (int(z1[k]), int(y1[k]), int(x1[k]), int(z2[k]), int(y2[k]), int(x2[k])),
            "starts": s, "runs": n}
    return out


def _force_connected_relabel(mask, labels, label_divisor, thing_list):
    """Each thing instance of a dense label map split into its connected
    components (full connectivity, inside the instance's box), numbered
    from ``class_id * label_divisor + 1`` in id order, then component
    order; ids past the class's window raise."""
    max_id = int(mask.max(initial=0))
    if max_id == 0:
        return mask
    out = mask.copy()
    structure = np.ones((3,) * mask.ndim, dtype=bool)
    objs = ndimage.find_objects(mask, max_label=max_id)
    for label in labels:
        if label not in thing_list:
            continue
        lo = label * label_divisor
        class_end = (label + 1) * label_divisor
        next_id = lo + 1
        for val in range(lo, min(class_end, max_id + 1)):
            sl = objs[val - 1] if val >= 1 else None
            if sl is None:
                continue
            cc, n = ndimage.label(mask[sl] == val, structure=structure)
            view = out[sl]
            for comp in range(1, n + 1):
                if next_id >= class_end:
                    raise ValueError(f"class {label}: connected components exceed "
                                     f"label_divisor={label_divisor}; raise the label "
                                     "divisor")
                view[cc == comp] = next_id
                next_id += 1
    return out


def _dense_to_tracker_instances(mask, labels, label_divisor, thing_list):
    mask = _force_connected_relabel(mask, labels, label_divisor, thing_list)
    if mask.ndim == 2:
        return runs_to_regions(*extract_runs(mask), width=mask.shape[-1])
    return regions_3d(mask)


def _struct(ndim):
    # the cross (2D) or 6-connected ball (3D) footprint
    return ndimage.generate_binary_structure(ndim, 1)


def erode(object_tracker, volume_shape, labels, label_divisor, thing_list, iterations=1):
    """Grey erosion of the tracker's label volume, ``iterations`` times."""
    mask = _tracker_to_dense(object_tracker, volume_shape)
    for _ in range(iterations):
        mask = ndimage.grey_erosion(mask, footprint=_struct(mask.ndim))
    object_tracker.instances = _dense_to_tracker_instances(mask, labels, label_divisor,
                                                           thing_list)
    return object_tracker


def dilate(object_tracker, volume_shape, labels, label_divisor, thing_list, iterations=1):
    """Grey dilation of the tracker's label volume, ``iterations`` times."""
    mask = _tracker_to_dense(object_tracker, volume_shape)
    for _ in range(iterations):
        mask = ndimage.grey_dilation(mask, footprint=_struct(mask.ndim))
    object_tracker.instances = _dense_to_tracker_instances(mask, labels, label_divisor,
                                                           thing_list)
    return object_tracker


def fill_holes_in_segmentation(object_tracker, volume_shape, labels, label_divisor,
                               thing_list):
    """Per slice and instance, the holes of the instance inside its box
    filled, claiming background pixels only (an instance inside another's
    hole survives)."""
    mask_3d = _tracker_to_dense(object_tracker, volume_shape)
    slices = mask_3d if mask_3d.ndim == 3 else mask_3d[None]
    for sl in slices:
        regions = runs_to_regions(*extract_runs(sl), width=sl.shape[-1])
        for label, attrs in regions.items():
            if label <= 0:
                continue
            y1, x1, y2, x2 = attrs["box"]
            crop = sl[y1:y2, x1:x2]
            filled = ndimage.binary_fill_holes(crop == label)
            crop[filled & (crop == 0)] = label
    object_tracker.instances = _dense_to_tracker_instances(mask_3d, labels, label_divisor,
                                                           thing_list)
    return object_tracker
