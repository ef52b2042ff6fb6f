"""Label-curation array operations (counterpart of
``empanada_tpu/curation/ops.py``, the napari merge/split widget's work
without the GUI): morphology, delete, merge, split (a watershed seeded by
distance-transform peaks or by points, the port's native floods), label
lookup.  All work in place on 2D or 3D integer label arrays and return
them.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from empanada_tpu_torch.stitch.watershed import gray_watershed, mask_watershed

__all__ = [
    "morph_labels",
    "delete_labels",
    "merge_labels",
    "split_labels",
    "jump_to_label",
    "find_next_available_label",
    "line_to_indices",
    "labels_at_points",
]


def _disk(radius: int, ndim: int) -> np.ndarray:
    """Euclidean ball structuring element (skimage disk/ball equivalent)."""
    grids = np.ogrid[tuple(slice(-radius, radius + 1) for _ in range(ndim))]
    dist2 = sum(g**2 for g in grids)
    return dist2 <= radius**2


def _bboxes_of_many(labels: np.ndarray, label_ids, pad: int = 0):
    """{label_id: box} for many labels in ONE pass (ndimage.find_objects)
    — a per-label full-array scan is O(n_labels * n_pixels).  Falls back to
    per-label scans when label values are too large to index a slot list."""
    max_id = int(max(label_ids))
    if max_id > 5_000_000:  # find_objects allocates max_id slots
        return {l: _bbox_of(labels, l, pad) for l in label_ids}
    objs = ndimage.find_objects(labels, max_label=max_id)
    out = {}
    for l in label_ids:
        sl = objs[int(l) - 1] if 0 < int(l) <= len(objs) else None
        if sl is None:
            out[l] = None
            continue
        box = [max(0, s.start - pad) for s in sl]
        box += [min(dim, s.stop + pad) for s, dim in zip(sl, labels.shape)]
        out[l] = box
    return out


def _bbox_of(labels: np.ndarray, label_id: int, pad: int = 0):
    where = np.where(labels == label_id)
    if len(where[0]) == 0:
        return None
    box = []
    for idx in where:
        box.append(max(0, int(idx.min()) - pad))
    for i, idx in enumerate(where):
        box.append(min(labels.shape[i], int(idx.max()) + 1 + pad))
    return tuple(box)


def _box_slices(box):
    n = len(box) // 2
    return tuple(slice(box[i], box[i + n]) for i in range(n))


def labels_at_points(labels: np.ndarray, points) -> list:
    """Nonzero label ids under the given integer points."""
    ids = []
    for pt in points:
        v = int(labels[tuple(int(c) for c in pt)])
        if v > 0 and v not in ids:
            ids.append(v)
    return ids


def _remove_small_holes(binary: np.ndarray, area_threshold: int) -> np.ndarray:
    """Fill background holes smaller than area_threshold."""
    holes, n = ndimage.label(~binary)
    if n == 0:
        return binary
    sizes = ndimage.sum_labels(np.ones_like(holes), holes, np.arange(1, n + 1))
    # a "hole" touching the array border is background, not a hole
    border_ids = set()
    for axis in range(binary.ndim):
        for sl in (0, -1):
            face = np.take(holes, sl, axis=axis)
            border_ids.update(np.unique(face).tolist())
    fill = np.zeros(n + 1, dtype=bool)
    for hole_id in range(1, n + 1):
        if hole_id in border_ids:
            continue
        if sizes[hole_id - 1] < area_threshold:
            fill[hole_id] = True
    return binary | fill[holes]


_MORPH_OPS = {
    "dilate": lambda b, se: ndimage.binary_dilation(b, structure=se),
    "erode": lambda b, se: ndimage.binary_erosion(b, structure=se),
    "close": lambda b, se: ndimage.binary_closing(b, structure=se),
    "open": lambda b, se: ndimage.binary_opening(b, structure=se),
    "fill_holes": None,  # handled specially (hole_size arg)
}


def morph_labels(
    labels: np.ndarray,
    label_ids=None,
    points=None,
    operation: str = "dilate",
    radius: int = 1,
    hole_size: int = 64,
    apply3d: bool = False,
) -> np.ndarray:
    """Apply a binary morphology op to each selected label within its
    (padded) bounding box."""
    if operation not in _MORPH_OPS:
        raise ValueError(f"unknown operation {operation!r}; one of {sorted(_MORPH_OPS)}")
    if points is not None:
        label_ids = labels_at_points(labels, points)
    if label_ids is None:
        label_ids = [l for l in np.unique(labels) if l > 0]
    label_ids = [l for l in label_ids if l > 0]
    if not label_ids:
        return labels

    per_slice = labels.ndim == 3 and not apply3d
    ndim = 2 if per_slice else labels.ndim
    se = _disk(radius, ndim)

    # one-pass boxes for big selections; fill_holes stays per-label because
    # its result depends on the crop border (holes touching it are kept)
    boxes = (
        _bboxes_of_many(labels, label_ids, pad=radius)
        if len(label_ids) > 8 and operation != "fill_holes" else None
    )
    for label_id in label_ids:
        box = boxes[label_id] if boxes is not None else _bbox_of(labels, label_id, pad=radius)
        if box is None:
            continue
        slices = _box_slices(box)
        crop = labels[slices]
        binary = crop == label_id

        def apply_op(b):
            if operation == "fill_holes":
                return _remove_small_holes(b, hole_size)
            return _MORPH_OPS[operation](b, se)

        if per_slice:
            new_binary = np.stack([apply_op(b) for b in binary])
        else:
            new_binary = apply_op(binary)

        # erase the old extent, paint the new one (only over background
        # for growth ops so neighbors aren't clobbered)
        crop[binary & ~new_binary] = 0
        crop[new_binary & (crop == 0)] = label_id

    return labels


def delete_labels(labels: np.ndarray, label_ids=None, points=None) -> np.ndarray:
    """Zero out the selected labels."""
    if points is not None:
        label_ids = labels_at_points(labels, points)
    if label_ids is None or len(label_ids) == 0:
        return labels
    labels[np.isin(labels, list(label_ids))] = 0
    return labels


def line_to_indices(line: np.ndarray, axis: int = 0) -> np.ndarray:
    """Rasterize a 2-point line (2D/3D/4D endpoints) into integer indices;
    for >2D the line must lie within one plane along ``axis`` (4D: axis 0)."""
    line = np.asarray(line)
    nd = line.shape[1]

    def bresenham(y0, x0, y1, x1):
        n = int(max(abs(y1 - y0), abs(x1 - x0))) + 1
        ys = np.round(np.linspace(y0, y1, n)).astype(np.int64)
        xs = np.round(np.linspace(x0, x1, n)).astype(np.int64)
        return ys, xs

    if nd == 2:
        y, x = bresenham(*line.ravel().astype(int))
        return np.stack([y, x], axis=1)
    if nd == 3:
        plane = int(line[0][axis])
        keep = [i for i in range(3) if i != axis]
        y, x = bresenham(*line[:, keep].ravel().astype(int))
        z = np.full_like(x, plane)
        cols = [y, x]
        cols.insert(axis, z)
        return np.stack(cols, axis=1)
    if nd == 4:
        if axis != 0:
            raise ValueError(f"a 4D line lies in a plane of axis 0, not {axis}")
        t0, z0 = int(line[0][0]), int(line[0][1])
        y, x = bresenham(*line[:, [2, 3]].ravel().astype(int))
        return np.stack([np.full_like(x, t0), np.full_like(x, z0), y, x], axis=1)
    raise ValueError("only lines in 2d, 3d and 4d are supported")


def merge_labels(labels: np.ndarray, label_ids=None, points=None, lines=None,
                 new_label=None) -> np.ndarray:
    """Merge the selected labels into one id (the smallest selected, or
    ``new_label``); points and rasterized lines both select labels."""
    selected = [] if label_ids is None else list(label_ids)
    if points is not None:
        selected += labels_at_points(labels, points)
    if lines is not None:
        for line in lines:
            idx = line_to_indices(np.asarray(line))
            selected += labels_at_points(labels, idx)
    selected = sorted(set(l for l in selected if l > 0))
    if len(selected) < 2 and new_label is None:
        return labels
    target = new_label if new_label is not None else selected[0]
    labels[np.isin(labels, selected)] = target
    return labels


def _peak_markers(binary: np.ndarray, min_distance: int):
    """(energy, markers): the negated distance transform, and one marker a
    connected plateau of its local maxima."""
    distance = ndimage.distance_transform_edt(binary)
    size = 2 * min_distance + 1
    footprint = np.ones((size,) * binary.ndim, dtype=bool)
    maxed = ndimage.maximum_filter(distance, footprint=footprint, mode="constant")
    peaks = (distance == maxed) & (distance > 0)
    markers, _ = ndimage.label(peaks)
    return -distance, markers


def split_labels(
    labels: np.ndarray,
    label_ids=None,
    points=None,
    min_distance: int = 10,
    points_as_markers: bool = False,
    apply3d: bool = False,
    start_label=None,
) -> np.ndarray:
    """Split labels with a seeded watershed: markers from distance-transform
    peaks, or from the points when ``points_as_markers``; the first
    fragment keeps the id, the others take ids from ``start_label`` (or
    the array's maximum + 1) up."""
    if label_ids is None:
        if points is None:
            raise ValueError("provide label_ids or points")
        label_ids = labels_at_points(labels, points)
    label_ids = [l for l in label_ids if l > 0]

    next_label = int(start_label) if start_label else int(labels.max()) + 1
    per_slice = labels.ndim == 3 and not apply3d

    for label_id in label_ids:
        box = _bbox_of(labels, label_id)
        if box is None:
            continue
        slices = _box_slices(box)
        crop = labels[slices]
        binary = crop == label_id

        if points_as_markers and points is not None:
            markers = np.zeros(binary.shape, dtype=np.int64)
            n = labels.ndim
            for pt in points:
                local = tuple(int(pt[i]) - box[i] for i in range(n))
                if all(0 <= local[i] < binary.shape[i] for i in range(n)):
                    markers[local] = 1
            markers, _ = ndimage.label(markers)
            seg = mask_watershed(binary, markers)
        else:
            if per_slice:
                seg = np.zeros_like(crop)
                offset = 0
                for z in range(binary.shape[0]):
                    energy, markers = _peak_markers(binary[z], min_distance)
                    s = gray_watershed(energy, markers, binary[z])
                    s[s > 0] += offset
                    offset = max(offset, int(s.max()))
                    seg[z] = s
            else:
                energy, markers = _peak_markers(binary, min_distance)
                seg = gray_watershed(energy, markers, binary)

        new_ids = np.unique(seg)
        new_ids = new_ids[new_ids > 0]
        if len(new_ids) < 2:
            continue
        # keep the original id for the first fragment, new ids for the rest
        for i, nid in enumerate(new_ids):
            mask = seg == nid
            if i == 0:
                crop[mask] = label_id
            else:
                crop[mask] = next_label
                next_label += 1

    return labels


def jump_to_label(labels: np.ndarray, label_id: int):
    """Bounding box of a label (the widget centers the viewer on it)."""
    box = _bbox_of(labels, int(label_id))
    if box is None:
        raise KeyError(f"No label {label_id}")
    return box


def find_next_available_label(labels: np.ndarray, class_id: int, label_divisor: int) -> int:
    """Smallest unused instance id within a class's label range."""
    min_id = class_id * label_divisor
    max_id = min_id + label_divisor
    used = np.unique(labels)
    used = used[(used >= min_id) & (used < max_id)]
    if len(used) == 0:
        return min_id + 1
    taken = set(used.tolist())
    for candidate in range(min_id + 1, max_id):
        if candidate not in taken:
            return candidate
    raise RuntimeError("label range exhausted")
