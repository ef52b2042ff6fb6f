"""Runs of a panoptic slice -> per-class instance records, and back
(counterpart of ``empanada_tpu/stitch/rle_seg.py``).

A slice arrives as a dense map, as runs (``core.labeling.extract_runs``)
or as one slice of ``ops.postprocess.encode_runs_packed`` output, and leaves
as ``{class_id: FlatInstances}`` (the 3D path) or as the nested
``{class_id: {instance_id: {"box", "starts", "runs"}}}`` dict (the tiles of
``Engine2d``): per class, optional connected components over runs (thing
classes with ``force_connected``), instance grouping and canonical RLEs.
``rle_seg_to_pan_seg`` paints the nested dict back into a dense map.
"""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.labeling import (
    FlatInstances,
    connected_components_runs,
    decode_runs_packed,
    extract_runs,
    runs_to_flat,
)
from empanada_tpu_torch.core.rle import string_to_rle

__all__ = [
    "pan_seg_to_rle_seg",
    "runs_to_rle_seg",
    "runs_to_flat_seg",
    "packed_to_flat_seg",
    "rle_seg_to_pan_seg",
    "unpack_rle_attrs",
]


def pan_seg_to_rle_seg(pan_seg: np.ndarray, labels, label_divisor: int, thing_list,
                       force_connected: bool = True) -> dict:
    """A dense (h, w) panoptic map -> ``{class_id: {instance_id: {"box",
    "starts", "runs"}}}`` (``runs_to_flat_seg``'s rules)."""
    values, rows, cs, ce = extract_runs(pan_seg)
    return runs_to_rle_seg(values, rows, cs, ce, pan_seg.shape[1], labels, label_divisor,
                           thing_list, force_connected)


def runs_to_rle_seg(values, rows, cs, ce, width: int, labels, label_divisor: int,
                    thing_list, force_connected: bool = True) -> dict:
    """``runs_to_flat_seg`` in the nested dict form."""
    return {label: flat.to_dict() for label, flat in runs_to_flat_seg(
        values, rows, cs, ce, width, labels, label_divisor, thing_list,
        force_connected).items()}


def runs_to_flat_seg(
    values, rows, cs, ce, width: int,
    labels, label_divisor: int, thing_list,
    force_connected: bool = True,
) -> dict:
    """``{class_id: FlatInstances}`` of one slice's nonzero runs: per class,
    the runs in its id window, relabelled as connected components
    (8-connectivity, numbered from ``class_id * label_divisor + 1`` in
    scanline order) when ``force_connected`` and the class is a thing."""
    w = width
    fast = native.available()

    flat_seg = {}
    for label in labels:
        min_id = label * label_divisor
        max_id = min_id + label_divisor
        fc = force_connected and label in thing_list

        if fast:
            # filter + CC + group + canonicalise in one native call,
            # identical to the numpy chain below
            flat = FlatInstances(*native.runs_build_flat(
                values, rows, cs, ce, w, min_id, max_id, fc))
        else:
            sel = (values >= min_id) & (values < max_id)
            v = values[sel]
            r = rows[sel]
            s = cs[sel]
            e = ce[sel]
            if fc and len(v) > 0:
                comp = connected_components_runs(v, r, s, e, connectivity=8)
                v = comp + min_id
            flat = runs_to_flat(v, r, s, e, w)
        if fc and len(flat) >= label_divisor:
            _raise_cc_overflow(label, len(flat), label_divisor)
        flat_seg[label] = flat

    return flat_seg


def _raise_cc_overflow(label, n, label_divisor):
    # the reference silently spills ids into the next class's window here
    # (its cc relabel has no bound check); fail loudly instead — silent
    # class reassignment is worse
    raise ValueError(
        f"class {label}: {n} connected components exceed "
        f"label_divisor={label_divisor}; raise the label divisor"
    )


def packed_to_flat_seg(
    row_buf: np.ndarray,
    width: int,
    labels,
    label_divisor: int,
    thing_list,
    force_connected: bool = True,
):
    """``runs_to_flat_seg`` straight off one slice of packed rows, or None
    when a row overflowed its run capacity (the caller sends the dense map
    instead)."""
    if native.available():
        flat_seg = {}
        for label in labels:
            min_id = label * label_divisor
            fc = force_connected and label in thing_list
            out = native.packed_build_flat(
                row_buf, width, min_id, min_id + label_divisor, fc)
            if out == "overflow":
                return None
            flat = FlatInstances(*out)
            if fc and len(flat) >= label_divisor:
                _raise_cc_overflow(label, len(flat), label_divisor)
            flat_seg[label] = flat
        return flat_seg

    decoded = decode_runs_packed(row_buf, width)
    if decoded is None:
        return None
    v, r, s, e = decoded
    return runs_to_flat_seg(v, r, s, e, width, labels, label_divisor,
                            thing_list, force_connected)


def rle_seg_to_pan_seg(rle_seg: dict, shape) -> np.ndarray:
    """Paint the nested RLE dict into a dense uint32 map of ``shape``
    (instances in dict order, a later one over an earlier one)."""
    pan_seg = np.zeros(int(np.prod(shape)), dtype=np.uint32)
    fast = native.available()
    for instance_attrs in rle_seg.values():
        for object_id, attrs in instance_attrs.items():
            starts = np.asarray(attrs["starts"], dtype=np.int64)
            runs = np.asarray(attrs["runs"], dtype=np.int64)
            if len(starts) == 0:
                continue
            if fast:
                native.fill_ranges(pan_seg, np.stack([starts, starts + runs], axis=1),
                                   object_id)
            else:
                for s, r in zip(starts, runs):
                    pan_seg[s:s + r] = object_id
    return pan_seg.reshape(shape)


def unpack_rle_attrs(instance_rle_seg: dict):
    """One class's instance dict as parallel (labels, boxes, starts list,
    runs list); an instance may carry its RLE as an ``"rle"`` string."""
    labels, boxes, starts, runs = [], [], [], []
    for label, attrs in instance_rle_seg.items():
        labels.append(int(label))
        boxes.append(attrs["box"])
        if "rle" in attrs:
            s, r = string_to_rle(attrs["rle"])
        else:
            s, r = np.asarray(attrs["starts"]), np.asarray(attrs["runs"])
        starts.append(s)
        runs.append(r)
    return np.array(labels), np.array(boxes), starts, runs
