"""Runs of a panoptic slice -> per-class instance records (counterpart of
``empanada_tpu/stitch/rle_seg.py``, flat form only).

A slice arrives as runs (of a dense map, ``core.labeling.extract_runs``)
or as one slice of ``ops.postprocess.encode_runs_packed`` output, and leaves
as ``{class_id: FlatInstances}``: per class, optional connected components
over runs (thing classes with ``force_connected``), instance grouping and
canonical RLEs.
"""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.labeling import (
    FlatInstances,
    connected_components_runs,
    decode_runs_packed,
    runs_to_flat,
)

__all__ = ["runs_to_flat_seg", "packed_to_flat_seg"]


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
