"""Crash-safe checkpoint/resume of the 3D sweeps (counterpart of
``empanada_tpu/stitch/checkpoint.py``, with its on-disk format: a directory
that either package wrote resumes in the other).

A checkpointed ``MultiChipEngine3d.infer_on_axis`` appends the forward-matched
slices to segment files (``forward_<axis>.<k>.npz``, columnar, no pickle)
every ``checkpoint_every`` slices.  A resumed sweep loads them, restarts the
device at the last whole batch boundary with the context batches the median
windows need, drops the slices it already has, and primes the matchers (the
last slice as target, the class's largest id so far as the watermark of
fresh ids), so its result is bit-identical to an uninterrupted sweep.
``infer_orthoplane`` also keeps each finished axis's trackers as JSON and
skips those axes on resume.  Every file carries the run's configuration, and
a resume from another configuration or volume raises.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from empanada_tpu_torch.core.labeling import FlatInstances

__all__ = [
    "ForwardCheckpoint",
    "save_forward_state",
    "load_forward_state",
    "axis_tracker_paths",
    "volume_fingerprint",
    "save_axis_trackers",
    "load_axis_trackers",
    "check_meta",
    "prime_matchers",
]

_FORMAT = "empanada_tpu-forward-v1"


def axis_tracker_paths(checkpoint_dir: str, axis_name: str, labels) -> list:
    return [os.path.join(checkpoint_dir, f"trackers_{axis_name}_{int(label)}.json")
            for label in labels]


def axis_tracker_meta_path(checkpoint_dir: str, axis_name: str) -> str:
    return os.path.join(checkpoint_dir, f"trackers_{axis_name}.meta.json")


def volume_fingerprint(volume) -> str:
    """Shape, dtype and a strided sample of three planes (first, middle,
    last) hashed together: tells a checkpoint of another volume of the same
    shape apart without reading the whole volume."""
    shape = tuple(int(s) for s in volume.shape)
    h = hashlib.sha1()
    h.update(repr((shape, str(np.dtype(volume.dtype)))).encode())
    for z in sorted({0, shape[0] // 2, shape[0] - 1}):
        plane = np.asarray(volume[z])
        sub = plane[:: max(1, plane.shape[0] // 64), :: max(1, plane.shape[1] // 64)]
        h.update(np.ascontiguousarray(sub).tobytes())
    return h.hexdigest()


def save_forward_state(path: str, rle_stack: list, meta: dict) -> None:
    """Write ``rle_stack`` (per slice ``{class_id: FlatInstances}``, or the
    nested dict form) atomically as one columnar ``.npz``: a (slice, class)
    group table and flat per-instance label, box and run arrays."""
    g_slice, g_class, g_inst_end = [], [], []
    labels_cat, boxes_cat, run_counts, starts_parts, runs_parts = [], [], [], [], []
    n_inst = 0
    for z, rle_seg in enumerate(rle_stack):
        for class_id, insts in rle_seg.items():
            flat = insts if isinstance(insts, FlatInstances) else FlatInstances.from_dict(insts)
            g_slice.append(z)
            g_class.append(int(class_id))
            n_inst += len(flat)
            g_inst_end.append(n_inst)
            if len(flat):
                labels_cat.append(flat.labels)
                boxes_cat.append(flat.boxes)
                run_counts.append(np.diff(flat.offsets))
                starts_parts.append(flat.starts)
                runs_parts.append(flat.runs)

    def cat(parts, width=None):
        if parts:
            return np.concatenate(parts)
        return np.empty((0,) if width is None else (0, width), dtype=np.int64)

    payload = {
        "format": np.array(_FORMAT),
        "meta": np.array(json.dumps(meta)),
        "n_slices": np.int64(len(rle_stack)),
        "g_slice": np.asarray(g_slice, np.int64),
        "g_class": np.asarray(g_class, np.int64),
        "g_inst_end": np.asarray(g_inst_end, np.int64),
        "inst_label": cat(labels_cat),
        "inst_box": cat(boxes_cat, width=4),
        "inst_run_count": cat(run_counts),
        "rle_starts": cat(starts_parts),
        "rle_runs": cat(runs_parts),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def load_forward_state(path: str):
    """Inverse of ``save_forward_state``: ``(rle_stack, meta)``, the stack's
    slices as ``{class_id: FlatInstances}``."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["format"]) != _FORMAT:
            raise ValueError(f"{path}: not a {_FORMAT} checkpoint")
        meta = json.loads(str(z["meta"]))
        n_slices = int(z["n_slices"])
        g_slice, g_class, g_inst_end = z["g_slice"], z["g_class"], z["g_inst_end"]
        inst_label, inst_box = z["inst_label"], z["inst_box"]
        run_offsets = np.concatenate([[0], np.cumsum(z["inst_run_count"], dtype=np.int64)])
        rle_starts, rle_runs = z["rle_starts"], z["rle_runs"]

    rle_stack = [{} for _ in range(n_slices)]
    g_inst_start = np.concatenate([[0], g_inst_end[:-1]])
    for gi in range(len(g_slice)):
        i0, i1 = int(g_inst_start[gi]), int(g_inst_end[gi])
        if i0 == i1:
            flat = FlatInstances.empty()
        else:
            r0, r1 = int(run_offsets[i0]), int(run_offsets[i1])
            flat = FlatInstances(inst_label[i0:i1], inst_box[i0:i1],
                                 run_offsets[i0:i1 + 1] - r0, rle_starts[r0:r1],
                                 rle_runs[r0:r1])
        rle_stack[int(g_slice[gi])][int(g_class[gi])] = flat
    return rle_stack, meta


class ForwardCheckpoint:
    """The forward state of one axis as numbered segments, each holding only
    the slices completed since the last save (O(new slices) a save), written
    atomically; ``load`` checks each segment's configuration and that the
    segments are contiguous."""

    def __init__(self, checkpoint_dir: str, axis_name: str, meta: dict):
        self.dir = checkpoint_dir
        self.axis = axis_name
        self.meta = meta
        self._next_segment = 0
        self._z_end = 0

    def _segment_path(self, k: int) -> str:
        return os.path.join(self.dir, f"forward_{self.axis}.{k:05d}.npz")

    def _existing_segments(self) -> list:
        out, k = [], 0
        while os.path.exists(self._segment_path(k)):
            out.append(self._segment_path(k))
            k += 1
        return out

    def exists(self) -> bool:
        return os.path.exists(self._segment_path(0))

    def load(self) -> list:
        """The saved slices 0 .. z_done - 1; raises on a configuration
        mismatch or a gap between segments."""
        stack = []
        for k, path in enumerate(self._existing_segments()):
            seg, meta = load_forward_state(path)
            z_start = meta.pop("_z_start")
            check_meta(meta, self.meta, path)
            if z_start != len(stack):
                raise ValueError(
                    f"{path}: segment starts at slice {z_start}, expected {len(stack)} — "
                    "the checkpoint directory holds mixed runs; delete it and rerun")
            stack.extend(seg)
            self._next_segment = k + 1
        self._z_end = len(stack)
        return stack

    def append(self, new_slices: list) -> None:
        """Save the next ``len(new_slices)`` completed slices."""
        if not new_slices:
            return
        meta = dict(self.meta, _z_start=self._z_end)
        save_forward_state(self._segment_path(self._next_segment), new_slices, meta)
        self._next_segment += 1
        self._z_end += len(new_slices)

    def remove(self) -> None:
        for path in self._existing_segments():
            os.remove(path)


def save_axis_trackers(checkpoint_dir: str, axis_name: str, trackers, meta: dict) -> None:
    """Write a finished axis's trackers, then (last, so that a crash while
    saving leaves nothing a resume accepts) the configuration beside them."""
    labels = [t.class_id for t in trackers]
    for tracker, path in zip(trackers, axis_tracker_paths(checkpoint_dir, axis_name, labels)):
        tracker.write_to_json(path)
    meta_path = axis_tracker_meta_path(checkpoint_dir, axis_name)
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def load_axis_trackers(checkpoint_dir: str, axis_name: str, meta: dict, make_trackers):
    """A finished axis's trackers (``make_trackers()`` filled from the
    JSON), or None when the axis has none; raises when they were written by
    another configuration or volume."""
    meta_path = axis_tracker_meta_path(checkpoint_dir, axis_name)
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        saved_meta = json.load(f)
    check_meta(saved_meta, meta, meta_path)
    trackers = make_trackers()
    paths = axis_tracker_paths(checkpoint_dir, axis_name, [t.class_id for t in trackers])
    if not all(os.path.exists(p) for p in paths):
        raise ValueError(f"{checkpoint_dir}: the trackers' meta exists for axis {axis_name} "
                         "but tracker files are missing — delete the checkpoint directory")
    for tracker, path in zip(trackers, paths):
        tracker.load_from_json(path)
    return trackers


def check_meta(meta: dict, expected: dict, path: str) -> None:
    """Refuse to resume when the run's configuration changed."""
    mismatched = {k: (meta.get(k), v) for k, v in expected.items() if meta.get(k) != v}
    if mismatched:
        raise ValueError(
            f"{path}: checkpoint was written by a different run configuration; "
            f"mismatched fields: {mismatched}. Delete the checkpoint or rerun with the "
            "original settings.")


def prime_matchers(matchers, rle_stack: list) -> None:
    """Matcher state as if ``rle_stack`` had just been matched: its last
    slice is each matcher's target, and fresh ids continue after the
    class's largest id over all its slices (an instance that appeared and
    ended must not have its id given again)."""
    if not rle_stack:
        return
    last = rle_stack[-1]
    for matcher in matchers:
        cid = matcher.class_id
        watermark = cid * matcher.label_divisor + 1
        for rle_seg in rle_stack:
            flat = rle_seg.get(cid)
            if flat is not None and len(flat):
                watermark = max(watermark, int(flat.labels.max()) + 1)
        matcher.update_target(last.get(cid, FlatInstances.empty()))
        matcher.next_label = watermark
