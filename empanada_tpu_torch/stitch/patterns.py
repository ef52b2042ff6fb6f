"""Orchestration of the 3D sweeps' host side and of the ortho-plane
consensus (counterpart of ``empanada_tpu/stitch/patterns.py``, the parts
the streamed sweeps and ``tracker_consensus`` use).

Forward matching runs on a ``threading.Thread`` fed through a bounded
``queue.Queue``: the device queue is asynchronous, so the host matcher
works on earlier slices while the card computes later ones.  Per-slice
record construction (connected components + RLE grouping) is independent
across slices and may run in a small thread pool; only matching must see
the slices in order.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from empanada_tpu_torch.core.chunked import ChunkedArray, chunked_fill_instances
from empanada_tpu_torch.core.labeling import FlatInstances, extract_runs
from empanada_tpu_torch.core.rle import numpy_fill_instances
from empanada_tpu_torch.stitch import filters as filters_mod
from empanada_tpu_torch.stitch.consensus import (
    merge_objects_from_trackers,
    merge_semantic_from_trackers,
)
from empanada_tpu_torch.stitch.matcher import RLEMatcher
from empanada_tpu_torch.stitch.rle_seg import packed_to_flat_seg, runs_to_flat_seg
from empanada_tpu_torch.stitch.tracker import InstanceTracker

__all__ = [
    "create_matchers",
    "create_axis_trackers",
    "apply_matchers",
    "apply_matchers_flat",
    "apply_filters",
    "build_flat_seg",
    "forward_matching",
    "MatcherWorker",
    "backward_matching",
    "update_trackers",
    "finish_tracking",
    "fill_volume",
    "fill_panoptic_volume",
    "get_axis_trackers_by_class",
    "create_instance_consensus",
    "create_semantic_consensus",
]

FINISH = "finish"


def create_matchers(thing_list, label_divisor, merge_iou_thr, merge_ioa_thr):
    return [
        RLEMatcher(tc, label_divisor, merge_iou_thr, merge_ioa_thr)
        for tc in thing_list
    ]


def create_axis_trackers(axes, class_labels, label_divisor, shape) -> dict:
    """{axis name: one ``InstanceTracker`` per class}."""
    return {axis_name: [InstanceTracker(class_id, label_divisor, shape, axis_name)
                        for class_id in class_labels]
            for axis_name in axes}


def apply_matchers(rle_seg: dict, matchers) -> dict:
    """``apply_matchers_flat`` on the nested form ``{class_id: {label:
    {"box", "starts", "runs"}}}``, in place."""
    for matcher in matchers:
        class_id = matcher.class_id
        flat = FlatInstances.from_dict(rle_seg[class_id])
        if not matcher.has_target():
            matcher.initialize_target_flat(flat)
        else:
            rle_seg[class_id] = matcher.match_flat(flat).to_dict()
    return rle_seg


def apply_filters(tracker, filters_list):
    """Apply the filters of ``stitch.filters`` named by ``filters_list``
    (``[{"name": ..., **kwargs}]``) to ``tracker`` in place."""
    for filt in filters_list or ():
        kwargs = {k: v for k, v in filt.items() if k != "name"}
        getattr(filters_mod, filt["name"])(tracker, **kwargs)


def apply_matchers_flat(flat_seg: dict, matchers) -> dict:
    """Forward-match one slice's ``{class_id: FlatInstances}`` in place: the
    first slice becomes each matcher's target."""
    for matcher in matchers:
        class_id = matcher.class_id
        if not matcher.has_target():
            matcher.initialize_target_flat(flat_seg[class_id])
        else:
            flat_seg[class_id] = matcher.match_flat(flat_seg[class_id])
    return flat_seg


def build_flat_seg(pan_seg, labels, label_divisor, thing_list,
                   force_connected: bool = True) -> dict:
    """``{class_id: FlatInstances}`` of one slice, from a dense (h, w) map or
    from a packed buffer ``("packed", row_buf, width)`` (one slice of
    ``ops.postprocess.encode_runs_packed``; decode, connected components and
    grouping in one native call).  Independent across slices."""
    if isinstance(pan_seg, tuple) and pan_seg[0] == "packed":
        _, row_buf, width = pan_seg
        flat_seg = packed_to_flat_seg(
            row_buf, width, labels, label_divisor, thing_list,
            force_connected=force_connected,
        )
        if flat_seg is None:
            raise ValueError("packed slice overflowed its run capacity")
        return flat_seg
    pan_seg = np.asarray(pan_seg)
    values, rows, cs, ce = extract_runs(pan_seg)
    return runs_to_flat_seg(
        values, rows, cs, ce, pan_seg.shape[1],
        labels, label_divisor, thing_list, force_connected=force_connected,
    )


def forward_matching(matchers, in_queue, rle_stack, labels, label_divisor,
                     thing_list, force_connected: bool = True, stats=None):
    """Consumer loop: slice -> flat seg -> forward match -> stack.

    Items of ``in_queue`` are what ``build_flat_seg`` takes, or a
    ``concurrent.futures.Future`` of a ``(flat_seg, build_seconds)`` pair
    from MatcherWorker's build pool (its exception re-raises here);
    ``None`` items are skipped and the ``FINISH`` sentinel ends the loop.

    ``stats`` (optional dict) accumulates ``busy_s``: seconds spent
    processing items in THIS loop, excluding queue waits — the sequential
    host-matcher cost even when it runs concurrently with device compute.
    Pool-built slices add their construction time under ``build_s``.
    """
    import time
    from concurrent.futures import Future

    while True:
        pan_seg = in_queue.get()
        if pan_seg is None:
            continue
        if isinstance(pan_seg, str):
            break
        if isinstance(pan_seg, Future):
            rle_seg, dt = pan_seg.result()
            if stats is not None:
                stats["build_s"] = stats.get("build_s", 0.0) + dt
            t0 = time.perf_counter()
        else:
            t0 = time.perf_counter()
            rle_seg = build_flat_seg(pan_seg, labels, label_divisor,
                                     thing_list, force_connected)
        rle_seg = apply_matchers_flat(rle_seg, matchers)
        rle_stack.append(rle_seg)
        if stats is not None:
            stats["busy_s"] = stats.get("busy_s", 0.0) + time.perf_counter() - t0
    return rle_stack


class MatcherWorker:
    """Thread running forward_matching concurrently with device inference.

    Slice-order matching is inherently sequential, but per-slice rle_seg
    construction (connected components + RLE grouping — the expensive half
    at EM instance densities) is not: ``put`` farms construction out to a
    small thread pool and enqueues ordered futures, so the matcher loop
    only pays ``apply_matchers`` per slice.  The native calls underneath
    release the GIL, so pool workers scale.

    A failure inside the thread must not deadlock the producer: the worker keeps draining the bounded queue after an error so
    ``put`` never blocks forever, and ``finish`` re-raises the exception."""

    def __init__(self, matchers, labels, label_divisor, thing_list,
                 maxsize: int = 8, force_connected: bool = True,
                 build_workers: int | None = None):
        import os

        self.queue = queue.Queue(maxsize=maxsize)
        self.rle_stack = []
        self.error = None
        # busy_s: sequential matcher-loop cost; build_s: summed parallel
        # seg-construction cost (wall overlap makes these non-additive)
        self.stats = {"busy_s": 0.0, "build_s": 0.0}
        if build_workers is None:
            # <= 3-core hosts: a pool is pure queue/context-switch overhead
            # (no parallelism to win); build inline in the matcher loop
            build_workers = min(3, max(0, (os.cpu_count() or 4) - 3))
        self._pool = None
        if build_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=build_workers,
                thread_name_prefix="segbuild",
            )
        self._build_args = (labels, label_divisor, thing_list, force_connected)
        self._thread = threading.Thread(target=self._run, args=(
            matchers, labels, label_divisor, thing_list, force_connected),
            daemon=True)
        self._thread.start()

    def _run(self, matchers, labels, label_divisor, thing_list, force_connected):
        try:
            forward_matching(
                matchers, self.queue, self.rle_stack, labels, label_divisor,
                thing_list, force_connected, stats=self.stats,
            )
        except BaseException as exc:  # noqa: BLE001 — re-raised in finish()
            self.error = exc
            # keep consuming so the producer's bounded put never blocks
            while True:
                item = self.queue.get()
                if isinstance(item, str):
                    break

    def _build(self, pan_seg):
        import time

        labels, label_divisor, thing_list, force_connected = self._build_args
        t0 = time.perf_counter()
        rle_seg = build_flat_seg(pan_seg, labels, label_divisor, thing_list,
                                 force_connected)
        return rle_seg, time.perf_counter() - t0

    def put(self, pan_seg):
        if self._pool is not None and pan_seg is not None \
                and not isinstance(pan_seg, str):
            self.queue.put(self._pool.submit(self._build, pan_seg))
        else:
            self.queue.put(pan_seg)

    def finish(self):
        self.queue.put(FINISH)
        self._thread.join()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self.error is not None:
            raise RuntimeError("matcher worker failed") from self.error
        return self.rle_stack


def backward_matching(rle_stack, matchers, axis_len: int):
    """Generator: reverse pass with assign_new=False, yielding
    (index, matched flat seg) per plane."""
    for matcher in matchers:
        matcher.reset_target()
        matcher.assign_new = False

    for rev_idx in range(axis_len - 1, -1, -1):
        rle_seg = rle_stack[rev_idx]
        for matcher in matchers:
            class_id = matcher.class_id
            flat = rle_seg[class_id]
            if not matcher.has_target():
                matcher.initialize_target_flat(flat)
            else:
                rle_seg[class_id] = matcher.match_flat(flat)
        yield rev_idx, rle_seg


def update_trackers(rle_seg, index, trackers):
    for tracker in trackers:
        tracker.update(rle_seg[tracker.class_id], index)


def finish_tracking(trackers):
    for tracker in trackers:
        tracker.finish()


def fill_volume(volume, instances: dict, processes: int = 4):
    """Paint ``instances`` into a numpy array or a ``ChunkedArray``, in
    place (a store chunk by chunk, in ``processes`` threads)."""
    if isinstance(volume, np.ndarray):
        numpy_fill_instances(volume, instances)
    elif isinstance(volume, ChunkedArray):
        chunked_fill_instances(volume, instances, processes)
    else:
        raise TypeError(f"Unknown volume type of {type(volume)}")


def fill_panoptic_volume(volume, trackers, processes: int = 4):
    """Paint every tracker's instances into ``volume`` (``fill_volume``)."""
    for tracker in trackers:
        fill_volume(volume, tracker.instances, processes)


def get_axis_trackers_by_class(trackers: dict, class_id: int) -> list:
    """The trackers of ``class_id`` from ``{axis: [trackers]}``, in axis
    order."""
    return [tracker for axis_trackers in trackers.values() for tracker in axis_trackers
            if tracker.class_id == class_id]


def _consensus_tracker(class_trackers, instances) -> InstanceTracker:
    first = class_trackers[0]
    tracker = InstanceTracker(first.class_id, first.label_divisor, first.shape3d, "xy")
    tracker.instances = instances
    tracker.finished = True
    return tracker


def create_instance_consensus(class_trackers, pixel_vote_thr: int = 2,
                              cluster_iou_thr: float = 0.75,
                              bypass: bool = False) -> InstanceTracker:
    """A finished tracker holding the instance consensus of one thing
    class's per-axis trackers."""
    return _consensus_tracker(class_trackers, merge_objects_from_trackers(
        class_trackers, pixel_vote_thr, cluster_iou_thr, bypass))


def create_semantic_consensus(class_trackers, pixel_vote_thr: int = 2) -> InstanceTracker:
    """A finished tracker holding the pixel vote of one semantic class's
    per-axis trackers."""
    return _consensus_tracker(class_trackers, merge_semantic_from_trackers(
        class_trackers, pixel_vote_thr))
