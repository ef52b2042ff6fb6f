"""The 3D finishes of the CLI's ``infer3d`` (counterpart of
``empanada_tpu/api/inference.py``, its stack postprocessing and ortho-plane
consensus): ``stack_postprocessing`` for one sweep (``--axis``) and
``tracker_consensus`` for the three sweeps of
``MultiChipEngine3d.infer_orthoplane`` (``--orthoplane``).  Both are
generators yielding one ``(volume, class_name, instances)`` per class, the
volume a numpy array (chunked stores, ``store_url``, are ROADMAP item 8).

Both run on the host.  They follow the port's entry-point device rule all
the same: ``device=None`` means "cuda" and raises without a GPU unless the
caller passes ``device="cpu"``, so a CPU run is asked for, not fallen into.
"""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core.rle import numpy_fill_instances
from empanada_tpu_torch.stitch import filters
from empanada_tpu_torch.stitch.patterns import (
    create_instance_consensus,
    create_semantic_consensus,
    get_axis_trackers_by_class,
)
from empanada_tpu_torch.stitch.tracker import InstanceTracker
from empanada_tpu_torch.utils import resolve_device

__all__ = ["instance_relabel", "stack_postprocessing", "tracker_consensus"]


def instance_relabel(tracker) -> dict:
    """A tracker's instances renumbered from 1, each RLE sorted by start."""
    instances = {}
    for instance_id, attrs in enumerate(tracker.instances.values(), start=1):
        starts = np.asarray(attrs["starts"])
        order = np.argsort(starts, kind="stable")
        instances[instance_id] = {"box": attrs["box"], "starts": starts[order],
                                  "runs": np.asarray(attrs["runs"])[order]}
    return instances


def _check_store(store_url):
    if store_url is not None:
        raise NotImplementedError(
            "store_url: the port fills numpy volumes only; chunked stores are "
            "ROADMAP item 8")


def _finish_class(tracker, is_thing: bool, min_size: int, min_extent: int, dtype):
    """Filter a thing class's tracker, then fill its volume."""
    if is_thing:
        filters.remove_small_objects(tracker, min_size=min_size)
        filters.remove_pancakes(tracker, min_span=min_extent)
    volume = np.zeros(tracker.shape3d, dtype=dtype if is_thing else np.uint8)
    numpy_fill_instances(volume, tracker.instances)
    return volume


def stack_postprocessing(trackers: dict, store_url, model_config: dict,
                         label_divisor: int = 1000, min_size: int = 200,
                         min_extent: int = 4, dtype=np.uint32, device=None):
    """Per class of ``model_config``: the first tracker of that class in
    ``{axis: trackers}``, relabelled from 1, filtered (thing classes) and
    filled; yields ``(volume, class_name, instances)``."""
    resolve_device(device)
    _check_store(store_url)
    for class_id, class_name in model_config["class_names"].items():
        class_tracker = get_axis_trackers_by_class(trackers, class_id)[0]
        tracker = InstanceTracker(class_id, label_divisor, class_tracker.shape3d, "xy")
        tracker.instances = instance_relabel(class_tracker)
        tracker.finished = True
        volume = _finish_class(tracker, class_id in model_config["thing_list"], min_size,
                               min_extent, dtype)
        yield volume, class_name, tracker.instances


def tracker_consensus(trackers: dict, store_url, model_config: dict,
                      label_divisor: int = 1000, pixel_vote_thr: int = 2,
                      cluster_iou_thr: float = 0.75, allow_one_view: bool = False,
                      min_size: int = 200, min_extent: int = 4, dtype=np.uint32,
                      device=None):
    """Per class of ``model_config``, the consensus of its trackers in
    ``{axis: trackers}``: instance consensus for thing classes (then
    filtered), the pixel vote for the others; yields ``(volume,
    class_name, instances)``."""
    resolve_device(device)
    _check_store(store_url)
    thing_list = model_config["thing_list"]
    for class_id, class_name in model_config["class_names"].items():
        class_trackers = get_axis_trackers_by_class(trackers, class_id)
        if class_id in thing_list:
            tracker = create_instance_consensus(class_trackers, pixel_vote_thr,
                                                cluster_iou_thr, allow_one_view)
        else:
            tracker = create_semantic_consensus(class_trackers, pixel_vote_thr)
        volume = _finish_class(tracker, class_id in thing_list, min_size, min_extent,
                               dtype)
        yield volume, class_name, tracker.instances
