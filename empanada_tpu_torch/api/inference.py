"""The public engines and the 3D finishes (counterpart of
``empanada_tpu/api/inference.py``).

- ``Engine2d``: one image to a panoptic map; images larger than
  ``tile_size`` go tile by tile (``stitch.tile.Tiler``) and the tiles'
  instances are merged (``stitch.consensus``); each tile's map is copied to
  the host while the next tile is dispatched.
- ``Engine3d``: a volume swept slice by slice along one axis through
  ``PanopticDeepLabRenderEngine3d`` (median over z), the forward matcher on
  a worker thread (``stitch.patterns.MatcherWorker``), backward matching,
  the filters, and the panoptic stack; ``infer_orthoplane`` sweeps the
  three axes; checkpoint and resume follow ``stitch/checkpoint.py``.
- ``stack_postprocessing`` and ``tracker_consensus``: per class, the
  volume of one sweep's tracker or of the consensus of three, in numpy or,
  with ``store_url``, in a chunked store ``<store_url>/<class_name>``.
- ``combine_panoptic_maps``: the maps of several models in one id space.

The engines take ``model=`` (a port model) where the JAX package takes
``model_and_variables``; ``model=None`` loads the config's bundle.  Like
every entry point of the port they run on ``device`` (default "cuda",
which raises without a GPU unless ``device="cpu"``); the finishes run on
the host but follow the same rule, so a CPU run is asked for.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from empanada_tpu_torch.api.utils import Preprocessor, load_model_from_config
from empanada_tpu_torch.core.chunked import create_chunked
from empanada_tpu_torch.core.labeling import connected_components_runs, extract_runs
from empanada_tpu_torch.data.volume import VolumeDataset, resize_by_factor
from empanada_tpu_torch.engine import (
    PanopticDeepLabRenderEngine,
    PanopticDeepLabRenderEngine3d,
)
from empanada_tpu_torch.parallel.spatial import SpatialEngine2d
from empanada_tpu_torch.stitch import checkpoint as ckpt
from empanada_tpu_torch.stitch import filters
from empanada_tpu_torch.stitch.consensus import (
    merge_objects_from_tiles,
    merge_semantic_from_tiles,
)
from empanada_tpu_torch.stitch.patterns import (
    MatcherWorker,
    backward_matching,
    create_instance_consensus,
    create_matchers,
    create_semantic_consensus,
    fill_panoptic_volume,
    fill_volume,
    finish_tracking,
    get_axis_trackers_by_class,
    update_trackers,
)
from empanada_tpu_torch.stitch.rle_seg import pan_seg_to_rle_seg, rle_seg_to_pan_seg
from empanada_tpu_torch.stitch.tile import Tiler
from empanada_tpu_torch.stitch.tracker import InstanceTracker
from empanada_tpu_torch.utils import Progress, StageTimer, resolve_device, to_host_async

__all__ = [
    "combine_panoptic_maps",
    "instance_relabel",
    "stack_postprocessing",
    "tracker_consensus",
    "Engine2d",
    "Engine3d",
]


def combine_panoptic_maps(pan_segs, configs, label_divisor: int = 1000):
    """The panoptic maps of several models in one id space: ``(combined,
    class_names)``.  Model order is priority order (a later model does not
    overwrite a pixel an earlier one labelled); model m's class c becomes
    ``offset_m + c``, ``offset_m`` the summed largest class ids of the
    models before it; instance ids are kept.  ``class_names`` maps each
    global class id to ``"<model_name>/<class_name>"``."""
    if len(pan_segs) != len(configs):
        raise ValueError(f"{len(pan_segs)} maps but {len(configs)} model configs")
    combined = None
    class_names: dict[int, str] = {}
    offset = 0
    for pan, config in zip(pan_segs, configs):
        pan = np.asarray(pan)
        model_name = config.get("model_name", config.get("arch", "model"))
        for cid, cname in (config.get("class_names") or {}).items():
            class_names[offset + int(cid)] = f"{model_name}/{cname}"
        cls = pan // label_divisor
        shifted = np.where(cls > 0, pan + offset * label_divisor, 0)
        if combined is None:
            combined = shifted
        else:
            if pan.shape != combined.shape:
                raise ValueError(f"panoptic map shapes differ: {pan.shape} vs "
                                 f"{combined.shape}")
            combined = np.where(combined == 0, shifted, combined)
        labels = [int(v) for v in (config.get("labels") or [0])]
        offset += max(max(labels), int(cls.max(initial=0)))
    return combined, class_names


def instance_relabel(tracker) -> dict:
    """A tracker's instances renumbered from 1, each RLE sorted by start."""
    instances = {}
    for instance_id, attrs in enumerate(tracker.instances.values(), start=1):
        starts = np.asarray(attrs["starts"])
        order = np.argsort(starts, kind="stable")
        instances[instance_id] = {"box": attrs["box"], "starts": starts[order],
                                  "runs": np.asarray(attrs["runs"])[order]}
    return instances


def _finish_class(tracker, class_name, is_thing: bool, store_url, min_size: int,
                  min_extent: int, dtype, chunk_size):
    """Filter a thing class's tracker, then fill its volume: numpy, or the
    chunked store ``<store_url>/<class_name>``."""
    if is_thing:
        filters.remove_small_objects(tracker, min_size=min_size)
        filters.remove_pancakes(tracker, min_span=min_extent)
    dtype = dtype if is_thing else np.uint8
    if store_url is not None:
        volume = create_chunked(f"{store_url.rstrip('/')}/{class_name}", tracker.shape3d,
                                chunk_size, dtype)
    else:
        volume = np.zeros(tracker.shape3d, dtype=dtype)
    fill_volume(volume, tracker.instances)
    return volume


def stack_postprocessing(trackers: dict, store_url, model_config: dict,
                         label_divisor: int = 1000, min_size: int = 200,
                         min_extent: int = 4, dtype=np.uint32,
                         chunk_size=(256, 256, 256), device=None):
    """Per class of ``model_config``: the first tracker of that class in
    ``{axis: trackers}``, relabelled from 1, filtered (thing classes) and
    filled; yields ``(volume, class_name, instances)``."""
    resolve_device(device)
    for class_id, class_name in model_config["class_names"].items():
        class_tracker = get_axis_trackers_by_class(trackers, class_id)[0]
        tracker = InstanceTracker(class_id, label_divisor, class_tracker.shape3d, "xy")
        tracker.instances = instance_relabel(class_tracker)
        tracker.finished = True
        volume = _finish_class(tracker, class_name, class_id in model_config["thing_list"],
                               store_url, min_size, min_extent, dtype, chunk_size)
        yield volume, class_name, tracker.instances


def tracker_consensus(trackers: dict, store_url, model_config: dict,
                      label_divisor: int = 1000, pixel_vote_thr: int = 2,
                      cluster_iou_thr: float = 0.75, allow_one_view: bool = False,
                      min_size: int = 200, min_extent: int = 4, dtype=np.uint32,
                      chunk_size=(256, 256, 256), device=None):
    """Per class of ``model_config``, the consensus of its trackers in
    ``{axis: trackers}``: instance consensus for thing classes (then
    filtered), the pixel vote for the others; yields ``(volume,
    class_name, instances)``."""
    resolve_device(device)
    thing_list = model_config["thing_list"]
    for class_id, class_name in model_config["class_names"].items():
        class_trackers = get_axis_trackers_by_class(trackers, class_id)
        if class_id in thing_list:
            tracker = create_instance_consensus(class_trackers, pixel_vote_thr,
                                                cluster_iou_thr, allow_one_view)
        else:
            tracker = create_semantic_consensus(class_trackers, pixel_vote_thr)
        volume = _finish_class(tracker, class_name, class_id in thing_list, store_url,
                               min_size, min_extent, dtype, chunk_size)
        yield volume, class_name, tracker.instances


def _fetch(handle) -> np.ndarray:
    """The host array of a ``to_host_async`` handle, once its copy is done."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


class Engine2d:
    """2D engine: ``infer(image)`` -> (H, W) int64 panoptic map.

    Images with a side above ``tile_size`` (when > 0) run as overlapping
    tiles (overlap ``min(128, tile_size // 10)``) whose instances are merged
    across tiles; otherwise thing instances are split into their connected
    components (``force_connected``).  ``inference_scale`` s downsamples the
    image (any dtype cv2 resizes) by s and renders ``2 + log2(s)`` PointRend steps back to
    full resolution.  ``shape_buckets`` pads each image (or tile) to the
    next size of the ladder (``ops.postprocess.bucket_dim``) instead of
    the next multiple of the padding factor, as JAX's engine does to bound
    its recompiles; the padding changes the map.  ``spatial_shard`` runs every
    image as one halo-sharded slice over the world's ranks
    (``parallel.spatial.SpatialEngine2d``; ``spatial_halo`` rows, the
    world ``spatial_mesh`` or ``parallel.mesh.create_mesh()``), then
    ``force_connected``; every rank returns the same map.
    ``last_overflow`` holds the NMS centres dropped on the worst slice of
    the last call, which a warning also reports.
    """

    def __init__(self, model_config: dict, inference_scale: int = 1,
                 label_divisor: int = 1000, nms_threshold: float = 0.1, nms_kernel: int = 3,
                 confidence_thr: float = 0.3, semantic_only: bool = False,
                 fine_boundaries: bool = False, tile_size: int = 0, max_centers: int = 256,
                 shape_buckets: bool = False, spatial_shard: bool = False,
                 spatial_halo: int = 128, spatial_mesh=None, model=None, device=None,
                 **kwargs):
        dev = resolve_device(device)
        if model is None:
            model = load_model_from_config(model_config, device=dev)
        self.model_config = model_config
        self.thing_list = model_config["thing_list"]
        self.labels = model_config["labels"]
        self.class_names = model_config["class_names"]
        self.label_divisor = label_divisor
        self.padding_factor = model_config.get("padding_factor", 128)
        self.inference_scale = inference_scale
        self.fine_boundaries = fine_boundaries
        self.tile_size = tile_size
        self.engine = PanopticDeepLabRenderEngine(
            model, thing_list=[] if semantic_only else self.thing_list,
            label_divisor=label_divisor, nms_threshold=nms_threshold, nms_kernel=nms_kernel,
            confidence_thr=confidence_thr, padding_factor=self.padding_factor,
            coarse_boundaries=not fine_boundaries, max_centers=max_centers,
            shape_buckets=shape_buckets, device=dev)
        self.spatial_engine = None
        if spatial_shard:
            self.spatial_engine = SpatialEngine2d(
                model, thing_list=[] if semantic_only else self.thing_list,
                mesh=spatial_mesh, halo=spatial_halo, label_divisor=label_divisor,
                nms_threshold=nms_threshold, nms_kernel=nms_kernel,
                confidence_thr=confidence_thr, padding_factor=self.padding_factor,
                coarse_boundaries=not fine_boundaries, max_centers=max_centers, device=dev)
        self.last_overflow = 0
        self.preprocessor = Preprocessor(**model_config["norms"])

    def update_params(self, inference_scale, label_divisor, nms_threshold, nms_kernel,
                      confidence_thr, fine_boundaries, semantic_only: bool = False,
                      tile_size: int = 0):
        """New thresholds and options for the next calls; the model stays."""
        self.inference_scale = inference_scale
        self.label_divisor = label_divisor
        self.fine_boundaries = fine_boundaries
        self.tile_size = tile_size
        self.engine.update_params(label_divisor=label_divisor, nms_threshold=nms_threshold,
                                  nms_kernel=nms_kernel, confidence_thr=confidence_thr,
                                  coarse_boundaries=not fine_boundaries)
        self.engine.thing_list = () if semantic_only else tuple(self.thing_list)
        if self.spatial_engine is not None:
            self.spatial_engine.update_params(
                label_divisor=label_divisor, nms_threshold=nms_threshold,
                nms_kernel=nms_kernel, confidence_thr=confidence_thr,
                coarse_boundaries=not fine_boundaries)

    def force_connected(self, pan_seg: np.ndarray) -> np.ndarray:
        """Relabel each thing class's instances as their 8-connected
        components, numbered from ``class_id * label_divisor``, in place."""
        for label in self.engine.thing_list:
            min_id = label * self.label_divisor
            inside = (pan_seg >= min_id) & (pan_seg < min_id + self.label_divisor)
            v, r, cs, ce = extract_runs(np.where(inside, pan_seg, 0))
            if len(v) == 0:
                continue
            comp = connected_components_runs(v, r, cs, ce, connectivity=8)
            for c, row, s, e in zip(comp, r, cs, ce):
                pan_seg[row, s:e] = c + min_id
        return pan_seg

    def _warn_overflow(self):
        dropped = self.engine.dropped_centers()
        self.last_overflow = dropped
        if dropped:
            print(f"warning: up to {dropped} NMS centers exceeded "
                  f"max_centers={self.engine.max_centers} and were dropped (instances "
                  "merged into nearest neighbors) — rerun with a larger max_centers",
                  file=sys.stderr)
        self.engine.reset_overflow()

    def _dispatch(self, image: np.ndarray):
        """Downsample, normalise and queue one image's device chain; the
        unfetched (H, W) map."""
        size = image.shape
        image = self.preprocessor(resize_by_factor(image, self.inference_scale))["image"]
        return self.engine.dispatch(image, size, upsampling=self.inference_scale)

    def infer(self, image: np.ndarray) -> np.ndarray:
        if self.spatial_engine is not None:
            size = image.shape
            prep = self.preprocessor(resize_by_factor(image, self.inference_scale))["image"]
            pan_seg = self.spatial_engine(prep[0],
                                          upsampling=self.inference_scale)
            return self.force_connected(pan_seg[:size[0], :size[1]].astype(np.int64))
        if self.tile_size > 0 and any(s > self.tile_size for s in image.shape):
            return self._infer_tiled(image)
        pan_seg = self._dispatch(image).cpu().numpy().astype(np.int64)
        self._warn_overflow()
        return self.force_connected(pan_seg)

    def _infer_tiled(self, image: np.ndarray) -> np.ndarray:
        tiler = Tiler(image.shape, tile_size=self.tile_size,
                      overlap_width=min(128, int(self.tile_size * 0.1)))
        rle_segs = []

        def drain(handle, idx):
            tile_rle = pan_seg_to_rle_seg(_fetch(handle), self.labels, self.label_divisor,
                                          self.engine.thing_list)
            rle_segs.append(tiler.translate_rle_seg(tile_rle, idx))

        # tile i's copy starts before tile i + 1 is dispatched, and its host
        # work runs while the card computes tile i + 1
        pending = None
        for i in range(len(tiler)):
            handle = to_host_async(self._dispatch(tiler(image, i)))
            if pending is not None:
                drain(*pending)
            pending = (handle, i)
        drain(*pending)

        rle_seg = {}
        for label in self.labels:
            tiles = [rs[label] for rs in rle_segs]
            if label in self.engine.thing_list:
                rle_seg[label] = merge_objects_from_tiles(tiles, tiler.overlap_rle)
            else:
                rle_seg[label] = merge_semantic_from_tiles(tiles)
        self._warn_overflow()
        return rle_seg_to_pan_seg(rle_seg, image.shape).astype(np.int64)


class Engine3d:
    """Per-slice 3D engine: ``infer_on_axis(volume, "xy")`` -> ``(stack,
    trackers)``, ``infer_orthoplane(volume)`` -> ``{axis: trackers}``.

    Each slice goes through ``PanopticDeepLabRenderEngine3d`` (median over
    z of ``median_kernel_size`` slices); its map is copied to the host
    while the next slice is dispatched and then forward-matched on a worker
    thread.  After backward matching, the trackers are filtered by size and
    extent, then optionally eroded, dilated and hole-filled (``label_*``,
    ``fill_holes_in_segmentation``).  ``save_panoptic`` fills the stack,
    into ``<store_url>/panoptic_<axis>`` when ``store_url`` is set.  The
    batched counterpart is ``parallel.data_parallel.MultiChipEngine3d``.
    """

    def __init__(self, model_config: dict, inference_scale: int = 1,
                 label_divisor: int = 1000, median_kernel_size: int = 5,
                 stuff_area: int = 64, void_label: int = 0, nms_threshold: float = 0.1,
                 nms_kernel: int = 3, confidence_thr: float = 0.3,
                 force_connected: bool = True, min_size: int = 500, min_extent: int = 4,
                 fine_boundaries: bool = False, semantic_only: bool = False,
                 store_url=None, chunk_size=(256, 256, 256), save_panoptic: bool = False,
                 label_erosion: int = 0, label_dilation: int = 0,
                 fill_holes_in_segmentation: bool = False, max_centers: int = 256,
                 shape_buckets: bool = False, merge_iou_thr: float = 0.25,
                 merge_ioa_thr: float = 0.25, model=None, device=None, **kwargs):
        dev = resolve_device(device)
        if model is None:
            model = load_model_from_config(model_config, device=dev)
        self.model_config = model_config
        self.labels = model_config["labels"]
        self.class_names = model_config["class_names"]
        self.label_divisor = label_divisor
        self.padding_factor = model_config.get("padding_factor", 128)
        self.inference_scale = inference_scale
        self.label_erosion = label_erosion
        self.label_dilation = label_dilation
        self.fill_holes_in_segmentation = fill_holes_in_segmentation
        self.thing_list = [] if semantic_only else model_config["thing_list"]
        self.engine = PanopticDeepLabRenderEngine3d(
            model, thing_list=self.thing_list, median_kernel_size=median_kernel_size,
            label_divisor=label_divisor, stuff_area=stuff_area, void_label=void_label,
            nms_threshold=nms_threshold, nms_kernel=nms_kernel,
            confidence_thr=confidence_thr, padding_factor=self.padding_factor,
            coarse_boundaries=not fine_boundaries, max_centers=max_centers,
            shape_buckets=shape_buckets, device=dev)
        self.last_overflow = 0
        self.preprocessor = Preprocessor(**model_config["norms"])
        self.axes = {"xy": 0, "xz": 1, "yz": 2}
        self.merge_iou_thr = float(merge_iou_thr)
        self.merge_ioa_thr = float(merge_ioa_thr)
        self.force_connected = force_connected
        self.min_size = min_size
        self.min_extent = min_extent
        self.fine_boundaries = fine_boundaries
        self.save_panoptic = save_panoptic
        self.chunk_size = chunk_size
        self.store_url = store_url
        self.dtype = np.int32

    def create_trackers(self, shape3d, axis_name):
        return [InstanceTracker(label, self.label_divisor, shape3d, axis_name)
                for label in self.labels]

    def create_panoptic_stack(self, axis_name, shape3d):
        if not self.save_panoptic:
            return None
        if self.store_url is not None:
            return create_chunked(f"{self.store_url.rstrip('/')}/panoptic_{axis_name}",
                                  shape3d, self.chunk_size, self.dtype)
        return np.zeros(shape3d, dtype=self.dtype)

    def _checkpoint_meta(self, volume, axis_name: str) -> dict:
        """The run's configuration as the JAX ``Engine3d`` records it: a
        resume under another one raises."""
        return {
            "axis_name": axis_name,
            "volume_shape": list(volume.shape),
            "volume_fingerprint": ckpt.volume_fingerprint(volume),
            "label_divisor": self.label_divisor,
            "labels": [int(c) for c in self.labels],
            "thing_list": [int(c) for c in self.thing_list],
            "inference_scale": self.inference_scale,
            "median_kernel_size": self.engine.median.ks,
            "force_connected": self.force_connected,
            "merge_iou_thr": self.merge_iou_thr,
            "merge_ioa_thr": self.merge_ioa_thr,
            "model_name": self.model_config.get("model_name", ""),
        }

    def infer_on_axis(self, volume, axis_name: str, timer=None, checkpoint_dir=None,
                      checkpoint_every: int = 64, resume: bool = False,
                      progress: bool = False):
        """(Z, H, W) integer volume (numpy or ``ChunkedArray``) swept slice
        by slice along ``axis_name`` -> ``(stack, trackers)``.

        ``timer`` (a ``StageTimer``) collects the host stages, reported in
        ``last_timing``; ``progress`` prints a counter on stderr.  With
        ``checkpoint_dir`` the forward-matched slices are saved every
        ``checkpoint_every`` slices, and ``resume`` continues from them,
        identical to an uninterrupted sweep; the files go when the axis
        completes."""
        timer = timer or StageTimer()
        axis = self.axes[axis_name]
        # an aborted run leaves a dirty median window
        self.engine.median.reset()
        loaded_stack, fc = [], None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            fc = ckpt.ForwardCheckpoint(checkpoint_dir, axis_name,
                                        self._checkpoint_meta(volume, axis_name))
            if resume and fc.exists():
                loaded_stack = fc.load()
        start = len(loaded_stack)
        # re-prime the median window from mid slices before the resume
        # point and drop their outputs, which the checkpoint holds
        mid = (self.engine.median.ks - 1) // 2
        feed_from = max(0, start - mid)
        drop = start - feed_from
        dataset = VolumeDataset(volume, axis, self.preprocessor, scale=self.inference_scale,
                                start=feed_from)
        trackers = self.create_trackers(volume.shape, axis_name)
        matchers = create_matchers(self.thing_list, self.label_divisor, self.merge_iou_thr,
                                   self.merge_ioa_thr)
        ckpt.prime_matchers(matchers, loaded_stack)
        stack = self.create_panoptic_stack(axis_name, volume.shape)
        worker = MatcherWorker(matchers, self.labels, self.label_divisor, self.thing_list,
                               force_connected=self.force_connected)
        bar = Progress(total=volume.shape[axis], desc=f"axis {axis_name}", enabled=progress)
        bar.n = start
        emitted = last_saved = 0

        def put(pan_seg: np.ndarray):
            nonlocal emitted, last_saved
            emitted += 1
            if emitted <= drop:
                return
            worker.put(pan_seg)
            bar.update()
            if fc is not None:
                done = len(worker.rle_stack)  # append-only: its prefix is final
                if done - last_saved >= checkpoint_every:
                    fc.append(worker.rle_stack[last_saved:done])
                    last_saved = done

        # slice i's copy starts before slice i + 1 is dispatched and is
        # handed to the matcher after that dispatch
        pending = None
        try:
            with timer.stage("device_inference+forward_matching"):
                for batch in dataset:
                    pan = self.engine.dispatch(batch["image"], batch["size"],
                                               self.inference_scale)
                    handle = None if pan is None else to_host_async(pan)
                    if pending is not None:
                        put(_fetch(pending))
                    pending = handle
                if pending is not None:
                    put(_fetch(pending))
                for pan in self.engine.end(self.inference_scale):
                    put(pan)
        finally:
            rle_stack = loaded_stack + worker.finish()
        bar.close()

        dropped = self.engine.dropped_centers()
        self.last_overflow = dropped
        if dropped:
            print(f"warning: axis {axis_name}: up to {dropped} NMS centers per slice "
                  f"exceeded max_centers={self.engine.max_centers} and were dropped "
                  "(instances merged into nearest neighbors) — rerun with a larger "
                  "max_centers", file=sys.stderr)
        self.engine.reset_overflow()

        with timer.stage("backward_matching"):
            for index, rle_seg in backward_matching(rle_stack, matchers, volume.shape[axis]):
                update_trackers(rle_seg, index, trackers)
        finish_tracking(trackers)
        morph = [(self.label_erosion, filters.erode), (self.label_dilation, filters.dilate)]
        for tracker in trackers:
            filters.remove_small_objects(tracker, min_size=self.min_size)
            filters.remove_pancakes(tracker, min_span=self.min_extent)
        for iterations, fn in morph:
            if iterations > 0:
                for tracker in trackers:
                    fn(tracker, volume.shape, self.labels, self.label_divisor,
                       self.thing_list, iterations=iterations)
        if self.fill_holes_in_segmentation:
            for tracker in trackers:
                filters.fill_holes_in_segmentation(tracker, volume.shape, self.labels,
                                                   self.label_divisor, self.thing_list)
        if stack is not None:
            with timer.stage("fill_volume"):
                fill_panoptic_volume(stack, trackers)
        if fc is not None:
            fc.remove()  # the axis is complete; its partial state is stale
        self.engine.median.reset()
        self.last_timing = timer.report()
        return stack, trackers

    def infer_orthoplane(self, volume, checkpoint_dir=None, checkpoint_every: int = 64,
                         resume: bool = False, progress: bool = False) -> dict:
        """The xy, xz and yz sweeps -> ``{axis: trackers}`` for
        ``tracker_consensus``.  With ``checkpoint_dir`` each finished axis
        saves its trackers and a ``resume`` skips it; a partial axis
        continues from its forward checkpoint."""
        trackers = {}
        for axis_name in self.axes:
            meta = self._checkpoint_meta(volume, axis_name) if checkpoint_dir else None
            if checkpoint_dir is not None and resume:
                loaded = ckpt.load_axis_trackers(
                    checkpoint_dir, axis_name, meta,
                    lambda: self.create_trackers(volume.shape, axis_name))
                if loaded is not None:
                    trackers[axis_name] = loaded
                    continue
            _, trackers[axis_name] = self.infer_on_axis(
                volume, axis_name, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume, progress=progress)
            if checkpoint_dir is not None:
                ckpt.save_axis_trackers(checkpoint_dir, axis_name, trackers[axis_name], meta)
        return trackers
