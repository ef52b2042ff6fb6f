"""Batched 3D inference on one card (counterpart of
``empanada_tpu/parallel/data_parallel.py``: its streamed ``infer_on_axis``
path with a mesh of one device).

Each sweep (``infer_on_axis`` along xy, xz or yz; ``infer_orthoplane``
runs the three in turn) takes the volume's slices along one axis and
puts them through the model ``b`` at a time.  Per batch the device runs the
forward (uint8 slices normalised on the card), the median over z from a
rolling context of sem batches, the batched postprocess and the run-length
packing (``ops.postprocess.encode_runs_packed``); only the packed int16 rows
cross to the host, through an asynchronous copy into pinned memory.  A
drainer thread waits on each copy's CUDA event, then feeds the rows to the
forward matcher (``stitch.patterns.MatcherWorker``) while the card computes
the next batch.  The host then matches backwards, tracks, filters and
optionally fills the panoptic volume.

Boundary semantics match the median queue: slices closer than
``mid = (ks - 1) // 2`` to either end of the stack pass through unmedianed.

Not ported yet, and refused with ``NotImplementedError`` naming its ROADMAP
item: the whole-sweep fused path and the device-resident volume
(``sweep_fused``, A6c), checkpoint/resume (A6d), ``inference_scale > 1``
(A6e) and chunked stores (``store_url``, item 8).
"""

from __future__ import annotations

import math
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from empanada_tpu_torch.data.volume import VolumeDataset, factor_pad_numpy
from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.stitch import filters
from empanada_tpu_torch.stitch.patterns import (
    MatcherWorker,
    backward_matching,
    create_matchers,
    fill_panoptic_volume,
    finish_tracking,
    update_trackers,
)
from empanada_tpu_torch.stitch.tracker import InstanceTracker
from empanada_tpu_torch.utils import StageTimer, resolve_device

__all__ = ["MultiChipEngine3d"]

# the auto batch carries about this many padded model-input pixels, up to
# this many slices (the JAX engine's defaults)
AUTO_BATCH_TARGET_PX = 8 << 20
AUTO_BATCH_MAX = 256


class MultiChipEngine3d:
    """Batched 3D inference engine (the JAX package's class of this name,
    on one card): ``infer_on_axis(volume, "xy")`` -> ``(stack, trackers)``.

    ``model`` is a port model (``empanada_tpu_torch.models``); it is moved
    to ``device`` (default "cuda", which raises without a GPU unless
    ``device="cpu"``) and computes in its own parameter dtype.
    """

    def __init__(
        self,
        model_config: dict,
        model,
        inference_scale: int = 1,
        label_divisor: int = 1000,
        median_kernel_size: int = 3,
        stuff_area: int = 64,
        void_label: int = 0,
        nms_threshold: float = 0.1,
        nms_kernel: int = 3,
        confidence_thr: float = 0.3,
        semantic_only: bool = False,
        fine_boundaries: bool = False,
        min_size: int = 500,
        min_extent: int = 4,
        max_centers: int = 256,
        batch_size: Optional[int] = None,
        save_panoptic: bool = False,
        merge_iou_thr: float = 0.25,
        merge_ioa_thr: float = 0.25,
        force_connected: bool = True,
        store_url=None,
        sweep_fused: bool = False,
        device=None,
    ):
        if median_kernel_size % 2 != 1:
            raise ValueError("median_kernel_size must be an odd integer")
        if inference_scale != 1:
            raise NotImplementedError(
                f"inference_scale={inference_scale}: the port runs at scale 1 only; "
                "the downsample without cv2 is ROADMAP item A6e")
        if store_url is not None:
            raise NotImplementedError(
                "store_url: the port fills numpy volumes only; chunked stores are "
                "ROADMAP item 8")
        if sweep_fused:
            raise NotImplementedError(
                "sweep_fused: the port runs the streamed sweep only; the whole-sweep "
                "fused path, the device-resident volume and the pipelined "
                "infer_orthoplane are ROADMAP item A6c")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.model_config = model_config
        self.labels = model_config["labels"]
        self.class_names = model_config["class_names"]
        self.label_divisor = int(label_divisor)
        self.padding_factor = model_config.get("padding_factor", 128)
        self.thing_list = () if semantic_only else tuple(model_config["thing_list"])
        self.stuff_area = int(stuff_area)
        self.void_label = int(void_label)
        self.nms_threshold = float(nms_threshold)
        self.nms_kernel = int(nms_kernel)
        self.confidence_thr = float(confidence_thr)
        self.coarse_boundaries = not fine_boundaries
        self.max_centers = int(max_centers)
        self.num_classes = int(model.num_classes) + 1
        self.ks = median_kernel_size
        self.mid = (median_kernel_size - 1) // 2
        self.min_size = min_size
        self.min_extent = min_extent
        self.merge_iou_thr = float(merge_iou_thr)
        self.merge_ioa_thr = float(merge_ioa_thr)
        self.force_connected = bool(force_connected)
        self.batch_size = batch_size
        self.save_panoptic = save_panoptic
        self.mean = float(model_config["norms"]["mean"])
        self.std = float(model_config["norms"]["std"])
        self.last_overflow = 0
        self.axes = {"xy": 0, "xz": 1, "yz": 2}

    # ------------------------------------------------------------------
    def _max_runs(self, width: int) -> int:
        """Per-row run capacity of the packed transfer; 0 sends dense maps.

        int16 packing needs pan ids < 65536 and column indices < 32768."""
        if self.num_classes * self.label_divisor > 65535 or width > 32767:
            return 0
        return min(max(32, width // 8), int(width))

    def _resolve_batch(self, volume_shape, axis: int) -> int:
        """Per-axis batch size: explicit if given, else scaled so one batch
        carries ~AUTO_BATCH_TARGET_PX padded model-input pixels, capped by
        the axis length and AUTO_BATCH_MAX, then snapped down to the
        smallest batch with the same number of batches."""
        if self.batch_size is not None:
            return self.batch_size
        dims = [s for i, s in enumerate(volume_shape) if i != axis]
        area = max(1, math.prod(d + (-d) % self.padding_factor for d in dims))
        n_slices = volume_shape[axis]
        b = max(1, round(AUTO_BATCH_TARGET_PX / area))
        b = min(b, max(1, n_slices), AUTO_BATCH_MAX)
        n_batches = -(-n_slices // b)
        return max(1, -(-n_slices // n_batches))

    def _batches(self, dataset: VolumeDataset, b: int):
        """Yield (images (B, H, W) padded + stacked, size); the tail batch is
        padded with copies of the last slice."""
        batch_imgs, size = [], None
        for item in dataset:
            size = item["size"]
            batch_imgs.append(factor_pad_numpy(item["image"], self.padding_factor))
            if len(batch_imgs) == b:
                yield np.stack(batch_imgs), size
                batch_imgs = []
        if batch_imgs:
            batch_imgs += [batch_imgs[-1]] * (b - len(batch_imgs))
            yield np.stack(batch_imgs), size

    def normalize(self, x: torch.Tensor, max_value: float) -> torch.Tensor:
        """Raw integer slices (B, H, W) on the device -> model input
        (B, H, W, 1): ``(x / max_value - mean) / std`` in float32, cast to
        the model's dtype at its input, as the JAX engine's float32
        normaliser feeds its bf16 convolutions."""
        return ((x[..., None].float() / max_value - self.mean) / self.std).to(self.dtype)

    @torch.no_grad()
    def _forward(self, images: np.ndarray, max_value: float, render_steps: int):
        """Raw integer slices (B, H, W) on the host -> (sem in median
        space, ctr, off) on the device; uint8 crosses to the card as it is."""
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            x = x.pin_memory()
        x = self.normalize(x.to(self.device, non_blocking=True), max_value)
        out = self.model(x, render_steps=render_steps,
                         interpolate_ins=not self.coarse_boundaries)
        return pp.to_median_space(out["sem_logits"]), out["ctr_hmp"], out["offsets"]

    @torch.no_grad()
    def _post_batch(self, sem_ctx, ctr, off, win_idx, use_median, upsampling, crop,
                    max_runs):
        """Median over sliding windows gathered from the rolling context of
        sem batches, then the batched panoptic merge, the crop and (with
        ``max_runs > 0``) the run-length packing.  Returns (pans, packed or
        None, worst center overflow of the batch), all on the device."""
        stack = torch.cat(sem_ctx, dim=0)                    # ((2K+1)B, H, W, C)
        windows = stack[torch.as_tensor(win_idx, device=stack.device)]
        # an odd-window median is a selection: exact in float32 and equal
        # to the JAX engine's median in its compute dtype
        med = windows.float().median(dim=1).values.to(windows.dtype)
        raw = windows[:, self.mid]
        use = torch.as_tensor(use_median, device=stack.device)[:, None, None, None]
        sem = torch.where(use, med, raw)
        cells, n_over = pp.get_instance_cells(
            ctr, off, self.coarse_boundaries, upsampling, self.nms_threshold,
            self.nms_kernel, self.max_centers, return_overflow=True, keep_coarse=True)
        step = int(upsampling) * (4 if self.coarse_boundaries else 1)
        sem_h = pp.harden_median_space(sem, self.confidence_thr)
        pans = pp.merge_semantic_and_instance_coarse(
            sem_h, cells, self.label_divisor, self.thing_list, self.stuff_area,
            self.void_label, self.num_classes, self.max_centers, step=step)
        h, w = crop
        pans = pans[:, :h, :w]
        packed = pp.encode_runs_packed(pans, max_runs) if max_runs > 0 else None
        return pans, packed, n_over.max()

    def _to_host(self, t: torch.Tensor):
        """Start the device-to-host copy of ``t``: (host tensor, CUDA event
        recorded after the copy, or None on the CPU).  The host bytes may be
        read only after the event has completed."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # ------------------------------------------------------------------
    def infer_on_axis(self, volume: np.ndarray, axis_name: str,
                      timer: Optional[StageTimer] = None, checkpoint_dir=None,
                      resume: bool = False):
        """(Z, H, W) integer volume, swept along ``axis_name`` ("xy", "xz"
        or "yz") -> ``(stack, trackers)``: the filled panoptic volume
        (int32, or None unless ``save_panoptic``) and one finished
        ``InstanceTracker`` per label.  ``timer`` collects host stages;
        ``last_timing`` holds its report afterwards."""
        if axis_name not in self.axes:
            raise ValueError(f"axis {axis_name!r}: expected one of {list(self.axes)}")
        if checkpoint_dir is not None or resume:
            raise NotImplementedError(
                "checkpoint_dir / resume: checkpointing the sweep is ROADMAP item A6d")
        if not np.issubdtype(np.dtype(volume.dtype), np.integer):
            raise TypeError("input volume cannot be float type")
        timer = timer or StageTimer()
        axis = self.axes[axis_name]
        n_slices = volume.shape[axis]
        render_steps = 2  # coarse 1/4 -> full resolution at scale 1
        b = self._resolve_batch(volume.shape, axis)
        self.last_batch_size = b
        mid = self.mid
        # context batches needed on each side so every window [i-mid, i+mid]
        # is covered
        K = -(-mid // b)
        n_batches = -(-n_slices // b)
        max_value = float(np.iinfo(volume.dtype).max)
        dataset = VolumeDataset(volume, axis, None)

        trackers = [InstanceTracker(label, self.label_divisor, volume.shape, axis_name)
                    for label in self.labels]
        matchers = create_matchers(self.thing_list, self.label_divisor,
                                   self.merge_iou_thr, self.merge_ioa_thr)
        worker = MatcherWorker(matchers, self.labels, self.label_divisor, self.thing_list,
                               force_connected=self.force_connected)

        # only a median-kernel-deep rolling window of sem batches (plus the
        # current batch's ctr/off) lives on the device
        batch_gen = self._batches(dataset, b)
        sem_buf: dict = {}   # batch index -> sem (B, H, W, C)
        io_buf: dict = {}    # batch index -> (ctr, off)
        fwd_done = -1
        size = None

        def ensure_forwarded(upto: int):
            nonlocal fwd_done, size
            while fwd_done < min(upto, n_batches - 1):
                with timer.stage("host_prep"):
                    images, size = next(batch_gen)
                with timer.stage("forward_dispatch"):
                    sem, ctr, off = self._forward(images, max_value, render_steps)
                fwd_done += 1
                sem_buf[fwd_done] = sem
                io_buf[fwd_done] = (ctr, off)

        def drain(pending):
            """Wait for one batch's copy, then feed its slices to the
            matcher: packed rows, or the dense map of a slice whose rows
            overflowed their run capacity (``pans_dev`` is None when the
            copy holds the dense maps)."""
            host, event, n_keep, pans_dev = pending
            with timer.stage("fetch"):
                if event is not None:
                    event.synchronize()
                host_np = host.numpy()[:n_keep]
            with timer.stage("host_decode+enqueue"):
                if pans_dev is None:
                    for pan in host_np:
                        worker.put(pan.astype(np.int64))
                    return
                rcap = (host_np.shape[-1] - 1) // 2
                over = host_np[..., -1].max(axis=-1) > rcap
                w = pans_dev.shape[-1]
                for bi, row_buf in enumerate(host_np):
                    if over[bi]:
                        worker.put(pans_dev[bi].cpu().numpy().astype(np.int64))
                    else:
                        worker.put(("packed", row_buf, w))

        # drainer thread: fetch + decode + enqueue off the dispatch path;
        # the bounded queue keeps at most two undrained batches (each pins
        # its device maps)
        drain_q: queue.Queue = queue.Queue(maxsize=2)
        drain_err = []

        def _drain_loop():
            try:
                while True:
                    item = drain_q.get()
                    if item is None:
                        return
                    drain(item)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                drain_err.append(exc)
                while drain_q.get() is not None:
                    pass

        drainer = threading.Thread(target=_drain_loop, daemon=True)
        drainer.start()

        overflow_dev = None
        max_runs = None
        try:
            with timer.stage("device_stream+forward_matching"):
                for j in range(n_batches):
                    ensure_forwarded(j + K)
                    base = j - K
                    ctx = tuple(sem_buf[min(max(base + i, 0), n_batches - 1)]
                                for i in range(2 * K + 1))
                    start, stop = j * b, min((j + 1) * b, n_slices)
                    idxs = np.arange(start, stop)
                    # sliding windows clamped at the edges; edge slices keep
                    # their raw sem
                    win_idx = np.clip(idxs[:, None] + np.arange(-mid, mid + 1)[None, :],
                                      0, n_slices - 1)
                    use_median = (idxs >= mid) & (idxs < n_slices - mid)
                    if stop - start < b:
                        pad = b - (stop - start)
                        win_idx = np.concatenate([win_idx, np.repeat(win_idx[-1:], pad, 0)])
                        use_median = np.concatenate([use_median, np.zeros(pad, bool)])
                    # global slice index -> position in the concatenated
                    # context: batch g // b sits at slot g // b - base
                    win_local = (win_idx // b - base) * b + win_idx % b
                    ctr, off = io_buf.pop(j)
                    h, w = size
                    if max_runs is None:
                        max_runs = self._max_runs(w)
                    with timer.stage("post_dispatch"):
                        pans, packed, n_over = self._post_batch(
                            ctx, ctr, off, win_local, use_median, 1, (h, w), max_runs)
                        overflow_dev = (n_over if overflow_dev is None
                                        else torch.maximum(overflow_dev, n_over))
                        # start the copy now, so it overlaps the next batch
                        host, event = self._to_host(packed if packed is not None else pans)
                    if drain_err:
                        break
                    # the padded tail slices never reach the matcher
                    drain_q.put((host, event, stop - start,
                                 pans if packed is not None else None))
                    for k in list(sem_buf):
                        if k < j + 1 - K:
                            del sem_buf[k]
        finally:
            drain_q.put(None)
            drainer.join()
            rle_stack = worker.finish()
        if drain_err:
            raise drain_err[0]
        timer.add("matcher_busy", worker.stats["busy_s"])
        self.last_overflow = int(overflow_dev) if overflow_dev is not None else 0
        if self.last_overflow:
            print(f"warning: axis {axis_name}: up to {self.last_overflow} NMS centers "
                  f"per slice exceeded max_centers={self.max_centers} and were dropped "
                  "(instances merged into nearest neighbors) — rerun with a larger "
                  "max_centers", file=sys.stderr)

        with timer.stage("backward_matching"):
            for index, flat_seg in backward_matching(rle_stack, matchers, n_slices):
                update_trackers(flat_seg, index, trackers)
        with timer.stage("finish_tracking"):
            finish_tracking(trackers)
        for tracker in trackers:
            filters.remove_small_objects(tracker, min_size=self.min_size)
            filters.remove_pancakes(tracker, min_span=self.min_extent)
        stack = None
        if self.save_panoptic:
            stack = np.zeros(volume.shape, dtype=np.int32)
            with timer.stage("fill_volume"):
                fill_panoptic_volume(stack, trackers)
        self.last_timing = timer.report()
        return stack, trackers

    def infer_orthoplane(self, volume: np.ndarray, timer: Optional[StageTimer] = None,
                         checkpoint_dir=None, resume: bool = False) -> dict:
        """The xy, xz and yz sweeps of ``volume``, in that order ->
        ``{axis: trackers}`` for ``api.tracker_consensus``.  ``timer``, if
        given, accumulates the stages of all three; ``last_overflow`` is the
        largest over the axes, and ``last_axis_stats[axis]`` holds each
        sweep's seconds, batch size, dropped centers and stage report."""
        if checkpoint_dir is not None or resume:
            raise NotImplementedError(
                "checkpoint_dir / resume: checkpointing the sweeps is ROADMAP item A6d")
        trackers, stats = {}, {}
        for axis_name in self.axes:
            t0 = time.perf_counter()
            _, trackers[axis_name] = self.infer_on_axis(volume, axis_name, timer=timer)
            stats[axis_name] = {"seconds": time.perf_counter() - t0,
                                "batch": self.last_batch_size,
                                "dropped_centers": self.last_overflow,
                                "timing": self.last_timing}
        self.last_overflow = max(s["dropped_centers"] for s in stats.values())
        self.last_axis_stats = stats
        return trackers
