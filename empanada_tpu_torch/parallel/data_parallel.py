"""Batched 3D inference on one card or over a world of cards (counterpart
of ``empanada_tpu/parallel/data_parallel.py``).

Each sweep (``infer_on_axis`` along xy, xz or yz; ``infer_orthoplane`` runs
the three) takes the volume's slices along one axis and puts them through
the model ``b`` at a time: forward (integer slices normalised on the card),
median over z, batched postprocess and run-length packing
(``ops.postprocess.encode_runs_packed``); only the packed int16 rows cross
to the host, through asynchronous copies into pinned memory read after a
CUDA event.  The host builds each slice's instances, matches them forwards
and backwards across slices, tracks, filters and optionally fills the
panoptic volume.

Three paths give identical results:

- **resident volume** (``volume_resident``): an integer volume of up to
  ``RESIDENT_MAX_BYTES`` is copied to the card once (cached on the
  engine); each sweep moves its axis to the front, pads it and slices its
  batches there, so no slice is copied on the host (the yz planes are
  strided);
- **streamed** (``sweep_fused=False``, a checkpointed sweep, or a volume
  that is not resident): a rolling median context of sem batches lives on
  the card; a drainer thread waits on each batch's copy and feeds the
  slices to the forward matcher (``stitch.patterns.MatcherWorker``) while
  the card computes the next batch;
- **fused** (``sweep_fused``, resident volume, outputs within
  ``SWEEP_FUSED_MAX_BYTES``): the forward of every batch
  of the axis, then the postprocess of every batch with median windows by
  absolute slice index, into one packed buffer fetched by one copy; the
  host then builds and matches the whole axis in one native ``match_sweep``
  call per class.  ``infer_orthoplane`` pipelines the three axes: the host
  half of axis i runs on a worker thread while the main thread dispatches
  axis i + 1.  Unlike the JAX package's fused path (its fault C1), classes
  outside ``thing_list`` are built without matching, as the streamed path
  builds them.

Boundary semantics match the median queue: slices closer than
``mid = (ks - 1) // 2`` to either end of the stack pass through unmedianed.
Checkpoint/resume (``checkpoint_dir``) follows ``stitch/checkpoint.py``.

At ``inference_scale`` s > 1 each slice is downsampled on the host
(``data.volume.resize_by_factor``, cv2's bilinear, for every dtype cv2
resizes) and the
model renders ``2 + log2(s)`` PointRend steps back to full resolution; such
a sweep streams from the host, as the JAX engine's does.  The input may be a
numpy volume or a ``core.chunked.ChunkedArray`` (streamed, slice by slice);
with ``store_url`` the panoptic stack (``save_panoptic``) is written into a
chunked store ``<store_url>/panoptic_<axis>`` instead of a numpy array.

**Data-parallel** (``mesh`` a world of n > 1 ranks, ``parallel.mesh``; by
default the world of ``parallel.multihost``): each batch of ``b`` slices
(a multiple of n) is split into n runs of ``b / n`` slices, rank r
forwarding and postprocessing the r-th.  A median window that crosses a
rank's run reads its neighbours' edge slices: after each forward, every
rank's first and last ``min(mid, b / n)`` sem slices are all-gathered.
The packed rows of a batch (equal shapes: the run capacity is fixed) are
all-gathered, so every rank matches, tracks and returns the whole axis,
the same instances a world of one gives.  As the JAX engine does across
processes, such a world takes the streamed path (no fused sweeps, no
pipelined ortho); a resident volume is held by every rank.  Rank 0 writes
the checkpoints and stores; the other ranks wait, then read the stores.
"""

from __future__ import annotations

import math
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.chunked import create_chunked, open_chunked
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.data.volume import VolumeDataset, factor_pad_numpy
from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.parallel.mesh import all_gather, all_reduce, barrier, create_mesh
from empanada_tpu_torch.stitch import checkpoint as ckpt
from empanada_tpu_torch.stitch import filters
from empanada_tpu_torch.stitch.patterns import (
    MatcherWorker,
    apply_matchers_flat,
    backward_matching,
    build_flat_seg,
    create_matchers,
    fill_panoptic_volume,
    finish_tracking,
    update_trackers,
)
from empanada_tpu_torch.stitch.tracker import InstanceTracker
from empanada_tpu_torch.utils import Progress, StageTimer, resolve_device, to_host_async

__all__ = ["MultiChipEngine3d"]

# the auto batch carries about this many padded model-input pixels, up to
# this many slices (the JAX engine's defaults)
AUTO_BATCH_TARGET_PX = 8 << 20
AUTO_BATCH_MAX = 256
# the JAX engine's default budgets: the largest integer volume kept on the
# card, and the largest sem + pan output of one fused sweep
RESIDENT_MAX_BYTES = 256 << 20
SWEEP_FUSED_MAX_BYTES = 1 << 30


class MultiChipEngine3d:
    """Batched 3D inference engine (the JAX package's class of this name):
    ``infer_on_axis(volume, "xy")`` -> ``(stack, trackers)``.

    ``model`` is a port model (``empanada_tpu_torch.models``; None loads
    the config's bundle in ``compute_dtype``, as JAX's engine does); it is moved
    to ``device`` (default "cuda", this rank's card in a world; raises
    without a GPU unless ``device="cpu"``) and computes in its own
    parameter dtype.  ``mesh``: the world the batches are split over
    (module docstring; default ``parallel.mesh.create_mesh()``);
    ``batch_size`` must divide over it.

    ``inference_scale``: a power of 2 (module docstring).  ``store_url``:
    with ``save_panoptic``, the stack goes into the chunked store
    ``<store_url>/panoptic_<axis>`` (chunks of ``chunk_size``).
    ``sweep_fused``: "auto" fuses every resident sweep with packed rows
    whose outputs fit ``SWEEP_FUSED_MAX_BYTES``, False none.
    ``volume_resident``: "auto" keeps an integer volume of up to
    ``RESIDENT_MAX_BYTES`` on the card, False none.  After a sweep,
    ``last_batch_size``, ``last_overflow`` (NMS centres dropped on the
    worst slice), ``last_fused`` and ``last_timing`` describe it;
    ``fallbacks`` counts the fused sweeps whose packed rows overflowed and
    took the per-slice path.  ``transfer_compaction=False`` sends dense
    maps instead of packed runs, ``max_runs_per_row`` caps the runs a row
    (a row with more takes the per-slice path).  Other keywords (the JAX
    engine's tuning knobs, ``shape_buckets``) are accepted and unused, as
    the JAX engine leaves them.
    """

    def __init__(
        self,
        model_config: dict,
        model=None,
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
        chunk_size=(256, 256, 256),
        sweep_fused="auto",
        volume_resident="auto",
        mesh=None,
        device=None,
        transfer_compaction: bool = True,
        max_runs_per_row: Optional[int] = None,
        compute_dtype=torch.float32,
        **kwargs,
    ):
        if median_kernel_size % 2 != 1:
            raise ValueError("median_kernel_size must be an odd integer")
        if inference_scale < 1 or not math.log2(inference_scale).is_integer():
            raise ValueError(f"inference_scale {inference_scale} must be a power of 2")
        for name, value in (("sweep_fused", sweep_fused), ("volume_resident", volume_resident)):
            if not (value == "auto" or value is False):
                raise ValueError(f"{name}={value!r}: expected 'auto' or False")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else create_mesh(device=self.device)
        if batch_size is not None and batch_size % self.mesh.size:
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"{self.mesh.size} ranks of the mesh")
        if model is None:
            # imported here: api imports parallel (the spatial engine)
            from empanada_tpu_torch.api.utils import load_model_from_config
            model = load_model_from_config(model_config, device=self.device, dtype=compute_dtype)
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.transfer_compaction = bool(transfer_compaction)
        self.max_runs_per_row = max_runs_per_row
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
        self.inference_scale = int(inference_scale)
        self.save_panoptic = save_panoptic
        self.store_url = store_url
        self.chunk_size = tuple(chunk_size)
        self.sweep_fused = sweep_fused
        self.volume_resident = volume_resident
        self.mean = float(model_config["norms"]["mean"])
        self.std = float(model_config["norms"]["std"])
        self.last_overflow = 0
        self.fallbacks = 0
        self.axes = {"xy": 0, "xz": 1, "yz": 2}
        # the resident volume: (id, shape, dtype) key, the ndarray itself
        # (which keeps the id valid) and its copy on the device
        self._resident = None

    # ------------------------------------------------------------------
    def _max_runs(self, width: int) -> int:
        """Per-row run capacity of the packed transfer; 0 sends dense maps.

        int16 packing needs pan ids < 65536 and column indices < 32768."""
        if not self.transfer_compaction:
            return 0
        if self.num_classes * self.label_divisor > 65535 or width > 32767:
            return 0
        if self.max_runs_per_row is not None:
            return min(int(self.max_runs_per_row), int(width))
        return min(max(32, width // 8), int(width))

    def _resolve_batch(self, volume_shape, axis: int) -> int:
        """Per-axis batch size: explicit if given, else scaled so one batch
        carries ~AUTO_BATCH_TARGET_PX padded model-input pixels (after the
        ``inference_scale`` downsample), capped by the axis length and
        AUTO_BATCH_MAX, then snapped down to the smallest batch with the
        same number of batches; each step keeps a multiple of the world's
        size n, as the JAX engine keeps one of its mesh's."""
        if self.batch_size is not None:
            return self.batch_size
        n = self.mesh.size
        dims = [-(-s // self.inference_scale) for i, s in enumerate(volume_shape) if i != axis]
        area = max(1, math.prod(d + (-d) % self.padding_factor for d in dims))
        n_slices = volume_shape[axis]
        b = max(n, round(AUTO_BATCH_TARGET_PX / area) // n * n)
        b = min(b, max(n, -(-n_slices // n) * n), max(n, AUTO_BATCH_MAX // n * n))
        per = -(-n_slices // -(-n_slices // b))
        return max(n, -(-per // n) * n)

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
    def _forward_device(self, x: torch.Tensor, max_value: float):
        """Raw slices (B, H, W) on the device -> (sem in median space, ctr,
        off) on the device; ``2 + log2(inference_scale)`` refine steps."""
        out = self.model(self.normalize(x, max_value),
                         render_steps=2 + int(math.log2(self.inference_scale)),
                         interpolate_ins=not self.coarse_boundaries)
        return pp.to_median_space(out["sem_logits"]), out["ctr_hmp"], out["offsets"]

    def _forward(self, images: np.ndarray, max_value: float):
        """``_forward_device`` of raw slices on the host; uint8 crosses to
        the card as it is, other integers as float32."""
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            x = x.pin_memory()
        return self._forward_device(x.to(self.device, non_blocking=True), max_value)

    @torch.no_grad()
    def _post_windows(self, windows, use_median, ctr, off, crop, max_runs):
        """Median of each slice's window (B, ks, H, W, C) where
        ``use_median`` (B,) holds and its raw middle slice elsewhere, then
        the batched panoptic merge, the crop and (with ``max_runs > 0``)
        the run-length packing.  Returns (pans, packed or None, worst
        centre overflow of the batch), all on the device."""
        # an odd-window median is a selection: exact in float32 and equal
        # to the JAX engine's median in its compute dtype
        med = windows.float().median(dim=1).values.to(windows.dtype)
        sem = torch.where(use_median[:, None, None, None], med, windows[:, self.mid])
        scale = self.inference_scale
        cells, n_over = pp.get_instance_cells(
            ctr, off, self.coarse_boundaries, scale, self.nms_threshold, self.nms_kernel,
            self.max_centers, return_overflow=True, keep_coarse=True)
        step = scale * (4 if self.coarse_boundaries else 1)
        sem_h = pp.harden_median_space(sem, self.confidence_thr)
        pans = pp.merge_semantic_and_instance_coarse(
            sem_h, cells, self.label_divisor, self.thing_list, self.stuff_area,
            self.void_label, self.num_classes, self.max_centers, step=step)
        h, w = crop
        pans = pans[:, :h, :w]
        packed = pp.encode_runs_packed(pans, max_runs) if max_runs > 0 else None
        return pans, packed, n_over.max()

    def _post_batch(self, sem_ctx, ctr, off, win_idx, use_median, crop, max_runs):
        """Streamed postprocess of one batch: its median windows gathered
        by ``win_idx`` (host, (B, ks)) from the rolling context of sem
        batches, then ``_post_windows``."""
        stack = torch.cat(sem_ctx, dim=0)                    # ((2K+1)B, H, W, C)
        windows = stack[torch.as_tensor(win_idx, device=stack.device)]
        use = torch.as_tensor(use_median, device=stack.device)
        return self._post_windows(windows, use, ctr, off, crop, max_runs)

    # ------------------------------------------------------------------
    def _resident_ok(self, volume) -> bool:
        """Whether ``volume`` lives on the card for its sweeps (never at an
        ``inference_scale`` above 1, whose slices are downsampled on the
        host)."""
        if self.volume_resident is False or self.inference_scale != 1:
            return False
        if not isinstance(volume, np.ndarray) or not np.issubdtype(volume.dtype, np.integer):
            return False
        return volume.nbytes <= RESIDENT_MAX_BYTES

    def _resident_volume(self, volume) -> Optional[torch.Tensor]:
        """The volume on the card (uint8 as it is, other integers as
        float32, as the streamed path sends them), or None to stream from
        the host.  Copied once and cached, so the three ortho sweeps and
        repeated calls on the same array pay one upload."""
        if not self._resident_ok(volume):
            return None
        key = (id(volume), volume.shape, str(volume.dtype))
        if self._resident is None or self._resident[0] != key:
            self._resident = None  # free the previous volume first
            host = volume if volume.dtype == np.uint8 else volume.astype(np.float32)
            dev = torch.from_numpy(np.ascontiguousarray(host)).to(self.device)
            self._resident = (key, volume, dev)
        return self._resident[2]

    def _axis_volume(self, vol: torch.Tensor, axis: int, n_padded: int) -> torch.Tensor:
        """The resident volume with ``axis`` moved to the front, padded to
        ``n_padded`` slices with copies of the last one (the streamed tail
        batch's rule) and zero-padded in H and W to the padding factor;
        contiguous, made once per sweep."""
        v = vol.movedim(axis, 0)
        n, h, w = v.shape
        out = v.new_zeros((n_padded, h + (-h) % self.padding_factor,
                           w + (-w) % self.padding_factor))
        out[:n, :h, :w] = v
        out[n:, :h, :w] = v[-1]
        return out

    def _sweep_eligible(self, volume, axis: int) -> bool:
        """Whether a sweep along ``axis`` takes the fused path: the JAX
        engine's rule on one device in ``infer_orthoplane``'s pipelined
        mode.  Unlike JAX's standalone rule, a sweep of fewer than 3
        batches is fused too: on the H100 the fused xy sweep of two batches
        was no slower than the streamed one (PERF.md)."""
        if self.sweep_fused is False or self.mesh.distributed or not self._resident_ok(volume):
            return False
        dims = [s for i, s in enumerate(volume.shape) if i != axis]
        if self._max_runs(dims[1]) <= 0:
            return False  # the bulk fetch is of packed rows
        b = self._resolve_batch(volume.shape, axis)
        n = -(-volume.shape[axis] // b) * b
        pad = lambda d: d + (-d) % self.padding_factor  # noqa: E731
        sem_bytes = n * pad(dims[0]) * pad(dims[1]) * (self.num_classes - 1) * 2
        pan_bytes = n * dims[0] * dims[1] * 4
        return sem_bytes + pan_bytes <= SWEEP_FUSED_MAX_BYTES

    @torch.no_grad()
    def _sweep_device(self, volume, axis_name: str, timer) -> dict:
        """The device half of a fused sweep: the forward of every batch of
        the resident axis (sem, ctr and off stay on the card), then the
        postprocess of every batch with median windows by absolute slice
        index (clipped; edge slices raw), packed into one (n_batches, b, h,
        2R+1) int16 buffer whose copy into pinned memory starts at once.
        Returns the handles ``_sweep_host`` takes."""
        axis = self.axes[axis_name]
        n_slices = volume.shape[axis]
        b = self._resolve_batch(volume.shape, axis)
        n_batches = -(-n_slices // b)
        h, w = (s for i, s in enumerate(volume.shape) if i != axis)
        max_runs = self._max_runs(w)
        max_value = float(np.iinfo(volume.dtype).max)
        with timer.stage("upload"):
            vol = self._axis_volume(self._resident_volume(volume), axis, n_batches * b)
        with timer.stage("forward_dispatch"):
            outs = [self._forward_device(vol[j * b:(j + 1) * b], max_value)
                    for j in range(n_batches)]
        del vol
        with timer.stage("post_dispatch"):
            sems = torch.cat([sem for sem, _, _ in outs])    # (n_batches * b, H, W, C)
            dev = sems.device
            taps = torch.arange(-self.mid, self.mid + 1, device=dev)
            pans, packed, n_over = [], [], []
            for j, (_, ctr, off) in enumerate(outs):
                idxs = j * b + torch.arange(b, device=dev)
                win = (idxs[:, None] + taps[None, :]).clamp(0, n_slices - 1)
                use = (idxs >= self.mid) & (idxs < n_slices - self.mid)
                p, pk, no = self._post_windows(sems[win], use, ctr, off, (h, w), max_runs)
                pans.append(p)
                packed.append(pk)
                n_over.append(no)
            del outs, sems
            packed = torch.stack(packed)
            over_host, _ = to_host_async(torch.stack(n_over).max().reshape(1))
            packed_host, event = to_host_async(packed)
        return {"axis_name": axis_name, "b": b, "n_slices": n_slices, "w": w,
                "packed": packed_host, "n_over": over_host, "event": event, "pans": pans}

    def _sweep_host(self, volume, handles: dict, timer, progress: bool = False):
        """The host half of a fused sweep: wait for the packed rows, then
        per class one native ``match_sweep`` call over the whole axis
        (thing classes built, matched forwards and backwards; the others
        only built, as the streamed path does), the tracker updates in the
        backward pass's order, the finish, filters and fill.  A slice whose
        rows overflowed their run capacity, or a class whose ids overflowed
        their window, sends the sweep down the per-slice path over the same
        rows (the dense maps only for overflowing slices), which raises the
        proper error where there is one.  Returns (stack, trackers, info)."""
        axis_name, n_slices, b, w = (handles[k] for k in ("axis_name", "n_slices", "b", "w"))
        trackers = [InstanceTracker(label, self.label_divisor, volume.shape, axis_name)
                    for label in self.labels]
        bar = Progress(total=n_slices, desc=f"axis {axis_name}", enabled=progress)
        with timer.stage("fetch"):
            if handles["event"] is not None:
                handles["event"].synchronize()
            packed = handles["packed"].numpy()
            n_over = int(handles["n_over"].reshape(-1)[0])
        rows = packed.reshape(-1, *packed.shape[2:])[:n_slices]
        over = rows[..., -1].max(axis=-1) > (rows.shape[-1] - 1) // 2

        per_class = None
        if native.available() and not over.any():
            per_class = {}
            with timer.stage("host_decode+enqueue"):
                for label in self.labels:
                    thing = label in self.thing_list
                    min_id = label * self.label_divisor
                    res = native.match_sweep(
                        rows, w, min_id, min_id + self.label_divisor,
                        self.force_connected and thing, self.merge_iou_thr,
                        self.merge_ioa_thr, min_id + 1, match=thing)
                    if isinstance(res, str):
                        per_class = None
                        break
                    per_class[label] = res
        if per_class is not None:
            with timer.stage("backward_matching"):
                for idx in range(n_slices - 1, -1, -1):
                    for tracker in trackers:
                        tracker.update(FlatInstances(*per_class[tracker.class_id][idx]), idx)
            bar.update(n_slices)
            stack = self._finalize_trackers(trackers, volume, axis_name, timer)
        else:
            matchers = create_matchers(self.thing_list, self.label_divisor,
                                       self.merge_iou_thr, self.merge_ioa_thr)
            rle_stack = []
            with timer.stage("host_decode+enqueue"):
                for s in range(n_slices):
                    item = (handles["pans"][s // b][s % b].cpu().numpy().astype(np.int64)
                            if over[s] else ("packed", rows[s], w))
                    flat_seg = build_flat_seg(item, self.labels, self.label_divisor,
                                              self.thing_list, self.force_connected)
                    rle_stack.append(apply_matchers_flat(flat_seg, matchers))
                    bar.update()
            stack = self._finish_axis(rle_stack, matchers, trackers, volume, axis_name, timer)
        bar.close()
        # the per-slice path taken for what the data did, not for a switch
        fallback = per_class is None and native.available()
        return stack, trackers, {"dropped_centers": n_over, "fallback": fallback}

    # ------------------------------------------------------------------
    def _checkpoint_meta(self, volume, axis_name: str) -> dict:
        """The run's configuration as the JAX engine records it (the
        world's size, the resolved batch): a resume under another one
        raises."""
        return {
            "axis_name": axis_name,
            "volume_shape": list(volume.shape),
            "volume_fingerprint": ckpt.volume_fingerprint(volume),
            "label_divisor": self.label_divisor,
            "labels": [int(c) for c in self.labels],
            "thing_list": [int(c) for c in self.thing_list],
            "inference_scale": self.inference_scale,
            "median_kernel_size": self.ks,
            "force_connected": self.force_connected,
            "merge_iou_thr": self.merge_iou_thr,
            "merge_ioa_thr": self.merge_ioa_thr,
            "batch_size": self.batch_size,
            "resolved_batch": self._resolve_batch(volume.shape, self.axes[axis_name]),
            "n_dev": self.mesh.size,
            "auto_batch_target_px": AUTO_BATCH_TARGET_PX,
            "auto_batch_max": AUTO_BATCH_MAX,
            "model_name": self.model_config.get("model_name", ""),
        }

    def _warn_overflow(self, axis_name: str, n_over: int):
        if n_over:
            print(f"warning: axis {axis_name}: up to {n_over} NMS centers per slice "
                  f"exceeded max_centers={self.max_centers} and were dropped (instances "
                  "merged into nearest neighbors) — rerun with a larger max_centers",
                  file=sys.stderr)

    def infer_on_axis(self, volume: np.ndarray, axis_name: str,
                      timer: Optional[StageTimer] = None, checkpoint_dir=None,
                      checkpoint_every: int = 64, resume: bool = False,
                      progress: bool = False):
        """(Z, H, W) integer volume (numpy or ``ChunkedArray``), swept along
        ``axis_name`` ("xy", "xz" or "yz") -> ``(stack, trackers)``: the
        filled panoptic volume (int32, a ``ChunkedArray`` with
        ``store_url``, or None unless ``save_panoptic``) and one finished
        ``InstanceTracker`` per label.  ``timer`` collects host stages;
        ``last_timing`` holds its report afterwards.

        ``checkpoint_dir`` saves the forward-matched slices every
        ``checkpoint_every`` slices (streamed path); with ``resume`` a
        sweep continues from them, bit-identical to an uninterrupted one.
        ``progress`` prints a counter on stderr."""
        if axis_name not in self.axes:
            raise ValueError(f"axis {axis_name!r}: expected one of {list(self.axes)}")
        if not np.issubdtype(np.dtype(volume.dtype), np.integer):
            raise TypeError("input volume cannot be float type")
        timer = timer or StageTimer()
        axis = self.axes[axis_name]
        fc, loaded = None, []
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            fc = ckpt.ForwardCheckpoint(checkpoint_dir, axis_name,
                                        self._checkpoint_meta(volume, axis_name))
            if resume and fc.exists():
                loaded = fc.load()
        self.last_fused = fc is None and self._sweep_eligible(volume, axis)
        if self.last_fused:
            handles = self._sweep_device(volume, axis_name, timer)
            stack, trackers, info = self._sweep_host(volume, handles, timer, progress)
            self.fallbacks += info["fallback"]
        else:
            streamed = self._infer_sharded if self.mesh.distributed else self._infer_streamed
            stack, trackers, info = streamed(volume, axis_name, timer, fc, loaded,
                                             checkpoint_every, progress)
        self.last_batch_size = self._resolve_batch(volume.shape, axis)
        self.last_overflow = info["dropped_centers"]
        self._warn_overflow(axis_name, self.last_overflow)
        self.last_timing = timer.report()
        return stack, trackers

    def _stream_setup(self, volume, axis_name, timer, fc, loaded_stack, checkpoint_every,
                      progress) -> SimpleNamespace:
        """What the streamed sweeps start from: the batch ``b``, the ``K``
        context batches each side that cover every window [i - mid, i +
        mid], ``n_batches``, the batch ``j0`` a resumed sweep restarts at
        (its last whole batch boundary; it feeds from ``feed_batch``, K
        batches earlier, and drops the slices it has), the slice source
        (``vol_axis`` of the resident volume, or ``batch_gen`` from the
        host, and ``size`` when known), the trackers, matchers, matcher
        worker and progress counter, and ``put``: feed the matcher,
        skipping the slices a resumed sweep has, and (rank 0) save the
        forward state every ``checkpoint_every`` slices."""
        axis = self.axes[axis_name]
        n_slices = volume.shape[axis]
        b = self._resolve_batch(volume.shape, axis)
        K = -(-self.mid // b)
        n_batches = -(-n_slices // b)
        z_done = len(loaded_stack)
        j0 = z_done // b
        feed_batch = max(0, j0 - K)
        drop = z_done - j0 * b
        st = SimpleNamespace(n_slices=n_slices, b=b, K=K, n_batches=n_batches, j0=j0,
                             feed_batch=feed_batch,
                             max_value=float(np.iinfo(volume.dtype).max),
                             vol_axis=None, batch_gen=None, size=None)
        vol_dev = self._resident_volume(volume)
        if vol_dev is not None:
            with timer.stage("upload"):
                st.vol_axis = self._axis_volume(vol_dev, axis, n_batches * b)
            st.size = tuple(s for i, s in enumerate(volume.shape) if i != axis)
        else:
            st.batch_gen = self._batches(VolumeDataset(volume, axis, None,
                                                       scale=self.inference_scale,
                                                       start=feed_batch * b), b)
        st.trackers = [InstanceTracker(label, self.label_divisor, volume.shape, axis_name)
                       for label in self.labels]
        st.matchers = create_matchers(self.thing_list, self.label_divisor,
                                      self.merge_iou_thr, self.merge_ioa_thr)
        ckpt.prime_matchers(st.matchers, loaded_stack)
        worker = st.worker = MatcherWorker(st.matchers, self.labels, self.label_divisor,
                                           self.thing_list, force_connected=self.force_connected)
        bar = st.bar = Progress(total=n_slices, desc=f"axis {axis_name}", enabled=progress)
        bar.n = z_done
        emitted = last_saved = 0

        def put(item):
            nonlocal emitted, last_saved
            emitted += 1
            if emitted <= drop:
                return
            worker.put(item)
            bar.update()
            if fc is not None and self.mesh.rank == 0:
                done = len(worker.rle_stack)  # append-only: its prefix is final
                if done - last_saved >= checkpoint_every:
                    fc.append(worker.rle_stack[last_saved:done])
                    last_saved = done

        st.put = put
        return st

    def _infer_streamed(self, volume, axis_name, timer, fc, loaded_stack,
                        checkpoint_every, progress):
        """The streamed sweep (module docstring) in a world of one;
        ``loaded_stack`` holds the slices a resumed sweep already has.
        Returns (stack, trackers, info)."""
        st = self._stream_setup(volume, axis_name, timer, fc, loaded_stack, checkpoint_every,
                                progress)
        n_slices, b, K, n_batches, j0 = st.n_slices, st.b, st.K, st.n_batches, st.j0
        mid, max_value, vol_axis, batch_gen, size = (self.mid, st.max_value, st.vol_axis,
                                                     st.batch_gen, st.size)
        trackers, matchers, worker, bar, put = (st.trackers, st.matchers, st.worker, st.bar,
                                                st.put)

        # only a median-kernel-deep rolling window of sem batches (plus the
        # current batch's ctr/off) lives on the device
        sem_buf: dict = {}   # batch index -> sem (B, H, W, C)
        io_buf: dict = {}    # batch index -> (ctr, off)
        fwd_done = st.feed_batch - 1

        def ensure_forwarded(upto: int):
            nonlocal fwd_done, size
            while fwd_done < min(upto, n_batches - 1):
                if batch_gen is None:
                    with timer.stage("forward_dispatch"):
                        start = (fwd_done + 1) * b
                        sem, ctr, off = self._forward_device(vol_axis[start:start + b],
                                                             max_value)
                else:
                    with timer.stage("host_prep"):
                        images, size = next(batch_gen)
                    with timer.stage("forward_dispatch"):
                        sem, ctr, off = self._forward(images, max_value)
                fwd_done += 1
                sem_buf[fwd_done] = sem
                if fwd_done >= j0:
                    # a resumed sweep's context batches only feed windows
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
                        put(pan.astype(np.int64))
                    return
                rcap = (host_np.shape[-1] - 1) // 2
                over = host_np[..., -1].max(axis=-1) > rcap
                w = pans_dev.shape[-1]
                for bi, row_buf in enumerate(host_np):
                    if over[bi]:
                        put(pans_dev[bi].cpu().numpy().astype(np.int64))
                    else:
                        put(("packed", row_buf, w))

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
                for j in range(j0, n_batches):
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
                            ctx, ctr, off, win_local, use_median, (h, w), max_runs)
                        overflow_dev = (n_over if overflow_dev is None
                                        else torch.maximum(overflow_dev, n_over))
                        # start the copy now, so it overlaps the next batch
                        host, event = to_host_async(packed if packed is not None else pans)
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
            matched = worker.finish()
        if drain_err:
            raise drain_err[0]
        rle_stack = loaded_stack + matched
        timer.add("matcher_busy", worker.stats["busy_s"])
        bar.close()
        n_over = int(overflow_dev) if overflow_dev is not None else 0
        stack = self._finish_axis(rle_stack, matchers, trackers, volume, axis_name, timer)
        if fc is not None:
            fc.remove()  # the axis is complete; its partial state is stale
        return stack, trackers, {"dropped_centers": n_over, "fallback": False}

    def _infer_sharded(self, volume, axis_name, timer, fc, loaded_stack,
                       checkpoint_every, progress):
        """The streamed sweep in a world of n > 1 ranks (module docstring),
        with ``_infer_streamed``'s arguments and result.  The collectives
        (the edge slices after each forward, the packed rows and, for a
        slice whose rows overflowed, the dense maps) are issued from this
        thread in the same order on every rank; each batch's rows are read
        on the host one batch late, while the next batch computes."""
        mesh = self.mesh
        st = self._stream_setup(volume, axis_name, timer, fc, loaded_stack, checkpoint_every,
                                progress)
        n_slices, b, K, n_batches, j0 = st.n_slices, st.b, st.K, st.n_batches, st.j0
        max_value, vol_axis, batch_gen, size = st.max_value, st.vol_axis, st.batch_gen, st.size
        trackers, matchers, worker, bar, put = (st.trackers, st.matchers, st.worker, st.bar,
                                                st.put)
        c, mid = b // mesh.size, self.mid
        lo = mesh.rank * c                  # this rank's rows of every batch
        edge = min(mid, c)                  # edge slices each rank shares

        local: dict = {}   # batch -> (sem, ctr, off) of this rank's rows
        edges: dict = {}   # global slice -> sem slice of another rank's rows
        fwd_done = st.feed_batch - 1

        def ensure_forwarded(upto: int):
            nonlocal fwd_done, size
            while fwd_done < min(upto, n_batches - 1):
                j = fwd_done + 1
                if batch_gen is None:
                    with timer.stage("forward_dispatch"):
                        sem, ctr, off = self._forward_device(
                            vol_axis[j * b + lo:j * b + lo + c], max_value)
                else:
                    with timer.stage("host_prep"):
                        images, size = next(batch_gen)
                    with timer.stage("forward_dispatch"):
                        sem, ctr, off = self._forward(images[lo:lo + c], max_value)
                if edge:
                    with timer.stage("collectives"):
                        shared = all_gather(torch.cat([sem[:edge], sem[c - edge:]]), mesh)
                    for q, t in enumerate(shared):
                        if q != mesh.rank:
                            for i in range(edge):
                                edges[j * b + q * c + i] = t[i]
                                edges[j * b + q * c + c - edge + i] = t[edge + i]
                # a resumed sweep's context batches only feed windows
                local[j] = (sem, ctr, off) if j >= j0 else (sem, None, None)
                fwd_done = j

        def sem_slice(g: int):
            j, pos = divmod(g, b)
            if pos // c == mesh.rank:
                return local[j][0][pos % c]
            return edges[g]

        def drain(pending):
            """Feed one batch's slices to the matcher; a slice whose rows
            overflowed their run capacity sends its dense map, gathered
            (every rank sees the same rows, so all of them gather)."""
            handle, pans, n_keep = pending
            with timer.stage("fetch"):
                rows = _fetch_host(handle)[:n_keep]
            if pans is None:                  # the gathered dense maps
                for pan in rows:
                    put(pan.astype(np.int64))
                return
            over = rows[..., -1].max(axis=-1) > (rows.shape[-1] - 1) // 2
            dense = None
            if over.any():
                with timer.stage("collectives"):
                    dense = torch.cat(all_gather(pans, mesh)).cpu().numpy()
            for i, row_buf in enumerate(rows):
                put(dense[i].astype(np.int64) if over[i] else ("packed", row_buf, pans.shape[-1]))

        overflow_dev = None
        max_runs = None
        taps = np.arange(-mid, mid + 1)
        pending = None
        try:
            with timer.stage("device_stream+forward_matching"):
                for j in range(j0, n_batches):
                    ensure_forwarded(j + K)
                    start, stop = j * b, min((j + 1) * b, n_slices)
                    # the batch's windows (padded positions read the last
                    # slice, unmedianed), this rank's rows of them
                    idxs = np.arange(start, start + b)[lo:lo + c]
                    win = np.clip(idxs[:, None] + taps[None, :], 0, n_slices - 1)
                    use = (idxs >= mid) & (idxs < n_slices - mid)
                    sem, ctr, off = local[j]
                    h, w = size
                    if max_runs is None:
                        max_runs = self._max_runs(w)
                    with timer.stage("post_dispatch"):
                        windows = torch.stack([sem_slice(int(g)) for g in win.reshape(-1)])
                        windows = windows.reshape(c, self.ks, *sem.shape[1:])
                        pans, packed, n_over = self._post_windows(
                            windows, torch.as_tensor(use, device=sem.device), ctr, off,
                            (h, w), max_runs)
                        overflow_dev = (n_over if overflow_dev is None
                                        else torch.maximum(overflow_dev, n_over))
                    with timer.stage("collectives"):
                        gathered = torch.cat(all_gather(
                            packed if packed is not None else pans.contiguous(), mesh))
                    item = (to_host_async(gathered), pans if packed is not None else None,
                            stop - start)
                    if pending is not None:
                        drain(pending)
                    pending = item
                    for k in [k for k in local if k < j + 1 - K]:
                        del local[k]
                    for g in [g for g in edges if g < (j + 1 - K) * b]:
                        del edges[g]
                if pending is not None:
                    drain(pending)
        finally:
            matched = worker.finish()
        rle_stack = loaded_stack + matched
        timer.add("matcher_busy", worker.stats["busy_s"])
        bar.close()
        n_over = 0
        if overflow_dev is not None:
            with timer.stage("collectives"):
                n_over = int(all_reduce(overflow_dev, mesh, "max"))
        stack = self._finish_axis(rle_stack, matchers, trackers, volume, axis_name, timer)
        if fc is not None and mesh.rank == 0:
            fc.remove()  # the axis is complete; its partial state is stale
        barrier(mesh)
        return stack, trackers, {"dropped_centers": n_over, "fallback": False}

    def _finish_axis(self, rle_stack, matchers, trackers, volume, axis_name, timer):
        """Backward matching with the tracker updates, then
        ``_finalize_trackers``."""
        with timer.stage("backward_matching"):
            for index, flat_seg in backward_matching(rle_stack, matchers, len(rle_stack)):
                update_trackers(flat_seg, index, trackers)
        return self._finalize_trackers(trackers, volume, axis_name, timer)

    def _finalize_trackers(self, trackers, volume, axis_name, timer):
        """Finish and filter the trackers; the filled volume (a numpy array,
        a chunked store with ``store_url``, or None)."""
        with timer.stage("finish_tracking"):
            finish_tracking(trackers)
        for tracker in trackers:
            filters.remove_small_objects(tracker, min_size=self.min_size)
            filters.remove_pancakes(tracker, min_span=self.min_extent)
        if not self.save_panoptic:
            return None
        if self.store_url is None:
            stack = np.zeros(volume.shape, dtype=np.int32)
            with timer.stage("fill_volume"):
                fill_panoptic_volume(stack, trackers)
            return stack
        # every rank holds the same trackers: rank 0 fills the store, the
        # others open it once it is written
        path = f"{self.store_url.rstrip('/')}/panoptic_{axis_name}"
        if self.mesh.rank == 0:
            stack = create_chunked(path, volume.shape, self.chunk_size, np.int32)
            with timer.stage("fill_volume"):
                fill_panoptic_volume(stack, trackers)
        barrier(self.mesh)
        return stack if self.mesh.rank == 0 else open_chunked(path)

    # ------------------------------------------------------------------
    def infer_orthoplane(self, volume: np.ndarray, timer: Optional[StageTimer] = None,
                         checkpoint_dir=None, checkpoint_every: int = 64,
                         resume: bool = False, progress: bool = False) -> dict:
        """The xy, xz and yz sweeps of ``volume`` -> ``{axis: trackers}`` for
        ``api.tracker_consensus``.

        Without ``checkpoint_dir``, and when every axis may take the fused
        path, the axes are pipelined: the host half of axis i runs on a
        worker thread while this thread dispatches axis i + 1 (trackers as
        the serial order gives them).  Otherwise the axes run one after the
        other; with ``checkpoint_dir`` each finished axis's trackers are
        saved, and a ``resume`` skips those axes and continues a partial
        one from its forward checkpoint.

        Each axis times its stages on its own ``StageTimer``; ``timer``,
        if given, receives the sum of the three.  ``last_overflow`` is the
        largest over the axes, and ``last_axis_stats[axis]`` holds each
        sweep's batch,
        dropped centres, path, stage report and its seconds: ``seconds`` of
        a serial sweep, or ``dispatch_s`` and ``host_s`` apart when the
        axes overlap."""
        if checkpoint_dir is None and all(self._sweep_eligible(volume, axis)
                                          for axis in self.axes.values()):
            return self._orthoplane_pipelined(volume, timer, progress)
        trackers, stats = {}, {}
        for axis_name, axis in self.axes.items():
            meta = loaded = None
            if checkpoint_dir is not None:
                meta = self._checkpoint_meta(volume, axis_name)
                if resume:
                    loaded = ckpt.load_axis_trackers(
                        checkpoint_dir, axis_name, meta,
                        lambda: [InstanceTracker(label, self.label_divisor, volume.shape,
                                                 axis_name) for label in self.labels])
            if loaded is not None:
                trackers[axis_name] = loaded
                stats[axis_name] = {"seconds": 0.0, "batch": self._resolve_batch(
                    volume.shape, axis), "dropped_centers": 0, "path": "checkpoint",
                    "timing": {}}
                continue
            t0 = time.perf_counter()
            _, trackers[axis_name] = self.infer_on_axis(
                volume, axis_name, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume, progress=progress)
            _merge_timing(timer, self.last_timing)
            stats[axis_name] = {"seconds": time.perf_counter() - t0,
                                "batch": self.last_batch_size,
                                "dropped_centers": self.last_overflow,
                                "path": "fused" if self.last_fused else "streamed",
                                "timing": self.last_timing}
            if checkpoint_dir is not None and self.mesh.rank == 0:
                ckpt.save_axis_trackers(checkpoint_dir, axis_name, trackers[axis_name], meta)
        self.last_overflow = max(s["dropped_centers"] for s in stats.values())
        self.last_axis_stats = stats
        return trackers

    def _orthoplane_pipelined(self, volume, timer, progress) -> dict:
        """infer_orthoplane's pipelined mode (its docstring)."""
        def host_half(handles, axis_timer):
            t0 = time.perf_counter()
            out = self._sweep_host(volume, handles, axis_timer, progress)
            return out, time.perf_counter() - t0

        pending = []
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="sweep-host") as pool:
            for axis_name in self.axes:
                axis_timer = StageTimer()
                t0 = time.perf_counter()
                handles = self._sweep_device(volume, axis_name, axis_timer)
                dispatch_s = time.perf_counter() - t0
                pending.append((axis_name, axis_timer, dispatch_s,
                                pool.submit(host_half, handles, axis_timer)))
                del handles
            results = [(name, t, d, fut.result()) for name, t, d, fut in pending]
        trackers, stats = {}, {}
        for axis_name, axis_timer, dispatch_s, ((_, axis_trackers, info), host_s) in results:
            _merge_timing(timer, axis_timer.report())
            trackers[axis_name] = axis_trackers
            self.fallbacks += info["fallback"]
            self._warn_overflow(axis_name, info["dropped_centers"])
            stats[axis_name] = {"dispatch_s": dispatch_s, "host_s": host_s,
                                "batch": self._resolve_batch(volume.shape,
                                                             self.axes[axis_name]),
                                "dropped_centers": info["dropped_centers"],
                                "fallback": info["fallback"], "path": "pipelined",
                                "timing": axis_timer.report()}
        self.last_batch_size = stats["yz"]["batch"]
        self.last_overflow = max(s["dropped_centers"] for s in stats.values())
        self.last_fused = True
        self.last_timing = stats["yz"]["timing"]
        self.last_axis_stats = stats
        return trackers


def _fetch_host(handle) -> np.ndarray:
    """The host array of a ``to_host_async`` handle, once its copy is done."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


def _merge_timing(timer: Optional[StageTimer], report: dict):
    """Add one axis's stage report into the caller's timer, if any."""
    if timer is not None:
        for name, v in report.items():
            timer.add(name, v["total_s"], v["count"])
