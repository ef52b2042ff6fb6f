"""Inference engines (counterpart of ``empanada_tpu/engine/engines.py``).

The render engines serve every panoptic model: ``engine(image, size,
upsampling)`` returns a dense panoptic map (numpy), or ``None`` while the
3D median queue fills; ``dispatch`` returns the unfetched device tensor.
The model forward and the postprocess (harden, center NMS, grouping,
coarse merge) are queued on the device without a host round trip;
``dropped_centers()`` reads the cap's worst-case overflow with one fetch.
``PanopticDeepLabEngine{,3d}`` are the plain engines (``engine(image)``,
probabilities medianed, the dense merge at input resolution), and
``BCEngine{,3d}`` return the sigmoid semantic and boundary maps that
``stitch.watershed.bc_watershed`` segments.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.ops.interpolate import bilinear_resize
from empanada_tpu_torch.utils import resolve_device

__all__ = [
    "MedianQueue",
    "PanopticDeepLabEngine",
    "PanopticDeepLabEngine3d",
    "PanopticDeepLabRenderEngine",
    "PanopticDeepLabRenderEngine3d",
    "BCEngine",
    "BCEngine3d",
]


class MedianQueue:
    """Rolling window over consecutive z-slice outputs returning the middle
    item with the per-pixel median of the window.

    Passes the newest item through while the queue holds <= mid items,
    returns None while it fills beyond that, the median once full;
    ``end()`` drains the items past the middle.  Every window medians RAW
    slice outputs (non-recursive, PARITY.md "Known divergences" 5).
    """

    def __init__(self, median_kernel_size: int):
        if median_kernel_size % 2 != 1:
            raise ValueError("median_kernel_size must be an odd integer")
        self.ks = median_kernel_size
        self.mid_idx = (median_kernel_size - 1) // 2
        self.queue = deque(maxlen=median_kernel_size)

    def reset(self):
        self.queue.clear()

    def enqueue(self, item: dict):
        self.queue.append(item)

    def get_next(self, keys: Sequence[str]) -> Optional[dict]:
        nq = len(self.queue)
        if nq <= self.mid_idx:
            return self.queue[-1]
        if nq < self.ks:
            return None
        out = dict(self.queue[self.mid_idx])
        for key in keys:
            stack = torch.stack([item[key] for item in self.queue], dim=0)
            out[key] = stack.median(dim=0).values
        return out

    def end(self):
        """Drain the tail and clear the queue, so a reused engine starts
        from passthrough/fill semantics."""
        tail = list(self.queue)[self.mid_idx + 1:]
        self.queue.clear()
        return tail


class _EngineBase:
    """Holds the model on ``device`` (default "cuda", which raises without a
    GPU unless ``device="cpu"``); the model computes in its own parameter
    dtype.  ``model`` is a port model (``empanada_tpu_torch.models``);
    images are zero-padded to multiples of ``padding_factor`` or, with
    ``shape_buckets``, to the next size of ``pp.bucket_dim``'s ladder (the
    padding changes the result: the ASPP pooling is a global mean)."""

    def __init__(self, model, device=None, padding_factor: int = 1,
                 shape_buckets: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.padding_factor = int(padding_factor)
        self.shape_buckets = bool(shape_buckets)

    def _prepare(self, image) -> torch.Tensor:
        """(H, W) or (1, H, W) array -> padded (1, H', W', 1) device tensor."""
        image = np.asarray(image)
        if image.ndim == 2:
            image = image[None]
        if image.ndim != 3 or image.shape[0] != 1:
            raise ValueError(f"expected an (H, W) or (1, H, W) image, got {image.shape}")
        x = torch.from_numpy(np.ascontiguousarray(image[..., None], dtype=np.float32))
        x = x.to(self.device, non_blocking=True).to(self.dtype)
        return pp.factor_pad(x, self.padding_factor, buckets=self.shape_buckets)


class PanopticDeepLabEngine(_EngineBase):
    """Single-slice engine over a plain (non-render) model at input
    resolution: ``engine(image)`` -> (H, W) int32 panoptic map.  The
    semantic probabilities are hardened by ``confidence_thr`` (argmax when
    multiclass) and merged densely with the grouped instances."""

    def __init__(self, model, thing_list: Sequence[int], label_divisor: int = 1000,
                 stuff_area: int = 64, void_label: int = 0,
                 nms_threshold: float = 0.1, nms_kernel: int = 7,
                 confidence_thr: float = 0.5, max_centers: int = 256, device=None):
        super().__init__(model, device)
        self.thing_list = tuple(int(t) for t in thing_list)
        self.label_divisor = int(label_divisor)
        self.stuff_area = int(stuff_area)
        self.void_label = int(void_label)
        self.nms_threshold = float(nms_threshold)
        self.nms_kernel = int(nms_kernel)
        self.confidence_thr = float(confidence_thr)
        self.max_centers = int(max_centers)
        self.num_classes = int(model.num_classes) + 1  # class ids are 1-based

    @torch.no_grad()
    def infer(self, image) -> dict:
        out = self.model(self._prepare(image))
        out["sem"] = pp.logits_to_prob(out["sem_logits"])
        return out

    @torch.no_grad()
    def postprocess(self, out: dict) -> torch.Tensor:
        """(1, H, W) int32 panoptic map of one ``infer`` output."""
        sem = pp.harden_seg(out["sem"], self.confidence_thr)
        return pp.get_panoptic_segmentation(
            sem, out["ctr_hmp"], out["offsets"], self.thing_list, self.label_divisor,
            self.stuff_area, self.void_label, self.nms_threshold, self.nms_kernel,
            self.num_classes, self.max_centers)

    def __call__(self, image) -> np.ndarray:
        return self.postprocess(self.infer(image))[0].cpu().numpy()


class PanopticDeepLabEngine3d(PanopticDeepLabEngine):
    """The plain engine with the median queue over z on the probabilities:
    ``engine(image)`` returns the middle slice's map, or None while the
    queue fills; ``end()`` drains the rest."""

    def __init__(self, *args, median_kernel_size: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.median = MedianQueue(median_kernel_size)

    def __call__(self, image) -> Optional[np.ndarray]:
        self.median.enqueue(self.infer(image))
        median_out = self.median.get_next(keys=["sem"])
        if median_out is None:
            return None
        return self.postprocess(median_out)[0].cpu().numpy()

    def end(self):
        return [self.postprocess(o)[0].cpu().numpy() for o in self.median.end()]


class PanopticDeepLabRenderEngine(_EngineBase):
    """PointRend-aware 2D engine: ``__call__(image, size, upsampling)``.
    Plain models are served too: their logits are interpolated to the
    target resolution."""

    def __init__(self, model, thing_list: Sequence[int], label_divisor: int = 1000,
                 stuff_area: int = 64, void_label: int = 0,
                 nms_threshold: float = 0.1, nms_kernel: int = 7,
                 confidence_thr: float = 0.5, padding_factor: int = 16,
                 coarse_boundaries: bool = True, max_centers: int = 256,
                 shape_buckets: bool = False, device=None):
        super().__init__(model, device, padding_factor, shape_buckets)
        self.thing_list = tuple(int(t) for t in thing_list)
        self.label_divisor = int(label_divisor)
        self.stuff_area = int(stuff_area)
        self.void_label = int(void_label)
        self.nms_threshold = float(nms_threshold)
        self.nms_kernel = int(nms_kernel)
        self.confidence_thr = float(confidence_thr)
        self.coarse_boundaries = bool(coarse_boundaries)
        self.max_centers = int(max_centers)
        self.num_classes = int(model.num_classes) + 1  # class ids are 1-based
        self._overflow = None

    def update_params(self, **params):
        """Update thresholds without rebuilding the model; resets the
        center-overflow record, as the JAX engine's rebuild does."""
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, type(getattr(self, k))(v))
        self._overflow = None

    @torch.no_grad()
    def infer(self, image: torch.Tensor, render_steps: int = 2, out_hw=None) -> dict:
        out = self.model(image, render_steps=render_steps,
                         interpolate_ins=not self.coarse_boundaries)
        # plain (non-PointRend) models emit sem at input resolution; at
        # upsampling > 1 interpolate the logits to the target (align corners)
        if out_hw is not None and tuple(out["sem_logits"].shape[1:3]) != tuple(out_hw):
            out["sem_logits"] = bilinear_resize(out["sem_logits"], out_hw,
                                                align_corners=True)
        out["sem"] = pp.to_median_space(out["sem_logits"])
        return out

    def _track_overflow(self, n_over):
        # device-side max: no fetch on the dispatch path
        self._overflow = (n_over if self._overflow is None
                          else torch.maximum(self._overflow, n_over))

    def dropped_centers(self) -> int:
        """Worst-case number of NMS centers dropped by the ``max_centers``
        cap in any slice since the last reset (one device fetch)."""
        return 0 if self._overflow is None else int(self._overflow)

    def reset_overflow(self):
        self._overflow = None

    @torch.no_grad()
    def _post_fused(self, out: dict, upsampling: int):
        """Cells on the coarse grid + harden + coarse merge, then track the
        center overflow.  Returns (1, H, W) int32."""
        cells, n_over = pp.get_instance_cells(
            out["ctr_hmp"], out["offsets"], self.coarse_boundaries, upsampling,
            self.nms_threshold, self.nms_kernel, self.max_centers,
            return_overflow=True, keep_coarse=True)
        step = int(upsampling) * (4 if self.coarse_boundaries else 1)
        sem = pp.harden_median_space(out["sem"], self.confidence_thr)
        pan = pp.merge_semantic_and_instance_coarse(
            sem, cells, self.label_divisor, self.thing_list, self.stuff_area,
            self.void_label, self.num_classes, self.max_centers, step=step)
        self._track_overflow(n_over)
        return pan

    def _forward_out(self, image, size, upsampling: int):
        """Pad + forward with render_steps = 2 + log2(upsampling); records
        the crop size."""
        if upsampling < 1 or not math.log2(upsampling).is_integer():
            raise ValueError(f"upsampling {upsampling} must be a power of 2")
        x = self._prepare(image)
        u = int(upsampling)
        out = self.infer(x, render_steps=int(2 + math.log2(u)),
                         out_hw=(x.shape[1] * u, x.shape[2] * u))
        out["size"] = tuple(size)
        return out

    def dispatch(self, image, size, upsampling: int = 1) -> torch.Tensor:
        """Queue the device chain; returns the unfetched (H, W) int32 map."""
        out = self._forward_out(image, size, upsampling)
        h, w = out["size"]
        return self._post_fused(out, upsampling)[0, :h, :w]

    def __call__(self, image, size, upsampling: int = 1) -> np.ndarray:
        return self.dispatch(image, size, upsampling).cpu().numpy()


class PanopticDeepLabRenderEngine3d(PanopticDeepLabRenderEngine):
    """Render engine + median queue over z."""

    def __init__(self, *args, median_kernel_size: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.median = MedianQueue(median_kernel_size)

    def dispatch(self, image, size, upsampling: int = 1):
        """Unfetched device map of the middle slice, or None while the
        median queue fills."""
        self.median.enqueue(self._forward_out(image, size, upsampling))
        median_out = self.median.get_next(keys=["sem"])
        if median_out is None:
            return None
        # crop with the middle slice's recorded size
        h, w = median_out["size"]
        return self._post_fused(median_out, upsampling)[0, :h, :w]

    def __call__(self, image, size, upsampling: int = 1) -> Optional[np.ndarray]:
        pan = self.dispatch(image, size, upsampling)
        return None if pan is None else pan.cpu().numpy()

    def end(self, upsampling: int = 1):
        final = []
        for out in self.median.end():
            h, w = out["size"]
            final.append(self._post_fused(out, upsampling)[0, :h, :w].cpu().numpy())
        return final


class BCEngine(_EngineBase):
    """Boundary-contour engine: ``engine(image)`` -> (H, W, 2) float32 maps,
    the sigmoid of the semantic and of the boundary logits (a
    ``PanopticDeepLabBC`` model), for ``stitch.watershed.bc_watershed``."""

    def __init__(self, model, padding_factor: int = 16, shape_buckets: bool = False,
                 device=None):
        super().__init__(model, device, padding_factor, shape_buckets)

    @torch.no_grad()
    def infer(self, x: torch.Tensor, render_steps: int = 2) -> dict:
        out = self.model(x, render_steps=render_steps)
        sem = torch.sigmoid(out["sem_logits"])
        cnt = torch.sigmoid(out["cnt_logits"])
        return {"bc": torch.cat([sem, cnt], dim=-1)}  # (1, H, W, 2)

    def __call__(self, image) -> np.ndarray:
        h, w = np.shape(image)[-2:]
        return self.infer(self._prepare(image))["bc"][0, :h, :w].float().cpu().numpy()


class BCEngine3d(BCEngine):
    """BC engine + median queue over z on the (sem, cnt) maps:
    ``engine(image, size, upsampling)`` returns the middle slice's maps
    cropped to its recorded size, or None while the queue fills."""

    def __init__(self, *args, median_kernel_size: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.median = MedianQueue(median_kernel_size)

    def __call__(self, image, size, upsampling: int = 1) -> Optional[np.ndarray]:
        if upsampling < 1 or not math.log2(upsampling).is_integer():
            raise ValueError(f"upsampling {upsampling} must be a power of 2")
        out = self.infer(self._prepare(image), render_steps=int(2 + math.log2(upsampling)))
        out["size"] = tuple(size)
        self.median.enqueue(out)
        median_out = self.median.get_next(keys=["bc"])
        if median_out is None:
            return None
        h, w = median_out["size"]  # the middle slice's size
        return median_out["bc"][0, :h, :w].float().cpu().numpy()

    def end(self, upsampling: int = 1):
        return [o["bc"][0, :o["size"][0], :o["size"][1]].float().cpu().numpy()
                for o in self.median.end()]
