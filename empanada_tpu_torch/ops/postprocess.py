"""Panoptic post-processing (counterpart of
``empanada_tpu/ops/postprocess.py``).

Same contracts and the same ids: a fixed-size center list in scanline
order with an overflow count, first-index argmin grouping, majority-class
merging with per-class renumbering in ascending instance order.  The GPU
forms replace the JAX package's TPU ones: a cumulative-count compaction
instead of a top-k over indices, and ``scatter_add_`` histograms with
integer id tables instead of bf16 one-hot matmuls.  Nothing here reads a
device value back to the host.

Image tensors are NHWC; semantic and instance maps are (N, H, W).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from empanada_tpu_torch.ops.interpolate import nearest_resize

__all__ = [
    "factor_pad",
    "bucket_dim",
    "logits_to_prob",
    "harden_seg",
    "harden_logits",
    "to_median_space",
    "harden_median_space",
    "find_instance_center",
    "group_pixels",
    "get_instance_cells",
    "merge_semantic_and_instance",
    "merge_semantic_and_instance_coarse",
    "get_panoptic_segmentation",
    "find_instance_centers",
    "encode_runs_packed",
]

# ~25%-growth bucket ladder (in units of padding_factor)
_BUCKET_MULTIPLES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                     40, 48, 56, 64, 80, 96, 112, 128)


def bucket_dim(n: int, factor: int) -> int:
    """Smallest bucket size >= n: ``factor`` times a ladder multiple."""
    m = -(-int(n) // factor)
    for b in _BUCKET_MULTIPLES:
        if b >= m:
            return b * factor
    return (-(-m // 16) * 16) * factor


def factor_pad(x: torch.Tensor, factor: int = 16, buckets: bool = False) -> torch.Tensor:
    """Zero-pad H and W (axes 1, 2 of NHWC) up to multiples of ``factor``
    (or, with ``buckets``, up to the next ladder size)."""
    h, w = x.shape[1], x.shape[2]
    if buckets:
        pad_b, pad_r = bucket_dim(h, factor) - h, bucket_dim(w, factor) - w
    else:
        pad_b, pad_r = (-h) % factor, (-w) % factor
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_r, 0, pad_b))


def logits_to_prob(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over channels if multiclass, else the sigmoid."""
    if logits.shape[-1] > 1:
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)


def harden_seg(sem_prob: torch.Tensor, confidence_thr: float = 0.5) -> torch.Tensor:
    """(N, H, W, C) probabilities -> (N, H, W) int32 labels."""
    if sem_prob.shape[-1] > 1:
        return sem_prob.argmax(dim=-1).to(torch.int32)
    return (sem_prob[..., 0] >= confidence_thr).to(torch.int32)


def harden_logits(sem_logits: torch.Tensor, confidence_thr: float = 0.5) -> torch.Tensor:
    """Exact logit-space form of hardening the sigmoid/softmax
    probabilities: argmax if multiclass, else ``x >= log(t / (1 - t))``
    compared in float32."""
    if sem_logits.shape[-1] > 1:
        return sem_logits.argmax(dim=-1).to(torch.int32)
    t = float(confidence_thr)
    if not 0.0 < t < 1.0:
        raise ValueError(f"confidence_thr {t} outside (0, 1)")
    thr = torch.tensor(math.log(t / (1.0 - t)), dtype=torch.float32)
    return (sem_logits[..., 0].float() >= thr.to(sem_logits.device)).to(torch.int32)


def to_median_space(sem_logits: torch.Tensor) -> torch.Tensor:
    """Binary: raw logits (an odd-window median commutes with the sigmoid);
    multiclass: softmax probabilities."""
    if sem_logits.shape[-1] > 1:
        return torch.softmax(sem_logits, dim=-1)
    return sem_logits


def harden_median_space(sem: torch.Tensor, confidence_thr: float = 0.5) -> torch.Tensor:
    """Harden a medianed ``to_median_space`` tensor."""
    if sem.shape[-1] > 1:
        return harden_seg(sem, confidence_thr)
    return harden_logits(sem, confidence_thr)


def find_instance_centers(ctr_hmp: torch.Tensor, threshold: float = 0.1,
                          nms_kernel: int = 7, max_centers: int = 256):
    """Center NMS with a fixed-size output, per image of a batch.

    ``ctr_hmp``: (N, H, W, 1).  Returns ``centers`` (N, K, 2) float32
    (y, x), ``valid`` (N, K) bool — the first K surviving peaks of each
    image in scanline order — and the number of surviving peaks per image
    (N,) int32 (a device tensor), so a caller can tell when the cap dropped
    centers.
    """
    n, h, w = ctr_hmp.shape[0], ctr_hmp.shape[1], ctr_hmp.shape[2]
    t = torch.where(ctr_hmp > threshold, ctr_hmp, torch.full_like(ctr_hmp, -1.0))
    t = t[..., 0][:, None]  # (N, 1, H, W)
    pooled = F.max_pool2d(t, nms_kernel, 1, nms_kernel // 2)  # pads with -inf
    if nms_kernel % 2 == 0:
        # even kernels pool to (H+1, W+1); drop the last row and column
        pooled = pooled[:, :, :-1, :-1]
    keep = ((t == pooled) & (t > 0)).reshape(n, h * w)
    # compaction: the j-th kept pixel in scanline order goes to slot j;
    # pixels past the cap and unkept pixels go to a discarded slot K
    k = max_centers
    slot = torch.cumsum(keep.to(torch.int32), 1) - 1
    slot = torch.where(keep & (slot < k), slot, torch.full_like(slot, k))
    idx = torch.arange(h * w, device=ctr_hmp.device, dtype=torch.int64).expand(n, -1)
    flat = torch.full((n, k + 1), -1, dtype=torch.int64, device=ctr_hmp.device)
    flat = flat.scatter(1, slot.to(torch.int64), idx)[:, :k]
    valid = flat >= 0
    flat = flat.clamp(min=0)
    centers = torch.stack([flat // w, flat % w], dim=-1).to(torch.float32)
    return centers, valid, keep.sum(dim=1, dtype=torch.int32)


def find_instance_center(ctr_hmp: torch.Tensor, threshold: float = 0.1,
                         nms_kernel: int = 7, max_centers: int = 256,
                         return_count: bool = False):
    """``find_instance_centers`` of one image: ``ctr_hmp`` (1, H, W, 1) ->
    ``centers`` (K, 2), ``valid`` (K,) and, with ``return_count``, the
    number of surviving peaks (a device scalar)."""
    centers, valid, n_peaks = find_instance_centers(ctr_hmp, threshold, nms_kernel,
                                                    max_centers)
    if return_count:
        return centers[0], valid[0], n_peaks[0]
    return centers[0], valid[0]


def group_pixels(centers: torch.Tensor, valid: torch.Tensor, offsets: torch.Tensor,
                 step: int = 1, pixel_chunk: int = 16384) -> torch.Tensor:
    """Assign each pixel the id (1..K) of its nearest offset-shifted center
    of its own image (first index on ties); 0 everywhere in an image
    without a valid center.

    ``centers`` (N, K, 2) and ``valid`` (N, K), or (K, 2) and (K,) for one
    image; ``offsets``: (N, H, W, 2) (dy, dx) in full-resolution units;
    ``step`` is the grid step of the offsets' grid.  Returns (N, H, W)
    int32.
    """
    if centers.dim() == 2:
        centers, valid = centers[None], valid[None]
    n, h, w = offsets.shape[0], offsets.shape[1], offsets.shape[2]
    dev = offsets.device
    yy = (torch.arange(h, device=dev, dtype=torch.float32) * step)[:, None]
    xx = (torch.arange(w, device=dev, dtype=torch.float32) * step)[None, :]
    loc_y = (yy + offsets[..., 0].float()).reshape(n, -1)
    loc_x = (xx + offsets[..., 1].float()).reshape(n, -1)
    ctr_y = (centers[..., 0] * step)[:, None, :]  # (N, 1, K)
    ctr_x = (centers[..., 1] * step)[:, None, :]
    inf = torch.tensor(1e30, dtype=torch.float32, device=dev)
    ids = []
    for s in range(0, h * w, pixel_chunk):
        cy, cx = loc_y[:, s:s + pixel_chunk, None], loc_x[:, s:s + pixel_chunk, None]
        d2 = (cy - ctr_y) ** 2 + (cx - ctr_x) ** 2
        d2 = torch.where(valid[:, None, :], d2, inf)
        ids.append(torch.argmin(d2, dim=2))
    ids = torch.cat(ids, dim=1).to(torch.int32) + 1
    ids = torch.where(valid.any(dim=1, keepdim=True), ids, torch.zeros_like(ids))
    return ids.reshape(n, h, w)


def get_instance_cells(ctr_hmp, offsets, coarse_boundaries: bool = True,
                       upsampling: int = 1, threshold: float = 0.1,
                       nms_kernel: int = 7, max_centers: int = 256,
                       return_overflow: bool = False, keep_coarse: bool = False):
    """NMS + grouping (at 1/4 resolution when ``coarse_boundaries``) + a
    nearest upsample of the id map by ``upsampling * step``, unless
    ``keep_coarse``, for each image of (N, h, w, 1) ``ctr_hmp`` and
    (N, h, w, 2) ``offsets``.  With ``return_overflow``, also the number of
    centers the ``max_centers`` cap dropped per image ((N,) device
    tensor)."""
    step = 4 if coarse_boundaries else 1
    centers, valid, n_peaks = find_instance_centers(
        ctr_hmp, threshold, nms_kernel, max_centers)
    cells = group_pixels(centers, valid, offsets, step=step)
    scale = int(upsampling * step)
    if scale > 1 and not keep_coarse:
        cells = nearest_resize(cells[..., None],
                               (cells.shape[1] * scale, cells.shape[2] * scale))[..., 0]
    if return_overflow:
        return cells, (n_peaks - valid.sum(dim=1, dtype=torch.int32)).clamp(min=0)
    return cells


def _thing_mask(sem: torch.Tensor, thing_list: Sequence[int]) -> torch.Tensor:
    m = torch.zeros_like(sem, dtype=torch.bool)
    for t in thing_list:
        m = m | (sem == t)
    return m


def merge_semantic_and_instance(sem, ins, label_divisor: int, thing_list,
                                stuff_area: int, void_label: int, num_classes: int,
                                max_centers: int = 256) -> torch.Tensor:
    """Merge hardened semantics (N, H, W) with the class-agnostic instance
    maps (N, H, W), already restricted to thing pixels, image by image.

    Each instance takes the majority class of its thing pixels (first class
    on ties); instances are renumbered 1, 2, ... within each class in
    ascending instance-id order; thing pixels get class * divisor + id.
    Stuff classes paint class * divisor where their area outside things
    reaches ``stuff_area`` in that image.
    """
    sem = sem.to(torch.int64)
    ins = ins.to(torch.int64)
    n = sem.shape[0]
    k, c = max_centers, num_classes
    dev = sem.device
    thing_seg = ins > 0
    thing_px = thing_seg & _thing_mask(sem, thing_list)
    counted = thing_px & (ins <= k) & (sem >= 0) & (sem < c)
    # one histogram over all images: image b's (instance, class) cells
    # start at b * (K + 1) * C
    base = torch.arange(n, device=dev, dtype=torch.int64)[:, None, None] * ((k + 1) * c)
    key = torch.where(counted, base + ins * c + sem, torch.zeros_like(sem)).reshape(-1)
    counts = torch.zeros(n * (k + 1) * c, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, key, counted.reshape(-1).to(torch.int32))
    counts = counts.reshape(n, k + 1, c)[:, 1:]               # (N, K, C)
    inst_valid = counts.sum(dim=2) > 0
    inst_class = counts.argmax(dim=2)                         # majority class
    onehot = F.one_hot(inst_class, c) * inst_valid[..., None].to(torch.int64)
    prior = torch.cumsum(onehot, dim=1) - onehot
    new_ids = (prior * onehot).sum(dim=2) + 1
    table = torch.cat([torch.zeros(n, 1, dtype=torch.int64, device=dev),
                       inst_class * label_divisor + new_ids], dim=1)  # (N, K + 1)
    pan_thing = torch.gather(table, 1, ins.clamp(0, k).reshape(n, -1)).reshape(ins.shape)
    pan = torch.where(thing_px, pan_thing, torch.full_like(sem, void_label))
    for class_id in range(num_classes):
        if class_id in thing_list:
            continue
        stuff = (sem == class_id) & ~thing_seg
        paint = stuff & (stuff.sum(dim=(1, 2), keepdim=True) >= stuff_area)
        pan = torch.where(paint, torch.full_like(pan, class_id * label_divisor), pan)
    return pan.to(torch.int32)


def merge_semantic_and_instance_coarse(sem, cells_coarse, label_divisor: int,
                                       thing_list, stuff_area: int, void_label: int,
                                       num_classes: int, max_centers: int = 256,
                                       step: int = 4) -> torch.Tensor:
    """Merge with grouping id maps (N, hc, wc) at 1/``step`` resolution: the ids are
    block-replicated to ``sem``'s grid and restricted to thing pixels, then
    merged as ``merge_semantic_and_instance`` does (exactly its result)."""
    n, big_h, big_w = sem.shape
    hc, wc = cells_coarse.shape[1], cells_coarse.shape[2]
    if big_h != hc * step or big_w != wc * step:
        raise ValueError(f"sem {tuple(sem.shape)} is not cells "
                         f"{tuple(cells_coarse.shape)} x step {step}")
    cells = cells_coarse[:, :, None, :, None].expand(n, hc, step, wc, step)
    cells = cells.reshape(n, big_h, big_w)
    ins = torch.where(_thing_mask(sem, thing_list), cells, torch.zeros_like(cells))
    return merge_semantic_and_instance(sem, ins, label_divisor, thing_list, stuff_area,
                                       void_label, num_classes, max_centers)


def get_panoptic_segmentation(sem, ctr_hmp, offsets, thing_list, label_divisor: int,
                              stuff_area: int, void_label: int, threshold: float = 0.1,
                              nms_kernel: int = 7, num_classes: int = 2,
                              max_centers: int = 256) -> torch.Tensor:
    """Hardened semantics (N, H, W), ``ctr_hmp`` (N, H, W, 1) and
    ``offsets`` (N, H, W, 2), all at one resolution -> (N, H, W) int32
    panoptic maps: center NMS, grouping at step 1, the dense merge."""
    centers, valid, _ = find_instance_centers(ctr_hmp, threshold, nms_kernel, max_centers)
    cells = group_pixels(centers, valid, offsets, step=1)
    ins = torch.where(_thing_mask(sem, thing_list), cells, torch.zeros_like(cells))
    return merge_semantic_and_instance(sem, ins, label_divisor, thing_list, stuff_area,
                                       void_label, num_classes, max_centers)


def encode_runs_packed(pan: torch.Tensor, max_runs: int) -> torch.Tensor:
    """Per-row run-length compaction of a batch of panoptic maps, byte for
    byte the JAX package's ``encode_runs_packed`` (decoded on the host by
    ``core.labeling.decode_runs_packed`` or ``native.packed_build_flat``).

    The TPU version finds the first R run starts of a row with a ``top_k``
    over scores; here they come from a direct form: the boundary mask, its
    running count along the row (a run's rank), and a scatter of each
    start into slot ``rank`` (ranks >= R go to a discarded slot).

    Args:
        pan: (B, H, W) integer panoptic maps; values must fit unsigned
             16 bits (the caller checks): they are stored as the int16 bit
             pattern, and the decoder reads them back with ``& 0xFFFF``.
        max_runs: per-row run capacity R (<= W).  A row with more runs
             signals overflow through its count; the caller falls back to
             the dense map.

    Returns:
        (B, H, 2R + 1) int16: ``[starts(R) | values(R) | count(1)]`` per
        row.  Unused slots hold start = W (sentinel) and value 0; count is
        the true number of runs in the row (it may exceed R).
    """
    b, h, w = pan.shape
    r = int(max_runs)
    pan = pan.to(torch.int32)
    boundary = torch.ones((b, h, w), dtype=torch.bool, device=pan.device)
    boundary[..., 1:] = pan[..., 1:] != pan[..., :-1]
    rank = torch.cumsum(boundary.to(torch.int32), dim=-1) - 1
    slot = torch.where(boundary & (rank < r), rank, torch.full_like(rank, r)).to(torch.int64)
    col = torch.arange(w, dtype=torch.int32, device=pan.device).expand(b, h, w)
    starts = torch.full((b, h, r + 1), w, dtype=torch.int32, device=pan.device)
    starts = starts.scatter(-1, slot, col)[..., :r]
    vals = torch.zeros((b, h, r + 1), dtype=torch.int32, device=pan.device)
    vals = vals.scatter(-1, slot, pan)[..., :r]
    counts = boundary.sum(dim=-1, dtype=torch.int32)
    # the int16 bit pattern of ids up to 65535 (what an int32 -> int16
    # astype gives in the JAX package), spelled out rather than left to
    # the cast's wrap-around
    vals = torch.where(vals >= 32768, vals - 65536, vals)
    return torch.cat([starts, vals, counts[..., None]], dim=-1).to(torch.int16)
