"""One big 2D slice split row-wise over a world of cards, with halo rows
exchanged between neighbours (counterpart of
``empanada_tpu/parallel/spatial.py``).

Each rank runs the model on its block of rows plus ``halo`` rows received
from each neighbour (``exchange_halo_rows``), so every convolution near a
block border sees the real image instead of a tile's edge; global pooling
(the ASPP image pooling, ``spatial_global_mean``) crops the halo rows,
means locally and averages over the ranks.  The cropped outputs of all
ranks are gathered, and the panoptic postprocess runs once on the whole
slice, so instance ids are consistent across blocks with no merge.

As in the JAX package the result depends on the number of ranks, and a
world of n is held to JAX's ``spatial_sharded_forward`` on an n-device
mesh, not to the unsharded forward: receptive fields beyond the halo are
cut at block borders, the blocks at the ends of the world see ``halo``
zero rows where the unsharded model pads at every layer (a world of one
too), and the decoder's align-corners resizes map coordinates by the
(block + 2 halo) extent.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import numpy as np
import torch

from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.ops.interpolate import bilinear_resize
from empanada_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    create_mesh,
    data_sharding,
    exchange_neighbors,
)
from empanada_tpu_torch.utils import resolve_device

__all__ = [
    "spatial_pool_axis",
    "current_spatial_axis",
    "spatial_global_mean",
    "exchange_halo_rows",
    "spatial_sharded_forward",
    "SpatialEngine2d",
]

_AXIS = threading.local()


@contextlib.contextmanager
def spatial_pool_axis(mesh: Optional[Mesh], halo_fraction: float = 0.0):
    """Bind the world whose ranks hold the row blocks, for the global
    pooling layers (``spatial_global_mean``) of the forward run inside, in
    this thread.  ``halo_fraction`` is halo / (block + 2 halo): pooling
    crops that fraction of its input's rows at each edge."""
    prev = getattr(_AXIS, "bound", (None, 0.0))
    _AXIS.bound = (mesh, float(halo_fraction))
    try:
        yield
    finally:
        _AXIS.bound = prev


def current_spatial_axis() -> Optional[Mesh]:
    return getattr(_AXIS, "bound", (None, 0.0))[0]


def spatial_global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of NCHW ``x``, kept as (N, C, 1, 1).  Under
    ``spatial_pool_axis`` it is the mean over the whole slice: the halo
    rows cropped, the block's mean averaged over the ranks (equal blocks)."""
    mesh, halo_fraction = getattr(_AXIS, "bound", (None, 0.0))
    if mesh is None:
        return x.mean(dim=(2, 3), keepdim=True)
    h = x.shape[2]
    hh = int(round(h * halo_fraction))
    interior = x[:, :, hh:h - hh] if hh > 0 else x
    return all_reduce(interior.mean(dim=(2, 3), keepdim=True), mesh, "mean")


def exchange_halo_rows(block: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """(N, H_local, W, C) row block -> (N, H_local + 2 halo, W, C): the
    previous rank's last ``halo`` rows above it and the next rank's first
    below, zero rows at the ends of the world (both ends in a world of
    one)."""
    top, bottom = exchange_neighbors(block[:, :halo], block[:, -halo:], mesh)
    return torch.cat([top, block, bottom], dim=1)


@torch.no_grad()
def spatial_sharded_forward(model, image: torch.Tensor, mesh: Mesh, halo: int = 128,
                            render_steps: int = 2, interpolate_ins: bool = True,
                            data_mesh: Optional[Mesh] = None) -> dict:
    """The model over ``image`` (N, H, W, 1), the same on every rank, split
    into ``mesh.size`` row blocks: this rank's block with its halo rows
    goes through ``model`` (PointRend renders each block + halo on its
    own), each output is cropped by the halo at its own scale, and every
    rank gets the gathered outputs at the resolutions an unsharded call
    gives.  H must divide over the ranks, ``halo`` be a multiple of 4 (the
    coarsest output's step) and at most one block (one hop).

    ``data_mesh`` (a grid's other axis, ``parallel.mesh.create_mesh_grid``)
    splits the batch too: each of its ranks takes its images, rows shared
    along ``mesh`` (the halos and pooling stay within a row of the grid),
    and the outputs are gathered along both axes."""
    if data_mesh is not None:
        image = image[data_sharding(data_mesh, image.shape[0])]
    n = mesh.size
    h = image.shape[1]
    if h % n:
        raise ValueError(f"H={h} must divide over {n} ranks")
    if halo % 4:
        raise ValueError(f"halo {halo} must be a multiple of 4")
    if halo > h // n:
        raise ValueError(f"halo {halo} exceeds the {h // n}-row block; use fewer ranks, a "
                         "bigger slice or a smaller halo (halos of one hop)")
    rows = h // n
    block = image[:, mesh.rank * rows:(mesh.rank + 1) * rows]
    with_halo = exchange_halo_rows(block, halo, mesh)
    with spatial_pool_axis(mesh, halo / (rows + 2 * halo)):
        out = model(with_halo, render_steps=render_steps, interpolate_ins=interpolate_ins)
    gathered = {}
    for key, val in out.items():
        # the halo at the output's scale (which is above 1 for the rendered
        # logits at an upsampling render)
        hh = halo * val.shape[1] // with_halo.shape[1]
        cropped = val[:, hh:val.shape[1] - hh]
        gathered[key] = torch.cat(all_gather(cropped, mesh), dim=1)
        if data_mesh is not None:
            gathered[key] = torch.cat(all_gather(gathered[key], data_mesh), dim=0)
    return gathered


class SpatialEngine2d:
    """Seam-free engine for big slices: ``engine(image, upsampling)`` with
    a normalised (H, W) image -> (H * upsampling, W * upsampling) int32
    panoptic map, the same on every rank.  Rows are padded to a multiple
    of ``mesh.size * padding_factor`` and columns of ``padding_factor``;
    ``2 + log2(upsampling)`` render steps, and a plain model's logits
    resized to the target (align corners), as the render engines do.  The
    model runs on ``device`` (the entry-point rule) in its own dtype;
    ``mesh`` defaults to the world (``create_mesh``)."""

    def __init__(self, model, thing_list, mesh: Optional[Mesh] = None, halo: int = 128,
                 label_divisor: int = 1000, stuff_area: int = 64, void_label: int = 0,
                 nms_threshold: float = 0.1, nms_kernel: int = 7,
                 confidence_thr: float = 0.5, padding_factor: int = 128,
                 coarse_boundaries: bool = True, max_centers: int = 1024, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.mesh = mesh if mesh is not None else create_mesh(axis_name="spatial",
                                                              device=self.device)
        self.halo = int(halo)
        self.thing_list = tuple(int(t) for t in thing_list)
        self.label_divisor = int(label_divisor)
        self.stuff_area = int(stuff_area)
        self.void_label = int(void_label)
        self.nms_threshold = float(nms_threshold)
        self.nms_kernel = int(nms_kernel)
        self.confidence_thr = float(confidence_thr)
        self.padding_factor = int(padding_factor)
        self.coarse_boundaries = bool(coarse_boundaries)
        self.max_centers = int(max_centers)
        self.num_classes = int(model.num_classes) + 1

    def update_params(self, label_divisor=None, nms_threshold=None, nms_kernel=None,
                      confidence_thr=None, coarse_boundaries=None):
        """New thresholds for the next calls; the model stays."""
        for name, value, cast in (("label_divisor", label_divisor, int),
                                  ("nms_threshold", nms_threshold, float),
                                  ("nms_kernel", nms_kernel, int),
                                  ("confidence_thr", confidence_thr, float),
                                  ("coarse_boundaries", coarse_boundaries, bool)):
            if value is not None:
                setattr(self, name, cast(value))

    @torch.no_grad()
    def forward(self, image: np.ndarray, upsampling: int = 1) -> dict:
        """The gathered model outputs of the padded image (the sem logits
        at the target resolution)."""
        if upsampling < 1 or not math.log2(upsampling).is_integer():
            raise ValueError(f"upsampling {upsampling} must be a power of 2")
        h, w = image.shape
        pad_h = (-h) % (self.mesh.size * self.padding_factor)
        pad_w = (-w) % self.padding_factor
        x = np.pad(np.asarray(image, np.float32), ((0, pad_h), (0, pad_w)))
        x = torch.from_numpy(x)[None, ..., None].to(self.device, self.dtype)
        out = spatial_sharded_forward(self.model, x, self.mesh, self.halo,
                                      render_steps=int(2 + math.log2(upsampling)),
                                      interpolate_ins=not self.coarse_boundaries)
        want = (x.shape[1] * upsampling, x.shape[2] * upsampling)
        if tuple(out["sem_logits"].shape[1:3]) != want:
            out["sem_logits"] = bilinear_resize(out["sem_logits"], want, align_corners=True)
        return out

    def __call__(self, image: np.ndarray, upsampling: int = 1) -> np.ndarray:
        return self.postprocess(self.forward(image, upsampling), image.shape, upsampling)

    @torch.no_grad()
    def postprocess(self, out: dict, size, upsampling: int = 1) -> np.ndarray:
        """The panoptic map of ``forward``'s outputs, cropped to ``size``
        times ``upsampling``."""
        cells = pp.get_instance_cells(
            out["ctr_hmp"], out["offsets"], self.coarse_boundaries, upsampling,
            self.nms_threshold, self.nms_kernel, self.max_centers, keep_coarse=True)
        sem = pp.harden_logits(out["sem_logits"], self.confidence_thr)
        step = int(upsampling) * (4 if self.coarse_boundaries else 1)
        pan = pp.merge_semantic_and_instance_coarse(
            sem, cells, self.label_divisor, self.thing_list, self.stuff_area,
            self.void_label, self.num_classes, self.max_centers, step=step)
        h, w = size
        return pan[0, :h * upsampling, :w * upsampling].cpu().numpy()
