"""Panoptic-DeepLab model assemblies (counterpart of
``empanada_tpu/models/panoptic_deeplab.py``).

``forward`` takes an NHWC image batch (N, H, W, 1) and returns NHWC maps,
as the flax models do:
  - ``sem_logits``: (N, H, W, num_classes)
  - ``ctr_hmp``:    (N, H, W, 1) instance-center heatmap
  - ``offsets``:    (N, H, W, 2) (dy, dx) offsets to instance centers
Internally the network runs NCHW in ``channels_last`` memory, so the NHWC
views of its outputs are free.  With ``interpolate_ins`` False the center
and offset maps stay at 1/4 resolution (the coarse-boundaries contract);
the PR variant refines ``sem_logits`` with ``render_steps`` PointRend steps.
The BC variant returns ``sem_logits`` and ``cnt_logits`` (boundary
contours), both refined, and no center or offset maps.

``forward(x, train=True, generator=g)`` is the train mode (the JAX
package's ``apply(..., train=True)``): batch norm on batch statistics
(updating the running ones), ASPP dropout and PointRend's point sampling
drawn from the ``torch.Generator`` ``g``, every map at input resolution;
the PointRend variants add ``sem_points`` and ``point_coords`` (the BC
variant ``sem_points``/``sem_point_coords`` and ``cnt_points``/
``cnt_point_coords``).  ``point_coords`` (a tensor; for the BC variant a
dict with keys "sem" and "cnt") replaces the sampled points.  The mode is
the ``train`` argument, never ``nn.Module.training``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from empanada_tpu_torch.models.decoders import PanopticDeepLabDecoder
from empanada_tpu_torch.models.heads import PanopticDeepLabHead
from empanada_tpu_torch.models.point_rend import PointRendSemSegHead
from empanada_tpu_torch.models.regnet import RegNet, RegNetParams, regnet_configs
from empanada_tpu_torch.models.resnet import ResNet, resnet_configs
from empanada_tpu_torch.ops.interpolate import bilinear_resize_nchw

__all__ = ["PanopticDeepLab", "PanopticDeepLabPR", "PanopticDeepLabBC", "create_encoder"]


def create_encoder(name: str, output_stride: int = 32, int8_execution: bool = False):
    """(encoder, pyramid widths): a ResNet or RegNet by config name; the
    widths are those of the encoder's whole pyramid, stem first.
    ``int8_execution`` reaches a ResNet's blocks; a RegNet ignores it and
    runs in float, as in the JAX package."""
    if name in resnet_configs:
        enc = ResNet(output_stride=output_stride, int8_execution=int8_execution,
                     **resnet_configs[name])
        return enc, (64,) + enc.widths
    if name in regnet_configs:
        params = RegNetParams(**regnet_configs[name])
        enc = RegNet(params.widths, params.depths, params.groups, use_se=params.use_se,
                     output_stride=output_stride)
        return enc, (RegNetParams.w_stem,) + tuple(params.widths)
    raise ValueError(f"unknown encoder {name!r}; choices: "
                     f"{sorted(resnet_configs) + sorted(regnet_configs)}")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _up4(x: torch.Tensor) -> torch.Tensor:
    return bilinear_resize_nchw(x, (x.shape[2] * 4, x.shape[3] * 4), align_corners=True)


class PanopticDeepLab(nn.Module):
    instance_heads = True  # the center and offset heads

    def __init__(self, encoder: str = "resnet50", num_classes: int = 1,
                 stage4_stride: int = 16, decoder_channels: int = 256,
                 low_level_stages: Sequence[int] = (3, 2, 1),
                 low_level_channels_project: Sequence[int] = (128, 64, 32),
                 atrous_rates: Sequence[int] = (2, 4, 6),
                 aspp_channels: Optional[int] = None, aspp_dropout=0.1,
                 ins_decoder: bool = False, ins_ratio: float = 0.5,
                 int8_execution: bool = False):
        # aspp_dropout: one rate, or (semantic, instance) rates;
        # int8_execution: the encoder's wide 3 x 3 convolutions in int8
        super().__init__()
        self.num_classes = num_classes
        if isinstance(aspp_dropout, (tuple, list)):
            sem_p, ins_p = aspp_dropout
        else:
            sem_p = ins_p = aspp_dropout
        self.encoder, widths = create_encoder(encoder, stage4_stride, int8_execution)
        self.semantic_decoder = PanopticDeepLabDecoder(
            widths, decoder_channels, low_level_stages, low_level_channels_project,
            atrous_rates, aspp_channels, sem_p)
        self.instance_decoder = None
        if ins_decoder:
            self.instance_decoder = PanopticDeepLabDecoder(
                widths, decoder_channels, low_level_stages,
                [int(s * ins_ratio) for s in low_level_channels_project],
                atrous_rates, aspp_channels, ins_p)
        self.semantic_head = PanopticDeepLabHead(decoder_channels, num_classes)
        if self.instance_heads:
            self.ins_center = PanopticDeepLabHead(decoder_channels, 1)
            self.ins_xy = PanopticDeepLabHead(decoder_channels, 2)

    def _encode_decode(self, x, train: bool = False, generator=None):
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pyramid = self.encoder(x, train)
        semantic_x = self.semantic_decoder(pyramid, train, generator)
        instance_x = semantic_x
        if self.instance_decoder is not None:
            instance_x = self.instance_decoder(pyramid, train, generator)
        return semantic_x, instance_x

    def _instance_maps(self, instance_x, interpolate_ins, train: bool = False):
        ctr_hmp = self.ins_center(instance_x, train)
        offsets = self.ins_xy(instance_x, train)
        if interpolate_ins or train:
            ctr_hmp, offsets = _up4(ctr_hmp), _up4(offsets)
        return _nhwc(ctr_hmp), _nhwc(offsets)

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True,
                train: bool = False, generator=None, point_coords=None):
        semantic_x, instance_x = self._encode_decode(x, train, generator)
        ctr_hmp, offsets = self._instance_maps(instance_x, interpolate_ins, train)
        sem = _up4(self.semantic_head(semantic_x, train))
        return {"sem_logits": _nhwc(sem), "ctr_hmp": ctr_hmp, "offsets": offsets}


def _pr_kwargs(num_fc, subdivision_num_points, fused_render, train_num_points,
               oversample_ratio, importance_sample_ratio):
    return dict(num_fc=num_fc, subdivision_num_points=subdivision_num_points,
                fused_render=fused_render, train_num_points=train_num_points,
                oversample_ratio=oversample_ratio,
                importance_sample_ratio=importance_sample_ratio)


class PanopticDeepLabPR(PanopticDeepLab):
    """PointRend semantic head variant: MitoNet_v1's architecture."""

    def __init__(self, *args, num_fc: int = 3, subdivision_num_points: int = 8192,
                 fused_render: str = "auto", train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75,
                 **kwargs):
        super().__init__(*args, **kwargs)
        dc = self.semantic_head.predict.in_channels
        self.semantic_pr = PointRendSemSegHead(dc, self.num_classes, dc, **_pr_kwargs(
            num_fc, subdivision_num_points, fused_render, train_num_points,
            oversample_ratio, importance_sample_ratio))

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True,
                train: bool = False, generator=None, point_coords=None):
        semantic_x, instance_x = self._encode_decode(x, train, generator)
        ctr_hmp, offsets = self._instance_maps(instance_x, interpolate_ins, train)
        sem = _nhwc(self.semantic_head(semantic_x, train))
        pr = self.semantic_pr(sem, _nhwc(semantic_x), subdivision_steps=render_steps,
                              train=train, generator=generator, point_coords=point_coords)
        if not train:
            return {"sem_logits": pr["sem_seg_logits"], "ctr_hmp": ctr_hmp,
                    "offsets": offsets}
        return {"sem_logits": _nhwc(_up4(sem.permute(0, 3, 1, 2))),
                "sem_points": pr["point_logits"], "point_coords": pr["point_coords"],
                "ctr_hmp": ctr_hmp, "offsets": offsets}


class PanopticDeepLabBC(PanopticDeepLab):
    """Boundary-contour variant: a semantic and a boundary head, each
    refined by its own PointRend head; no center or offset heads (the flax
    model builds them but never calls them, so they hold no parameters)."""

    instance_heads = False

    def __init__(self, *args, num_fc: int = 3, subdivision_num_points: int = 8192,
                 fused_render: str = "auto", train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75,
                 **kwargs):
        super().__init__(*args, **kwargs)
        dc = self.semantic_head.predict.in_channels
        self.boundary_head = PanopticDeepLabHead(dc, 1)
        pr = _pr_kwargs(num_fc, subdivision_num_points, fused_render, train_num_points,
                        oversample_ratio, importance_sample_ratio)
        self.semantic_pr = PointRendSemSegHead(dc, self.num_classes, dc, **pr)
        self.boundary_pr = PointRendSemSegHead(dc, self.num_classes, dc, **pr)

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True,
                train: bool = False, generator=None, point_coords=None):
        semantic_x, instance_x = self._encode_decode(x, train, generator)
        sem = _nhwc(self.semantic_head(semantic_x, train))
        cnt = _nhwc(self.boundary_head(instance_x, train))
        coords = point_coords or {}
        kw = dict(subdivision_steps=render_steps, train=train, generator=generator)
        sem = self.semantic_pr(sem, _nhwc(semantic_x), point_coords=coords.get("sem"), **kw)
        cnt = self.boundary_pr(cnt, _nhwc(instance_x), point_coords=coords.get("cnt"), **kw)
        if not train:
            return {"sem_logits": sem["sem_seg_logits"], "cnt_logits": cnt["sem_seg_logits"]}
        out = {}
        for key, pr in (("sem", sem), ("cnt", cnt)):
            out[f"{key}_logits"] = _nhwc(_up4(pr["sem_seg_logits"].permute(0, 3, 1, 2)))
            out[f"{key}_points"] = pr["point_logits"]
            out[f"{key}_point_coords"] = pr["point_coords"]
        return out
