"""Panoptic-DeepLab model assemblies, eval only (counterpart of
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


def create_encoder(name: str, output_stride: int = 32):
    """(encoder, pyramid widths): a ResNet or RegNet by config name; the
    widths are those of the encoder's whole pyramid, stem first."""
    if name in resnet_configs:
        enc = ResNet(output_stride=output_stride, **resnet_configs[name])
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
                 ins_decoder: bool = False, ins_ratio: float = 0.5):
        # aspp_dropout is a training setting: eval dropout is the identity
        super().__init__()
        self.num_classes = num_classes
        self.encoder, widths = create_encoder(encoder, stage4_stride)
        self.semantic_decoder = PanopticDeepLabDecoder(
            widths, decoder_channels, low_level_stages, low_level_channels_project,
            atrous_rates, aspp_channels)
        self.instance_decoder = None
        if ins_decoder:
            self.instance_decoder = PanopticDeepLabDecoder(
                widths, decoder_channels, low_level_stages,
                [int(s * ins_ratio) for s in low_level_channels_project],
                atrous_rates, aspp_channels)
        self.semantic_head = PanopticDeepLabHead(decoder_channels, num_classes)
        if self.instance_heads:
            self.ins_center = PanopticDeepLabHead(decoder_channels, 1)
            self.ins_xy = PanopticDeepLabHead(decoder_channels, 2)

    def _encode_decode(self, x):
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pyramid = self.encoder(x)
        semantic_x = self.semantic_decoder(pyramid)
        instance_x = semantic_x
        if self.instance_decoder is not None:
            instance_x = self.instance_decoder(pyramid)
        return semantic_x, instance_x

    def _instance_maps(self, instance_x, interpolate_ins):
        ctr_hmp = self.ins_center(instance_x)
        offsets = self.ins_xy(instance_x)
        if interpolate_ins:
            ctr_hmp, offsets = _up4(ctr_hmp), _up4(offsets)
        return _nhwc(ctr_hmp), _nhwc(offsets)

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True):
        semantic_x, instance_x = self._encode_decode(x)
        ctr_hmp, offsets = self._instance_maps(instance_x, interpolate_ins)
        sem = _up4(self.semantic_head(semantic_x))
        return {"sem_logits": _nhwc(sem), "ctr_hmp": ctr_hmp, "offsets": offsets}


class PanopticDeepLabPR(PanopticDeepLab):
    """PointRend semantic head variant: MitoNet_v1's architecture."""

    def __init__(self, *args, num_fc: int = 3, subdivision_num_points: int = 8192,
                 fused_render: str = "auto", train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75,
                 **kwargs):
        # the three sampling settings are training-time; kept so configs load
        super().__init__(*args, **kwargs)
        dc = self.semantic_head.predict.in_channels
        self.semantic_pr = PointRendSemSegHead(
            dc, self.num_classes, dc, num_fc, subdivision_num_points, fused_render)

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True):
        semantic_x, instance_x = self._encode_decode(x)
        ctr_hmp, offsets = self._instance_maps(instance_x, interpolate_ins)
        sem = _nhwc(self.semantic_head(semantic_x))
        pr = self.semantic_pr(sem, _nhwc(semantic_x), subdivision_steps=render_steps)
        return {"sem_logits": pr["sem_seg_logits"], "ctr_hmp": ctr_hmp,
                "offsets": offsets}


class PanopticDeepLabBC(PanopticDeepLab):
    """Boundary-contour variant: a semantic and a boundary head, each
    refined by its own PointRend head; no center or offset heads (the flax
    model builds them but never calls them, so they hold no parameters)."""

    instance_heads = False

    def __init__(self, *args, num_fc: int = 3, subdivision_num_points: int = 8192,
                 fused_render: str = "auto", train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75,
                 **kwargs):
        # the three sampling settings are training-time; kept so configs load
        super().__init__(*args, **kwargs)
        dc = self.semantic_head.predict.in_channels
        self.boundary_head = PanopticDeepLabHead(dc, 1)
        pr = (dc, self.num_classes, dc, num_fc, subdivision_num_points, fused_render)
        self.semantic_pr = PointRendSemSegHead(*pr)
        self.boundary_pr = PointRendSemSegHead(*pr)

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True):
        semantic_x, instance_x = self._encode_decode(x)
        sem = _nhwc(self.semantic_head(semantic_x))
        cnt = _nhwc(self.boundary_head(instance_x))
        sem = self.semantic_pr(sem, _nhwc(semantic_x), subdivision_steps=render_steps)
        cnt = self.boundary_pr(cnt, _nhwc(instance_x), subdivision_steps=render_steps)
        return {"sem_logits": sem["sem_seg_logits"], "cnt_logits": cnt["sem_seg_logits"]}
