"""Panoptic-BiFPN model assemblies (counterpart of
``empanada_tpu/models/panoptic_bifpn.py``): MitoNet_v1_mini's architecture
(regnety_6p4gf encoder, fpn_dim 160, 3 BiFPN layers).

The same interface, train mode included, and output contract as
``PanopticDeepLab{,PR}`` (``panoptic_deeplab.py``).  The encoder runs at output stride 32; its
stage 1 (1/4) is resampled to ``fpn_dim`` as P2, and its stages 2-4 (P3-P5)
feed the BiFPN, so inputs must be at least 128 px (P7 is at 1/128).
"""

from __future__ import annotations

import torch
from torch import nn

from empanada_tpu_torch.models.blocks import Resample2d
from empanada_tpu_torch.models.decoders import BiFPN, BiFPNDecoder
from empanada_tpu_torch.models.heads import PanopticDeepLabHead
from empanada_tpu_torch.models.panoptic_deeplab import (
    PanopticDeepLab,
    PanopticDeepLabPR,
    _pr_kwargs,
    create_encoder,
)
from empanada_tpu_torch.models.point_rend import PointRendSemSegHead

__all__ = ["PanopticBiFPN", "PanopticBiFPNPR"]


class PanopticBiFPN(nn.Module):
    def __init__(self, encoder: str = "regnety_6p4gf", num_classes: int = 1,
                 fpn_dim: int = 160, fpn_layers: int = 3, ins_decoder: bool = False,
                 depthwise: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.encoder, widths = create_encoder(encoder, 32)
        self.p2_resample = Resample2d(widths[1], fpn_dim)
        self.semantic_fpn = BiFPN(widths[2:], fpn_dim, fpn_layers, depthwise)
        self.semantic_decoder = BiFPNDecoder(fpn_dim)
        self.instance_fpn = self.instance_decoder = None
        if ins_decoder:
            self.instance_fpn = BiFPN(widths[2:], fpn_dim, fpn_layers, depthwise)
            self.instance_decoder = BiFPNDecoder(fpn_dim)
        self.semantic_head = PanopticDeepLabHead(fpn_dim, num_classes)
        self.ins_center = PanopticDeepLabHead(fpn_dim, 1)
        self.ins_xy = PanopticDeepLabHead(fpn_dim, 2)

    def _encode_decode(self, x, train: bool = False, generator=None):
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pyramid = self.encoder(x, train)
        p2 = self.p2_resample(pyramid[1], train)
        semantic_x = self.semantic_decoder(
            ([p2] + self.semantic_fpn(pyramid[2:], train))[::-1], train)
        instance_x = semantic_x
        if self.instance_fpn is not None:
            instance_x = self.instance_decoder(
                ([p2] + self.instance_fpn(pyramid[2:], train))[::-1], train)
        return semantic_x, instance_x

    # the heads and the forward are PanopticDeepLab's, on this trunk
    _instance_maps = PanopticDeepLab._instance_maps
    forward = PanopticDeepLab.forward


class PanopticBiFPNPR(PanopticBiFPN):
    """PointRend semantic head variant (fc_dim = fpn_dim): MitoNet_v1_mini."""

    def __init__(self, *args, num_fc: int = 3, subdivision_num_points: int = 8192,
                 fused_render: str = "auto", train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75,
                 **kwargs):
        super().__init__(*args, **kwargs)
        dim = self.semantic_head.predict.in_channels
        self.semantic_pr = PointRendSemSegHead(dim, self.num_classes, dim, **_pr_kwargs(
            num_fc, subdivision_num_points, fused_render, train_num_points,
            oversample_ratio, importance_sample_ratio))

    forward = PanopticDeepLabPR.forward
