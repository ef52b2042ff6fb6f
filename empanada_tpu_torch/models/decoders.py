"""ASPP and the Panoptic-DeepLab top-down decoder (counterpart of
``empanada_tpu/models/decoders.py``; BiFPN is not ported yet)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from empanada_tpu_torch.models.blocks import ConvBnAct, SeparableConvBnAct
from empanada_tpu_torch.ops.interpolate import bilinear_resize_nchw

__all__ = ["ASPP", "PanopticDeepLabDecoder"]


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 + global image pooling, concat, 1x1 project.
    Eval only: the projection's dropout is the identity."""

    def __init__(self, nin: int, out_channels: int,
                 atrous_rates: Sequence[int] = (2, 4, 6)):
        super().__init__()
        self.conv1x1 = ConvBnAct(nin, out_channels, 1)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"aspp_conv{i + 1}",
                            ConvBnAct(nin, out_channels, 3, dilation=rate))
        self.n_rates = len(atrous_rates)
        self.pool_conv = nn.Conv2d(nin, out_channels, 1, bias=False)
        self.project = ConvBnAct(out_channels * (2 + len(atrous_rates)),
                                 out_channels, 1)

    def forward(self, x):
        size = x.shape[2:]
        res = [self.conv1x1(x)]
        res += [getattr(self, f"aspp_conv{i + 1}")(x) for i in range(self.n_rates)]
        pooled = F.relu(self.pool_conv(x.mean(dim=(2, 3), keepdim=True)))
        res.append(bilinear_resize_nchw(pooled, size, align_corners=True))
        return self.project(torch.cat(res, dim=1))


class PanopticDeepLabDecoder(nn.Module):
    """ASPP, then per low-level stage: project, align-corners upsample,
    concat and a 5x5 separable fuse."""

    def __init__(self, pyramid_widths: Sequence[int], decoder_channels: int,
                 low_level_stages: Sequence[int],
                 low_level_channels_project: Sequence[int],
                 atrous_rates: Sequence[int] = (2, 4, 6),
                 aspp_channels: Optional[int] = None):
        super().__init__()
        aspp_channels = aspp_channels or decoder_channels
        self.aspp = ASPP(pyramid_widths[-1], aspp_channels, atrous_rates)
        self.low_level_stages = tuple(low_level_stages)
        ch = aspp_channels
        for i, stage in enumerate(low_level_stages):
            proj = low_level_channels_project[i]
            self.add_module(f"project{i}", ConvBnAct(pyramid_widths[stage], proj, 1))
            self.add_module(f"fuse{i}", SeparableConvBnAct(ch + proj, decoder_channels, 5))
            ch = decoder_channels

    def forward(self, pyramid):
        x = self.aspp(pyramid[-1])
        for i, stage in enumerate(self.low_level_stages):
            low = getattr(self, f"project{i}")(pyramid[stage])
            x = bilinear_resize_nchw(x, low.shape[2:], align_corners=True)
            x = getattr(self, f"fuse{i}")(torch.cat([x, low], dim=1))
        return x
