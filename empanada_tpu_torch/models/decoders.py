"""ASPP, the Panoptic-DeepLab top-down decoder, and BiFPN with its
transposed-conv decoder (counterpart of ``empanada_tpu/models/decoders.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from empanada_tpu_torch.models.blocks import (
    ConvBnAct,
    ConvTransposeBnAct,
    Resample2d,
    Resize2d,
    SeparableConvBnAct,
)
from empanada_tpu_torch.ops.interpolate import bilinear_resize_nchw
from empanada_tpu_torch.parallel.mesh import global_rand
from empanada_tpu_torch.parallel.spatial import spatial_global_mean

__all__ = ["ASPP", "PanopticDeepLabDecoder", "BiFPN", "BiFPNDecoder"]


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None):
    """flax ``Dropout``: keep each element with probability ``1 - p`` (a
    uniform draw from ``generator`` below it) and scale it by
    ``1 / (1 - p)``; zero elsewhere."""
    if p <= 0:
        return x
    if p >= 1:
        return torch.zeros_like(x)
    keep = 1.0 - p
    # at the global batch's shape under data parallelism (parallel.mesh)
    mask = global_rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 + global image pooling, concat, 1x1 project,
    then dropout ``dropout_p`` in train mode (the identity in eval)."""

    def __init__(self, nin: int, out_channels: int,
                 atrous_rates: Sequence[int] = (2, 4, 6), dropout_p: float = 0.5):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.conv1x1 = ConvBnAct(nin, out_channels, 1)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"aspp_conv{i + 1}",
                            ConvBnAct(nin, out_channels, 3, dilation=rate))
        self.n_rates = len(atrous_rates)
        self.pool_conv = nn.Conv2d(nin, out_channels, 1, bias=False)
        self.project = ConvBnAct(out_channels * (2 + len(atrous_rates)),
                                 out_channels, 1)

    def forward(self, x, train: bool = False, generator=None):
        size = x.shape[2:]
        res = [self.conv1x1(x, train)]
        res += [getattr(self, f"aspp_conv{i + 1}")(x, train) for i in range(self.n_rates)]
        # the whole slice's mean when row blocks are spread over ranks
        # (parallel.spatial)
        pooled = F.relu(self.pool_conv(spatial_global_mean(x)))
        res.append(bilinear_resize_nchw(pooled, size, align_corners=True))
        x = self.project(torch.cat(res, dim=1), train)
        return dropout(x, self.dropout_p, generator) if train else x


class PanopticDeepLabDecoder(nn.Module):
    """ASPP, then per low-level stage: project, align-corners upsample,
    concat and a 5x5 separable fuse."""

    def __init__(self, pyramid_widths: Sequence[int], decoder_channels: int,
                 low_level_stages: Sequence[int],
                 low_level_channels_project: Sequence[int],
                 atrous_rates: Sequence[int] = (2, 4, 6),
                 aspp_channels: Optional[int] = None, aspp_dropout: float = 0.5):
        super().__init__()
        aspp_channels = aspp_channels or decoder_channels
        self.aspp = ASPP(pyramid_widths[-1], aspp_channels, atrous_rates, aspp_dropout)
        self.low_level_stages = tuple(low_level_stages)
        ch = aspp_channels
        for i, stage in enumerate(low_level_stages):
            proj = low_level_channels_project[i]
            self.add_module(f"project{i}", ConvBnAct(pyramid_widths[stage], proj, 1))
            self.add_module(f"fuse{i}", SeparableConvBnAct(ch + proj, decoder_channels, 5))
            ch = decoder_channels

    def forward(self, pyramid, train: bool = False, generator=None):
        x = self.aspp(pyramid[-1], train, generator)
        for i, stage in enumerate(self.low_level_stages):
            low = getattr(self, f"project{i}")(pyramid[stage], train)
            x = bilinear_resize_nchw(x, low.shape[2:], align_corners=True)
            x = getattr(self, f"fuse{i}")(torch.cat([x, low], dim=1), train)
        return x


def _fusion_weights(param: torch.Tensor) -> torch.Tensor:
    """Fast normalized fusion weights: relu(w) / (sum + 1e-4), in float32
    (0-d weights keep a bf16 map bf16)."""
    w = F.relu(param.float())
    return w / (w.sum() + 1e-4)


def _after_combine(fpn_dim: int, depthwise: bool) -> nn.Module:
    if depthwise:
        return SeparableConvBnAct(fpn_dim, fpn_dim, 3, activation="silu")
    return ConvBnAct(fpn_dim, fpn_dim, 3, activation="relu")


class _TopDownFPN(nn.Module):
    """Top-down pass over levels given smallest resolution first.  Level
    i + 1 is resampled to ``fpn_dim`` (a parameterless identity where it
    already has that width), fused with the 2x upsample of the level above,
    and passed through ONE ``after_combine`` conv shared by every level (the
    reference quirk)."""

    def __init__(self, in_widths: Sequence[int], fpn_dim: int, depthwise: bool = True):
        super().__init__()
        self.n_levels = len(in_widths) - 1
        self.fusion_weights = nn.Parameter(torch.ones(self.n_levels + 1))
        self.after_combine = _after_combine(fpn_dim, depthwise)
        for i in range(self.n_levels):
            self.add_module(f"resample{i}", Resample2d(in_widths[i + 1], fpn_dim))
        self.resize_up = Resize2d(2, "up")

    def forward(self, pyramid_features, train: bool = False):
        w = _fusion_weights(self.fusion_weights)
        td = [pyramid_features[0]]
        for i in range(self.n_levels):
            high_res = getattr(self, f"resample{i}")(pyramid_features[i + 1], train)
            w1, w2 = w[i], w[i + 1]
            fused = (w1 * self.resize_up(td[-1]) + w2 * high_res) / (w1 + w2 + 1e-4)
            td.append(self.after_combine(fused, train))
        return td


class _BottomUpFPN(nn.Module):
    """Bottom-up pass, largest resolution first: the max-pooled level below,
    the resampled input level and (except at the top) the top-down level,
    fused and passed through one shared ``after_combine``."""

    def __init__(self, in_widths: Sequence[int], fpn_dim: int, depthwise: bool = True):
        super().__init__()
        self.n_levels = len(in_widths)
        self.fusion_weights = nn.Parameter(torch.ones(self.n_levels + 1))
        self.after_combine = _after_combine(fpn_dim, depthwise)
        for i in range(self.n_levels):
            self.add_module(f"resample{i}", Resample2d(in_widths[i], fpn_dim))
        self.resize_down = Resize2d(2, "down")

    def forward(self, pyramid_features, top_down_features, train: bool = False):
        w = _fusion_weights(self.fusion_weights)
        bu = [top_down_features[0]]
        for i in range(self.n_levels):
            down = self.resize_down(bu[-1])
            pyr_low = getattr(self, f"resample{i}")(pyramid_features[i], train)
            if i < self.n_levels - 1:
                w1, w2, w3 = w[i], w[i + 1], w[i + 2]
                fused = (w1 * down + w2 * pyr_low + w3 * top_down_features[i + 1]) / (
                    w1 + w2 + w3 + 1e-4)
            else:
                w1, w2 = w[i], w[i + 1]
                fused = (w1 * down + w2 * pyr_low) / (w1 + w2 + 1e-4)
            bu.append(self.after_combine(fused, train))
        return bu


class _BiFPNLayer(nn.Module):
    def __init__(self, in_widths: Sequence[int], fpn_dim: int, depthwise: bool = True):
        super().__init__()
        self.top_down = _TopDownFPN(list(in_widths)[::-1], fpn_dim, depthwise)
        self.bottom_up = _BottomUpFPN(list(in_widths)[1:], fpn_dim, depthwise)

    def forward(self, pyramid_features, train: bool = False):
        td = self.top_down(pyramid_features[::-1], train)
        return self.bottom_up(pyramid_features[1:], td[::-1], train)


class BiFPN(nn.Module):
    """Adds P6 (resampled P5, max pooled) and P7 (P6 max pooled) to encoder
    features at strides 8-32 and stacks ``num_layers`` BiFPN layers; returns
    P3-P7, each ``fpn_dim`` wide.  Inputs must be at least 128 px: P7 is at
    1/128."""

    def __init__(self, in_widths: Sequence[int], fpn_dim: int, num_layers: int = 3,
                 depthwise: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.p6_resample = Resample2d(in_widths[-1], fpn_dim)
        self.downsize = Resize2d(2, "down")
        widths = list(in_widths) + [fpn_dim, fpn_dim]
        for i in range(num_layers):
            self.add_module(f"bifpn{i + 1}", _BiFPNLayer(widths, fpn_dim, depthwise))
            widths = [fpn_dim] * len(widths)

    def forward(self, pyramid_features, train: bool = False):
        p6 = self.downsize(self.p6_resample(pyramid_features[-1], train))
        feats = list(pyramid_features) + [p6, self.downsize(p6)]
        for i in range(self.num_layers):
            feats = getattr(self, f"bifpn{i + 1}")(feats, train)
        return feats


class BiFPNDecoder(nn.Module):
    """Over a pyramid given smallest resolution first, each ``fpn_dim``
    wide: ``n_fpn_scales`` times a 2x transposed conv, then concat with the
    next level; a 5x5 separable ``fusion`` conv at the largest level."""

    def __init__(self, fpn_dim: int, n_fpn_scales: int = 5):
        super().__init__()
        self.n_fpn_scales = n_fpn_scales
        for i in range(n_fpn_scales):
            nin = fpn_dim if i == 0 else 2 * fpn_dim
            self.add_module(f"up{i}", ConvTransposeBnAct(nin, fpn_dim, 2))
        self.fusion = SeparableConvBnAct(2 * fpn_dim, fpn_dim, 5)

    def forward(self, fpn_features, train: bool = False):
        if len(fpn_features) != self.n_fpn_scales + 1:
            raise ValueError(f"{len(fpn_features)} levels, expected {self.n_fpn_scales + 1}")
        x = fpn_features[0]
        for i, skip in enumerate(fpn_features[1:]):
            x = torch.cat([getattr(self, f"up{i}")(x, train), skip], dim=1)
        return self.fusion(x, train)
