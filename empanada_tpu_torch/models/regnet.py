"""RegNetX/Y encoders returning a 5-level feature pyramid (counterpart of
``empanada_tpu/models/regnet.py``).

Stage widths, depths and groups come from the RegNet design-space
equations (https://arxiv.org/abs/2003.13678); regnety_6p4gf is
MitoNet_v1_mini's backbone.  Pyramid: [stem (1/2), stage1 (1/4), stage2
(1/8), stage3 (1/16), stage4 (1/32, or 1/16 at output stride 16)].  The
stem is a direct 3x3 / 2 conv (the JAX package's space-to-depth stem
exists for the TPU's matrix unit).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.nn.functional as F
from torch import nn

from empanada_tpu_torch.models.blocks import ConvBnAct, Resample2d, SqueezeExcite

__all__ = ["RegNet", "RegNetParams", "regnet_configs"]


class RegNetParams:
    """Stage widths, depths and group counts of one design-space point."""

    w_stem = 32
    bottle_ratio = 1

    def __init__(self, depth, w_0, w_a, w_m, group_w, q=8, use_se=False):
        if not (w_a >= 0 and w_0 > 0 and w_m > 1 and w_0 % q == 0):
            raise ValueError(f"bad RegNet parameters w_0={w_0} w_a={w_a} w_m={w_m} q={q}")
        self.use_se = use_se

        # eqn (2)-(4): continuous widths quantized to stages
        u = w_0 + np.arange(depth) * w_a
        s = np.round(np.log(u / w_0) / np.log(w_m))
        w = w_0 * np.power(w_m, s)
        w = q * np.round(w / q).astype(int)
        w, d = np.unique(w, return_counts=True)
        if len(w) != 4:
            raise ValueError(f"RegNet parameters give {len(w)} stages, not 4")

        # widths and groups adjusted for divisibility; a stage's groups is
        # the NUMBER of groups, w_b // group width
        b = self.bottle_ratio
        adj_ws, adj_groups = [], []
        for width, gw in zip(w.tolist(), [group_w] * 4):
            w_b = int(max(1, width * b))
            gw = int(min(gw, w_b))
            m = np.lcm(gw, b) if b > 1 else gw
            w_b = max(m, int(m * round(w_b / m)))
            adj_ws.append(int(w_b / b))
            adj_groups.append(w_b // gw)

        self.widths = adj_ws
        self.depths = d.tolist()
        self.groups = adj_groups


class _RegNetBottleneck(nn.Module):
    def __init__(self, w_in: int, w_out: int, groups: int = 1, stride: int = 1,
                 use_se: bool = False, bottle_ratio: float = 1.0):
        super().__init__()
        w_b = int(round(w_out * bottle_ratio))
        self.downsample = Resample2d(w_in, w_out, stride=stride)
        self.a = ConvBnAct(w_in, w_b, 1)
        self.b = ConvBnAct(w_b, w_b, 3, stride=stride, groups=groups)
        self.se = SqueezeExcite(w_b) if use_se else None
        self.c = ConvBnAct(w_b, w_out, 1, activation=None)

    def forward(self, x, train: bool = False):
        identity = self.downsample(x, train)
        out = self.b(self.a(x, train), train)
        if self.se is not None:
            out = self.se(out)
        return F.relu(identity + self.c(out, train))


class RegNet(nn.Module):
    def __init__(self, widths: Sequence[int], depths: Sequence[int],
                 groups: Sequence[int], use_se: bool = False, im_channels: int = 1,
                 output_stride: int = 32):
        super().__init__()
        if output_stride not in (16, 32):
            raise ValueError(f"output_stride {output_stride}: expected 16 or 32")
        self.im_channels = im_channels
        self.widths = tuple(widths)
        self.depths = tuple(depths)
        strides = [2, 2, 2, 2 if output_stride == 32 else 1]
        self.stem = ConvBnAct(im_channels, RegNetParams.w_stem, 3, stride=2)
        w_in = RegNetParams.w_stem
        for i, (w, d, g, s) in enumerate(zip(widths, depths, groups, strides)):
            for j in range(d):
                self.add_module(f"stage{i + 1}_block{j + 1}", _RegNetBottleneck(
                    w_in, w, groups=g, stride=s if j == 0 else 1, use_se=use_se))
                w_in = w

    def forward(self, x, train: bool = False):
        if x.shape[1] != self.im_channels:
            raise ValueError(f"input has {x.shape[1]} channels, model configured for "
                             f"im_channels={self.im_channels}")
        x = self.stem(x, train)
        pyramid = [x]
        for i, d in enumerate(self.depths):
            for j in range(d):
                x = getattr(self, f"stage{i + 1}_block{j + 1}")(x, train)
            pyramid.append(x)
        return pyramid


# name -> design-space parameters (the reference's regnet.py)
regnet_configs = {
    "regnetx_6p4gf": dict(depth=17, w_0=184, w_a=60.83, w_m=2.07, group_w=56),
    "regnety_200mf": dict(depth=13, w_0=24, w_a=36.44, w_m=2.49, group_w=8),
    "regnety_800mf": dict(depth=14, w_0=56, w_a=38.84, w_m=2.4, group_w=16),
    "regnety_3p2gf": dict(depth=21, w_0=80, w_a=42.63, w_m=2.66, group_w=24),
    "regnety_4gf": dict(depth=22, w_0=96, w_a=31.41, w_m=2.24, group_w=64),
    "regnety_6p4gf": dict(depth=25, w_0=112, w_a=33.22, w_m=2.27, group_w=72, use_se=True),
    "regnety_8gf": dict(depth=17, w_0=192, w_a=76.82, w_m=2.19, group_w=56, use_se=True),
    "regnety_16gf": dict(depth=18, w_0=200, w_a=106.23, w_m=2.48, group_w=112, use_se=True),
}
