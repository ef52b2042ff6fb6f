"""ResNet encoders returning a 5-level feature pyramid (counterpart of
``empanada_tpu/models/resnet.py``): 1-channel stem, output stride 16
(dilated layer4 at stride 1) or 32, pyramid = [stem + pool, layer1..4]."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from empanada_tpu_torch.models.blocks import BatchNorm, ConvBnAct, max_pool_2d

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet_configs", "RESNET_WIDTHS"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, int8_execution: bool = False, **_):
        super().__init__()
        self.cba1 = ConvBnAct(inplanes, planes, 3, stride=stride,
                              int8_execution=int8_execution)
        self.cba2 = ConvBnAct(planes, planes, 3, activation=None,
                              int8_execution=int8_execution)
        self.downsample = (
            ConvBnAct(inplanes, planes, 1, stride=stride, activation=None)
            if downsample else None
        )

    def forward(self, x, train: bool = False):
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(self.cba2(self.cba1(x, train), train) + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64,
                 dilation: int = 1, int8_execution: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.cba1 = ConvBnAct(inplanes, width, 1)
        self.cba2 = ConvBnAct(width, width, 3, stride=stride, groups=groups,
                              dilation=dilation, int8_execution=int8_execution)
        self.cba3 = ConvBnAct(width, out, 1, activation=None)
        self.downsample = (
            ConvBnAct(inplanes, out, 1, stride=stride, activation=None)
            if downsample else None
        )

    def forward(self, x, train: bool = False):
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(self.cba3(self.cba2(self.cba1(x, train), train), train) + identity)


class ResNet(nn.Module):
    """Returns the pyramid [p1 (1/4, stem), p2 (1/4), p3 (1/8), p4 (1/16), p5].
    ``int8_execution``: the blocks' wide 3 x 3 convolutions run in int8 in
    eval mode (``blocks.ConvBnAct``), as in the JAX package."""

    def __init__(self, block: str, layers: Sequence[int], groups: int = 1,
                 width_per_group: int = 64, in_channels: int = 1,
                 output_stride: int = 32, int8_execution: bool = False):
        super().__init__()
        if output_stride not in (16, 32):
            raise ValueError(f"output_stride {output_stride}: expected 16 or 32")
        self.in_channels = in_channels
        self.block = block
        self.stem_conv = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        # output stride 16: layer4 runs at stride 1, dilated in bottlenecks
        # (a BasicBlock layer4 runs undilated, as in the JAX package)
        last_stride = 1 if output_stride == 16 else 2
        dilation = 2 if output_stride == 16 else 1
        inplanes = 64
        stages = [(64, 1, 1), (128, 2, 1), (256, 2, 1), (512, last_stride, dilation)]
        for s, ((planes, stride, dil), n_blocks) in enumerate(zip(stages, layers)):
            kw = dict(int8_execution=int8_execution)
            if block == "bottleneck":
                kw.update(groups=groups, base_width=width_per_group, dilation=dil)
            need_ds = stride != 1 or inplanes != planes * block_cls.expansion
            self.add_module(f"layer{s + 1}_block1", block_cls(
                inplanes, planes, stride=stride, downsample=need_ds, **kw))
            inplanes = planes * block_cls.expansion
            for i in range(1, n_blocks):
                self.add_module(f"layer{s + 1}_block{i + 1}",
                                block_cls(inplanes, planes, **kw))
        self.layers = tuple(layers)

    @property
    def widths(self) -> Tuple[int, ...]:
        exp = 1 if self.block == "basic" else 4
        return tuple(p * exp for p in (64, 128, 256, 512))

    def forward(self, x, train: bool = False):
        if x.shape[1] != self.in_channels:
            raise ValueError(
                f"input has {x.shape[1]} channels, model configured for "
                f"in_channels={self.in_channels}"
            )
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        pyramid = [max_pool_2d(x, 3, 2, 1)]
        for s, n_blocks in enumerate(self.layers):
            x = pyramid[-1]
            for i in range(n_blocks):
                x = getattr(self, f"layer{s + 1}_block{i + 1}")(x, train)
            pyramid.append(x)
        return pyramid


# name -> constructor kwargs
resnet_configs = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3)),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(block="bottleneck", layers=(3, 4, 6, 3), groups=32,
                            width_per_group=4),
    "resnext101_32x8d": dict(block="bottleneck", layers=(3, 4, 23, 3), groups=32,
                             width_per_group=8),
    "wide_resnet50_2": dict(block="bottleneck", layers=(3, 4, 6, 3),
                            width_per_group=128),
    "wide_resnet101_2": dict(block="bottleneck", layers=(3, 4, 23, 3),
                             width_per_group=128),
}

# name -> the widths of the four stages' outputs
RESNET_WIDTHS = {
    name: tuple(p * (1 if cfg["block"] == "basic" else 4) for p in (64, 128, 256, 512))
    for name, cfg in resnet_configs.items()
}
