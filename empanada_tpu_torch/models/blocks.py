"""Shared conv building blocks (counterpart of
``empanada_tpu/models/blocks.py``).

Modules run NCHW (cuDNN); submodule names follow the flax module names so
that ``port.weights.from_flax`` is a mechanical walk.  Convolutions use
explicit symmetric padding ``dilation * (k - 1) // 2``, as the JAX package
does to match torch geometry under stride 2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm",
    "ConvBnAct",
    "SeparableConv",
    "SeparableConvBnAct",
    "max_pool_2d",
]

_ACTS = {"relu": F.relu, None: None}


def max_pool_2d(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool over NCHW with symmetric padding; the padding acts as -inf."""
    return F.max_pool2d(x, window, stride, padding)


class BatchNorm(nn.Module):
    """Inference batch norm, eps 1e-5, over running statistics.

    Holds exactly the flax BatchNorm's four leaves (scale, bias, mean, var)
    as ``weight``, ``bias``, ``running_mean`` and ``running_var``.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def conv2d(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
           dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    p = dilation * (k - 1) // 2
    return nn.Conv2d(cin, cout, k, stride=stride, padding=p, dilation=dilation,
                     groups=groups, bias=bias)


class ConvBnAct(nn.Module):
    """conv (no bias) + batch norm + activation."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 3, stride: int = 1,
                 groups: int = 1, dilation: int = 1,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.conv = conv2d(nin, nout, kernel_size, stride, groups, dilation)
        self.bn = BatchNorm(nout)
        self.act = _ACTS[activation]

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class SeparableConv(nn.Module):
    """Depthwise k x k then pointwise 1 x 1."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.depthwise = conv2d(nin, nin, kernel_size, stride, groups=nin,
                                bias=use_bias)
        self.pointwise = conv2d(nin, nout, 1, bias=use_bias)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SeparableConvBnAct(nn.Module):
    """Separable conv (no bias) + batch norm + activation."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.sepconv = SeparableConv(nin, nout, kernel_size, stride, use_bias=False)
        self.bn = BatchNorm(nout)
        self.act = _ACTS[activation]

    def forward(self, x):
        x = self.bn(self.sepconv(x))
        return self.act(x) if self.act is not None else x
