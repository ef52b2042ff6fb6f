"""Shared conv building blocks (counterpart of
``empanada_tpu/models/blocks.py``).

Modules run NCHW (cuDNN); submodule names follow the flax module names so
that ``port.weights.from_flax`` is a mechanical walk.  Convolutions use
explicit symmetric padding ``dilation * (k - 1) // 2``, as the JAX package
does to match torch geometry under stride 2.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from empanada_tpu_torch.ops.interpolate import bilinear_resize_nchw
from empanada_tpu_torch.parallel.mesh import all_reduce_grad, current_data_mesh

__all__ = [
    "BatchNorm",
    "ConvBnAct",
    "ConvTransposeBnAct",
    "Interpolate2d",
    "Resample2d",
    "Resize2d",
    "SeparableConv",
    "SeparableConvBnAct",
    "SqueezeExcite",
    "frozen_batch_stats",
    "max_pool_2d",
]

_ACTS = {"relu": F.relu, "silu": F.silu, None: None}


def max_pool_2d(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool over NCHW with symmetric padding; the padding acts as -inf."""
    return F.max_pool2d(x, window, stride, padding)


_STATS = threading.local()


@contextlib.contextmanager
def frozen_batch_stats():
    """Inside, a train-mode ``BatchNorm`` normalises with its batch
    statistics but leaves the running statistics as they are: a forward
    recomputed under activation checkpointing must not fold its batch in a
    second time."""
    prev = getattr(_STATS, "frozen", False)
    _STATS.frozen = True
    try:
        yield
    finally:
        _STATS.frozen = prev


class BatchNorm(nn.Module):
    """Batch norm with flax's semantics, eps 1e-5, momentum 0.9.

    Holds exactly the flax BatchNorm's four leaves (scale, bias, mean, var)
    as ``weight``, ``bias``, ``running_mean`` and ``running_var``.  With
    ``train`` False it normalises with the running statistics.  With
    ``train`` True it normalises with the batch's biased mean and variance
    (reduced in float32, gradients through them) and updates the running
    statistics to ``0.9 running + 0.1 batch``, the BIASED variance as flax
    keeps it (``F.batch_norm``'s own update folds in the unbiased one).
    The mode is the ``train`` argument, never ``nn.Module.training``.
    Under ``parallel.mesh.data_parallel`` the batch statistics are those
    of the global batch, all ranks' rows together.
    """

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        mesh = current_data_mesh()
        if mesh is not None:
            return self._global_train(x, mesh)
        # momentum 1 makes F.batch_norm write the batch's own statistics
        # (mean, unbiased variance) into these two buffers
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, training=True,
                         momentum=1.0, eps=self.eps)
        if not getattr(_STATS, "frozen", False):
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=(1 - m) * (n - 1) / n)
        return y

    def _global_train(self, x, mesh):
        """Train mode under ``parallel.mesh.data_parallel``: the mean and
        biased variance of the global batch (each a differentiable sum over
        the ranks, in float32 or wider), the same running update."""
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        count = (x.numel() // x.shape[1]) * mesh.size
        mean = all_reduce_grad(xf.sum(dim=(0, 2, 3)), mesh) / count
        centred = xf - mean[None, :, None, None]
        var = all_reduce_grad((centred * centred).sum(dim=(0, 2, 3)), mesh) / count
        scale = self.weight.to(dtype) * torch.rsqrt(var + self.eps)
        y = centred * scale[None, :, None, None] + self.bias.to(dtype)[None, :, None, None]
        if not getattr(_STATS, "frozen", False):
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean.detach().to(self.running_mean.dtype),
                                               alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach().to(self.running_var.dtype),
                                              alpha=1 - m)
        return y.to(x.dtype)


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

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
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

    def forward(self, x, train: bool = False):
        x = self.bn(self.sepconv(x), train)
        return self.act(x) if self.act is not None else x


class ConvTransposeBnAct(nn.Module):
    """Transposed conv with stride == kernel (no bias) + batch norm +
    activation.  The flax kernel maps to ``tconv.weight`` flipped in space
    (``port.weights``): flax's ``ConvTranspose`` does not transpose its
    kernel, so its output tap ``a`` reads kernel tap ``k - 1 - a``."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 2,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.tconv = nn.ConvTranspose2d(nin, nout, kernel_size, stride=kernel_size,
                                        bias=False)
        self.bn = BatchNorm(nout)
        self.act = _ACTS[activation]

    def forward(self, x, train: bool = False):
        x = self.bn(self.tconv(x), train)
        return self.act(x) if self.act is not None else x


class SqueezeExcite(nn.Module):
    """Squeeze-excite with squeeze factor 4 that gates PER PIXEL: 1x1
    squeeze (with bias), relu, 1x1 excite (with bias), sigmoid.  There is no
    pooling: the reference's ``AvgPool2d((1, 1))`` is the identity, and its
    published SE weights were trained so (PARITY §2.2)."""

    def __init__(self, nin: int):
        super().__init__()
        self.squeeze = nn.Conv2d(nin, nin // 4, 1, bias=True)
        self.excite = nn.Conv2d(nin // 4, nin, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.excite(F.relu(self.squeeze(x))))


class Resample2d(nn.Module):
    """1x1 ConvBnAct when the width or the stride changes; otherwise the
    identity, with no parameters."""

    def __init__(self, nin: int, nout: int, stride: int = 1,
                 activation: Optional[str] = None):
        super().__init__()
        self.conv = None
        if nin != nout or stride > 1:
            self.conv = ConvBnAct(nin, nout, 1, stride=stride, activation=activation)

    def forward(self, x, train: bool = False):
        return x if self.conv is None else self.conv(x, train)


class Interpolate2d(nn.Module):
    """Resize by an integer ``scale_factor``: nearest (source index
    floor(i / s)) or bilinear with the stated corner alignment."""

    def __init__(self, scale_factor: int, mode: str = "nearest",
                 align_corners: bool = False):
        super().__init__()
        if mode not in ("nearest", "bilinear"):
            raise ValueError(f"mode {mode!r}: expected 'nearest' or 'bilinear'")
        self.scale_factor = int(scale_factor)
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        if self.mode == "nearest":
            return F.interpolate(x, scale_factor=self.scale_factor, mode="nearest")
        s = self.scale_factor
        return bilinear_resize_nchw(x, (x.shape[2] * s, x.shape[3] * s),
                                    align_corners=self.align_corners)


class Resize2d(nn.Module):
    """Nearest upsample by ``scale_factor`` ("up"), or a 3x3 max pool at
    stride ``scale_factor`` with padding 1 ("down")."""

    def __init__(self, scale_factor: int = 2, up_or_down: str = "up"):
        super().__init__()
        if up_or_down not in ("up", "down"):
            raise ValueError(f"up_or_down {up_or_down!r}: expected 'up' or 'down'")
        self.scale_factor = int(scale_factor)
        self.up = up_or_down == "up"

    def forward(self, x):
        if self.up:
            # at an integer factor, floor(i / s): the JAX package's table
            return F.interpolate(x, scale_factor=self.scale_factor, mode="nearest")
        return max_pool_2d(x, 3, self.scale_factor, 1)
