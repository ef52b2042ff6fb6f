"""Prediction heads (counterpart of ``empanada_tpu/models/heads.py``):
5x5 separable conv-bn-relu, then a 1x1 projection with bias."""

from __future__ import annotations

from torch import nn

from empanada_tpu_torch.models.blocks import SeparableConvBnAct

__all__ = ["PanopticDeepLabHead"]


class PanopticDeepLabHead(nn.Module):
    def __init__(self, nin: int, n_classes: int):
        super().__init__()
        self.conv = SeparableConvBnAct(nin, nin, 5)
        self.predict = nn.Conv2d(nin, n_classes, 1, bias=True)

    def forward(self, x, train: bool = False):
        return self.predict(self.conv(x, train))
