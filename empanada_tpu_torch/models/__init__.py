"""Model layer: PyTorch Panoptic-DeepLab and Panoptic-BiFPN models, eval
and train modes (counterpart of ``empanada_tpu/models``)."""

from __future__ import annotations

import torch

from empanada_tpu_torch.models.panoptic_bifpn import PanopticBiFPN, PanopticBiFPNPR
from empanada_tpu_torch.models.panoptic_deeplab import (
    PanopticDeepLab,
    PanopticDeepLabBC,
    PanopticDeepLabPR,
)
from empanada_tpu_torch.models.regnet import RegNet, RegNetParams, regnet_configs
from empanada_tpu_torch.models.resnet import ResNet, resnet_configs
from empanada_tpu_torch.utils import resolve_device

MODEL_REGISTRY = {
    "PanopticDeepLab": PanopticDeepLab,
    "PanopticDeepLabPR": PanopticDeepLabPR,
    "PanopticDeepLabBC": PanopticDeepLabBC,
    "PanopticBiFPN": PanopticBiFPN,
    "PanopticBiFPNPR": PanopticBiFPNPR,
}


def create_model(arch: str, device=None, dtype=torch.float32, **kwargs):
    """Instantiate ``arch`` in eval mode on ``device`` (default "cuda";
    raises without a GPU unless ``device="cpu"``) in ``dtype``."""
    if arch not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch {arch}, choices: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    return MODEL_REGISTRY[arch](**kwargs).eval().to(device=dev, dtype=dtype)


__all__ = [
    "MODEL_REGISTRY",
    "create_model",
    "PanopticDeepLab",
    "PanopticDeepLabPR",
    "PanopticDeepLabBC",
    "PanopticBiFPN",
    "PanopticBiFPNPR",
    "ResNet",
    "RegNet",
    "RegNetParams",
    "resnet_configs",
    "regnet_configs",
]
