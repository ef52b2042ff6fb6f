"""Config loading, seeded model construction and input preprocessing (a
small counterpart of ``empanada_tpu/api/utils.py``)."""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import yaml
from torch import nn

from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.models.blocks import BatchNorm
from empanada_tpu_torch.utils import resolve_device

__all__ = [
    "CONFIG_DIR",
    "load_config",
    "init_model_from_config",
    "randomize_bn_stats",
    "normalize",
    "Preprocessor",
]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")


def load_config(name_or_path: str = "MitoNet_v1") -> dict:
    """A registry config by name (from the port's ``configs/``) or path."""
    path = name_or_path
    if not os.path.isfile(path):
        path = os.path.join(CONFIG_DIR, f"{name_or_path}.yaml")
    with open(path) as f:
        return yaml.safe_load(f)


def randomize_bn_stats(model: nn.Module, generator: torch.Generator) -> None:
    """Random running statistics (mean ~ N(0, 0.1), var ~ U(0.5, 1.5)), so
    that an untrained model's maps, and its PointRend uncertainty, are not
    near-constant."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                shape = m.running_mean.shape
                mean = torch.randn(shape, generator=generator) * 0.1
                var = torch.rand(shape, generator=generator) + 0.5
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)


def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded LeCun-normal weights (flax's default) and zero biases."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()


def init_model_from_config(config: dict, seed: int = 0, device=None,
                           dtype=torch.float32):
    """The config's architecture with seeded random weights and randomized
    batch-norm running statistics on ``device`` (default "cuda"; raises
    without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    model = create_model(config["arch"], device="cpu", **config["model_kwargs"])
    gen = torch.Generator().manual_seed(seed)
    _init_weights(model, gen)
    randomize_bn_stats(model, gen)
    return model.to(device=dev, dtype=dtype)


def normalize(img: np.ndarray, mean, std, max_pixel_value: float = 255.0) -> np.ndarray:
    """(img - mean * max) / (std * max), float32."""
    mean = np.float32(mean) * np.float32(max_pixel_value)
    denom = np.reciprocal(np.float32(std) * np.float32(max_pixel_value), dtype=np.float32)
    img = img.astype(np.float32)
    img -= mean
    img *= denom
    return img


class Preprocessor:
    """Rejects float input and normalizes by mean/std scaled to the dtype max."""

    def __init__(self, mean=None, std=None):
        self.mean = mean
        self.std = std

    def __call__(self, image: np.ndarray) -> dict:
        if np.issubdtype(image.dtype, np.floating):
            raise TypeError("input image cannot be float type")
        max_value = np.iinfo(image.dtype).max
        image = normalize(image, self.mean, self.std, max_pixel_value=max_value)
        return {"image": image[None]}  # (1, H, W)
