"""Model registry, model bundles, seeded model construction and input
preprocessing (counterpart of ``empanada_tpu/api/utils.py``).

Registry configs are the yaml files of the port's ``configs/`` plus
``~/.empanada_tpu_torch/configs``.  A config's ``model`` names a bundle in
the port's own format (``save_model_bundle``): a zip of ``config.json``
(architecture and constructor kwargs) and ``state_dict.pt`` (a
``torch.save`` state dict, loaded with ``weights_only=True``).  The JAX
package's ``.eptpu`` bundles hold flax msgpack, which the port does not
read; its variables reach the port through ``port.weights.from_flax``.
"""

from __future__ import annotations

import io
import json
import math
import os
import zipfile
from glob import glob

import numpy as np
import torch
import yaml
from torch import nn

from empanada_tpu_torch.api.config import load_config as load_config_file
from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.models.blocks import BatchNorm
from empanada_tpu_torch.utils import resolve_device

__all__ = [
    "CONFIG_DIR",
    "MODEL_DIR",
    "get_configs",
    "load_config",
    "add_new_model",
    "save_model_bundle",
    "load_model_bundle",
    "load_model_from_config",
    "init_model_from_config",
    "randomize_bn_stats",
    "normalize",
    "Preprocessor",
]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")
MODEL_DIR = os.path.join(os.path.expanduser("~"), ".empanada_tpu_torch")
BUNDLE_EXT = ".eptorch"
BUNDLE_FORMAT = 1


def get_configs() -> dict:
    """``{name: yaml path}`` of the packaged configs, then the user's
    (``MODEL_DIR/configs``; a user config shadows a packaged one)."""
    configs = {}
    for d in (CONFIG_DIR, os.path.join(MODEL_DIR, "configs")):
        for fn in sorted(glob(os.path.join(d, "*.yaml"))):
            configs[os.path.splitext(os.path.basename(fn))[0]] = fn
    return configs


def load_config(name_or_path: str = "MitoNet_v1") -> dict:
    """A registry config by name or a yaml file by path, with its ``BASE``
    parents applied."""
    path = name_or_path
    if not os.path.isfile(path):
        configs = get_configs()
        if name_or_path not in configs:
            raise KeyError(f"unknown model {name_or_path!r}; registered: {sorted(configs)}")
        path = configs[name_or_path]
    return load_config_file(path)


def add_new_model(model_name: str, config: dict, model_file: str | None = None) -> str:
    """Register ``config`` as ``model_name`` in the user's registry
    (``MODEL_DIR/configs/<model_name>.yaml``, read by ``get_configs``);
    ``model_file``, a bundle that must exist, becomes its ``model``.
    Returns the yaml's path."""
    config_dir = os.path.join(MODEL_DIR, "configs")
    os.makedirs(config_dir, exist_ok=True)
    if model_file is not None:
        if not os.path.isfile(model_file):
            raise FileNotFoundError(f"{model_file} is not a file")
        config = dict(config, model=model_file)
    path = os.path.join(config_dir, f"{model_name}.yaml")
    with open(path, "w") as f:
        yaml.dump(config, f)
    return path


def save_model_bundle(path: str, arch: str, model_kwargs: dict, model: nn.Module) -> str:
    """Write ``model``'s weights as a bundle (the module docstring's
    format) at ``path`` (``BUNDLE_EXT`` appended when missing); returns
    the path."""
    if not path.endswith(BUNDLE_EXT):
        path = path + BUNDLE_EXT
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, buf)
    meta = {"arch": arch, "model_kwargs": model_kwargs, "format": BUNDLE_FORMAT}
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("config.json", json.dumps(meta))
        zf.writestr("state_dict.pt", buf.getvalue())
    return path


def load_model_bundle(path: str, device=None, dtype=torch.float32) -> nn.Module:
    """The model of a bundle written by ``save_model_bundle``, on ``device``
    (default "cuda"; raises without a GPU unless ``device="cpu"``)."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if "state_dict.pt" not in names:
            raise ValueError(
                f"{path} is not a bundle of the port (no state_dict.pt; a JAX "
                "package bundle holds flax msgpack, which reaches the port through "
                "port.weights.from_flax and save_model_bundle)")
        meta = json.loads(zf.read("config.json"))
        state = torch.load(io.BytesIO(zf.read("state_dict.pt")), map_location="cpu",
                           weights_only=True)
    if meta.get("format") != BUNDLE_FORMAT:
        raise ValueError(f"model bundle {path} has format {meta.get('format')}, this "
                         f"build reads {BUNDLE_FORMAT}")
    model = create_model(meta["arch"], device="cpu", **meta["model_kwargs"])
    model.load_state_dict(state)
    return model.to(device=resolve_device(device), dtype=dtype)


def load_model_from_config(model_config: dict, device=None, dtype=torch.float32) -> nn.Module:
    """The model of the bundle that the config's ``model`` names (a local
    path; the URL download cache is ROADMAP item 13)."""
    model_path = model_config["model"]
    if isinstance(model_path, str) and "://" in model_path:
        raise NotImplementedError(
            f"model {model_path!r}: downloading bundles is ROADMAP item 13; pass a "
            "local path")
    model_path = os.path.expanduser(model_path)
    if not os.path.isfile(model_path):
        raise FileNotFoundError(
            f"model bundle {model_path} not found; write one with save_model_bundle, "
            "or build a seeded model with init_model_from_config()")
    return load_model_bundle(model_path, device=device, dtype=dtype)


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
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                # a transposed conv's weight is (in, out, k, k)
                fan_in = (m.weight.shape[0] * m.weight[0, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel())
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
