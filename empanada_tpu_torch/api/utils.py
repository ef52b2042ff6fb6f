"""Model registry, model bundles, seeded model construction and input
preprocessing (counterpart of ``empanada_tpu/api/utils.py``).

Registry configs are the yaml files of the port's ``configs/`` plus
``~/.empanada_tpu_torch/configs``.  A config's ``model`` names a bundle in
the port's own format (``save_model_bundle``): a zip of ``config.json``
(architecture and constructor kwargs) and ``state_dict.pt`` (a
``torch.save`` state dict, loaded with ``weights_only=True``).  The JAX
package's ``.eptpu`` bundles hold flax msgpack, which the port does not
read; its variables reach the port through ``port.weights.from_flax``.

An int8 bundle (``save_model_bundle(..., quantize=True)``, ``"quantized":
true`` in its ``config.json``) stores each float tensor of ndim >= 2 and
>= ``QUANT_MIN_SIZE`` elements as symmetric int8 per output channel: the
int8 tensor under its own name and its float32 scales under ``<name>``
+ ``SCALE_SUFFIX``, shaped to broadcast over it.  The output channel is
axis 0 of a ``Conv2d`` (OIHW) or ``Linear`` (out, in) weight and axis 1 of
a ``ConvTranspose2d`` weight (in, out, kh, kw): the JAX package's flax
last axis, through ``port.weights``.  Loading multiplies in float32, then
casts to the compute dtype, as the JAX package's loader does.

A config's ``model`` may also be an ``http(s)://`` or ``file://`` URL:
``cached_model_path`` fetches it once into ``MODEL_DIR/downloads``.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import os
import shutil
import tempfile
import urllib.parse
import urllib.request
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
    "model_info_text",
    "save_model_bundle",
    "requantize_bundle",
    "load_model_bundle",
    "cached_model_path",
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
QUANT_MIN_SIZE = 4096
SCALE_SUFFIX = "@scale"
CACHE_ENV = "EMPANADA_TPU_TORCH_CACHE"


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


def model_info_text(model_name: str) -> str:
    """A registered model's description and its finetuning instructions:
    the patch size rule, the label divisor and each class's first label
    (the text of the napari plugin's "Get model info")."""
    config = load_config(model_name)
    thing_list = config.get("thing_list", [])
    pf = config.get("padding_factor", 128)
    finetune = config.get("FINETUNE", {})
    label_divisor = (finetune.get("dataset_params", {}).get("label_divisor")
                     if finetune.get("dataset_class") == "PanopticDataset" else None)
    lines = [
        "MODEL INFORMATION",
        "-----------------",
        f"Model name: {model_name}",
        f"Description:\n {str(config.get('description', '')).strip()}",
        "",
        "Finetuning instructions:",
        f"  The size of annotated patches should be divisible by {pf}",
        f"  Use a label divisor of {label_divisor}.",
        "  Classes to annotate:",
    ]
    for cl, cn in config.get("class_names", {}).items():
        kind = "instance" if cl in thing_list else "semantic"
        start_label = cl * label_divisor + 1 if label_divisor is not None else 1
        lines.append(f"    Class {cl} ({cn}) requires {kind} segmentation, "
                     f"start annotation at label {start_label}")
    return "\n".join(lines)


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


def _output_axes(model: nn.Module) -> dict:
    """``{state-dict key: output-channel axis}`` of the weights whose
    output channel is not axis 0 (the transposed convolutions')."""
    return {f"{name}.weight": 1 for name, m in model.named_modules()
            if isinstance(m, nn.ConvTranspose2d)}


def quantize_state_dict(state: dict, output_axes: dict) -> dict:
    """Symmetric int8 per output channel of every float tensor of ndim >= 2
    and >= ``QUANT_MIN_SIZE`` elements, in float32: ``scale = max(max|w|,
    1e-12) / 127`` and ``q = clip(rint(w / scale), -127, 127)``
    (``torch.round`` rounds half to even, as ``np.rint``).  Returns the
    state with ``q`` under the name and the scale, shaped to broadcast,
    under the name + ``SCALE_SUFFIX``; other tensors unchanged."""
    out = {}
    for name, t in state.items():
        if t.dim() < 2 or t.numel() < QUANT_MIN_SIZE or not t.is_floating_point():
            out[name] = t
            continue
        w = t.detach().to(torch.float32)
        axis = output_axes.get(name, 0)
        dims = tuple(d for d in range(w.dim()) if d != axis)
        scale = w.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / 127.0
        out[name] = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
        out[name + SCALE_SUFFIX] = scale
    return out


def dequantize_state_dict(state: dict) -> dict:
    """Inverse of ``quantize_state_dict``: ``q * scale`` in float32."""
    out = {}
    for name, t in state.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        scale = state.get(name + SCALE_SUFFIX)
        out[name] = t if scale is None else t.to(torch.float32) * scale
    return out


def save_model_bundle(path: str, arch: str, model_kwargs: dict, model: nn.Module,
                      quantize: bool = False) -> str:
    """Write ``model``'s weights as a bundle (the module docstring's
    format) at ``path`` (``BUNDLE_EXT`` appended when missing); with
    ``quantize`` the large weights go int8 (about 4x smaller).  Returns
    the path."""
    if not path.endswith(BUNDLE_EXT):
        path = path + BUNDLE_EXT
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if quantize:
        state = quantize_state_dict(state, _output_axes(model))
    buf = io.BytesIO()
    torch.save(state, buf)
    meta = {"arch": arch, "model_kwargs": model_kwargs, "format": BUNDLE_FORMAT,
            "quantized": bool(quantize)}
    # stored, not deflated: float weights barely compress, and deflating a
    # resnet50 bundle took seconds
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("config.json", json.dumps(meta))
        zf.writestr("state_dict.pt", buf.getvalue())
    return path


def _read_bundle(path: str):
    """(meta, state dict as stored) of a port bundle."""
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
    return meta, state


def requantize_bundle(src_path: str, dst_path: str) -> str:
    """An int8 copy of the bundle at ``src_path`` at ``dst_path`` (a
    bundle already int8 is copied as it is); returns the written path."""
    meta, _ = _read_bundle(src_path)
    if meta.get("quantized"):
        if os.path.abspath(src_path) != os.path.abspath(dst_path):
            shutil.copyfile(src_path, dst_path)
        return dst_path
    model = load_model_bundle(src_path, device="cpu")
    return save_model_bundle(dst_path, meta["arch"], meta["model_kwargs"], model,
                             quantize=True)


def load_model_bundle(path: str, device=None, dtype=torch.float32) -> nn.Module:
    """The model of a bundle written by ``save_model_bundle``, on ``device``
    (default "cuda"; raises without a GPU unless ``device="cpu"``); an int8
    bundle is dequantized in float32, then cast to ``dtype``."""
    dev = resolve_device(device)
    meta, state = _read_bundle(path)
    if meta.get("quantized"):
        state = dequantize_state_dict(state)
    model = create_model(meta["arch"], device="cpu", **meta["model_kwargs"])
    model.load_state_dict(state)
    return model.to(device=dev, dtype=dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cached_model_path(url: str, cache_dir: str | None = None, sha256: str | None = None,
                      progress: bool = False) -> str:
    """The local copy of the bundle at ``url`` (``http(s)://`` or
    ``file://``), fetched once into the download cache: ``cache_dir``, else
    ``$EMPANADA_TPU_TORCH_CACHE``, else ``MODEL_DIR/downloads``.  The
    transfer goes to a temp file in the cache and is renamed into place, so
    an interrupted one leaves nothing behind.  ``sha256`` is checked before
    the rename and again on every cache hit: a mismatched download raises
    and leaves no file; a cached copy that no longer matches is fetched
    again, never served."""
    cache_dir = os.path.expanduser(cache_dir or os.environ.get(
        CACHE_ENV, os.path.join(MODEL_DIR, "downloads")))
    base = os.path.basename(urllib.parse.urlparse(url).path) or "model.bin"
    key = hashlib.sha1(url.encode()).hexdigest()[:16]
    dest = os.path.join(cache_dir, f"{key}-{base}")
    if os.path.isfile(dest):
        if sha256 is None or _sha256(dest) == sha256.lower():
            return dest
        os.remove(dest)
    os.makedirs(cache_dir, exist_ok=True)
    if progress:
        print(f"downloading {url} -> {dest}")
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".part")
    try:
        hasher = hashlib.sha256()
        with os.fdopen(fd, "wb") as out, urllib.request.urlopen(url) as resp:
            for chunk in iter(lambda: resp.read(1 << 20), b""):
                hasher.update(chunk)
                out.write(chunk)
        if sha256 is not None and hasher.hexdigest() != sha256.lower():
            raise RuntimeError(f"download {url}: sha256 mismatch (got "
                               f"{hasher.hexdigest()}, expected {sha256})")
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return dest


def load_model_from_config(model_config: dict, device=None, dtype=torch.float32) -> nn.Module:
    """The model of the bundle that the config's ``model`` names: a local
    path, or an ``http(s)://`` / ``file://`` URL resolved through
    ``cached_model_path`` with the config's optional ``model_sha256``."""
    model_path = model_config["model"]
    if isinstance(model_path, str) and model_path.startswith(("http://", "https://",
                                                              "file://")):
        model_path = cached_model_path(model_path, sha256=model_config.get("model_sha256"))
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
