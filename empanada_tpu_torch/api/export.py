"""Model archives (counterpart of ``empanada_tpu/api/export.py``): a
registered model's yaml and bundle in one zip, to move it between
machines, and the import of such zips into the local registry.

The port's archives end in ``ARCHIVE_EXT`` and hold a port bundle
(``api/utils.py``).  ``import_model`` also takes the reference's
``.empanada`` zips (a yaml and a ``.pth``: TorchScript or a state dict),
whose weights go through ``port/torch_port.py`` into a port bundle.  A
JAX ``.empanada_tpu`` archive holds flax msgpack, which the port does not
read (its variables reach the port through ``port/weights.py``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import zipfile

import yaml

from empanada_tpu_torch.api import utils
from empanada_tpu_torch.api.config import read_yaml

__all__ = ["ARCHIVE_EXT", "archive_model", "export_model", "import_model"]

ARCHIVE_EXT = ".empanada_torch"


def export_model(model_name: str, export_path: str, quantize: bool = False) -> str:
    """Zip a registered model's yaml (as ``<model_name>.yaml``) and its
    bundle into ``export_path`` (``ARCHIVE_EXT`` appended when missing);
    returns the archive's path.  ``quantize`` archives an int8 copy of the
    bundle (``utils.requantize_bundle``) under the bundle's name."""
    configs = utils.get_configs()
    if model_name not in configs:
        raise KeyError(f"{model_name} is not a registered model")
    config_path = configs[model_name]
    model_file = os.path.expanduser(str(read_yaml(config_path)["model"]))
    if not os.path.isfile(model_file):
        raise FileNotFoundError(f"model file {model_file} not found")
    out = export_path if export_path.endswith(ARCHIVE_EXT) else export_path + ARCHIVE_EXT
    with tempfile.TemporaryDirectory() as td:
        if quantize:
            model_file = utils.requantize_bundle(
                model_file, os.path.join(td, os.path.basename(model_file)))
        with zipfile.ZipFile(out, "w", compression=zipfile.ZIP_STORED) as zf:  # a zip already
            zf.write(config_path, arcname=f"{model_name}.yaml")
            zf.write(model_file, arcname=os.path.basename(model_file))
    return out


def import_model(archive_path: str, model_name: str | None = None) -> str:
    """Register the model of an archive (the port's, or the reference's
    ``.empanada``) under ``model_name`` (default: the yaml's name); its
    weights go to ``MODEL_DIR/models``.  Returns the name."""
    store_dir = os.path.join(utils.MODEL_DIR, "models")
    os.makedirs(store_dir, exist_ok=True)
    with zipfile.ZipFile(archive_path, "r") as zf:
        yaml_names = [n for n in zf.namelist() if n.endswith(".yaml")]
        if len(yaml_names) != 1:
            raise ValueError(f"{archive_path}: an archive holds one yaml, not "
                             f"{len(yaml_names)}")
        name = model_name or os.path.splitext(os.path.basename(yaml_names[0]))[0]
        config = yaml.safe_load(zf.read(yaml_names[0]))
        weight_names = [n for n in zf.namelist() if not n.endswith(".yaml")]
        if any(n.endswith(".eptpu") for n in weight_names):
            raise ValueError(
                f"{archive_path} is a JAX package archive (a flax msgpack bundle), which "
                "the port does not read; carry its variables over with port.weights.from_flax")
        if not weight_names:
            raise ValueError(f"{archive_path}: the archive holds no model weights")
        model_out, torch_weights = None, []
        for wn in weight_names:
            # archives come from other machines: a member path may not leave
            # the store (zip-slip), so every member lands under its basename
            flat = os.path.basename(wn.replace("\\", "/"))
            if not flat:
                continue
            target = os.path.join(store_dir, flat)
            with zf.open(wn) as src, open(target, "wb") as dst:
                shutil.copyfileobj(src, dst)
            if flat.endswith((".pth", ".pt")):
                torch_weights.append(target)
            if flat == os.path.basename(str(config.get("model", ""))) or model_out is None:
                model_out = target
    if torch_weights:
        model_out = _port_torch_import(config, torch_weights, store_dir, name)
    utils.add_new_model(name, config, model_file=model_out)
    return name


def _port_torch_import(config: dict, torch_weights: list, store_dir: str, name: str) -> str:
    """A reference archive's torch weights as a port bundle; the config
    gains the architecture (from its yaml, the checkpoint or the weights)."""
    from empanada_tpu_torch.port.torch_port import (
        infer_arch_and_kwargs,
        load_reference_model,
        load_torch_checkpoint,
    )

    # the yaml's `model` before a `model_quantized` sibling: int8 archives
    # hold packed tensors that no name map reads
    preferred = os.path.basename(str(config.get("model", "")))
    torch_weights = sorted(torch_weights, key=lambda p: os.path.basename(p) != preferred)
    state_dict, ckpt_arch = load_torch_checkpoint(torch_weights[0])
    arch = config.get("arch") or ckpt_arch
    kwargs = config.get("model_kwargs")
    if arch is None or kwargs is None:
        inf_arch, inf_kwargs = infer_arch_and_kwargs(state_dict)
        arch = arch or inf_arch
        kwargs = kwargs if kwargs is not None else inf_kwargs
    model = load_reference_model(state_dict, arch, kwargs)
    bundle = utils.save_model_bundle(os.path.join(store_dir, name), arch, kwargs, model)
    config["arch"] = arch
    config["model_kwargs"] = kwargs
    config.pop("model_quantized", None)
    for p in torch_weights:
        os.remove(p)
    return bundle


def archive_model(model_name: str, archive_dir: str) -> str:
    """``export_model`` into ``archive_dir`` under the model's own name."""
    os.makedirs(archive_dir, exist_ok=True)
    return export_model(model_name, os.path.join(archive_dir, model_name))
