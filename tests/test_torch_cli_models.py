"""The registry and training commands of the port's command line (``models``,
``port``, ``train``, ``finetune``) against the JAX package's, on the CPU with
the tiny model and temporary registries of ``test_torch_cli.py``: the same
printed lines apart from paths, file extensions and the numbers of the
training logs, and the same weights.  A reference-named state dict (the
inverse of the port's name map, which JAX's ``port_state_dict`` maps whole)
goes through ``port`` as a raw state dict, a training checkpoint and a
TorchScript archive.  Training writes each package's own checkpoint
format; a finetuned bundle is registered by both."""

import os
import re
import zipfile

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import empanada_tpu.api.utils as jax_utils
from _torch_port import SMALL_PR, one_torch_thread  # noqa: F401
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.cli import main as jax_main
from empanada_tpu.port.torch_port import port_state_dict as jax_port_state_dict
from empanada_tpu_torch import api
from empanada_tpu_torch.api import utils as port_utils
from empanada_tpu_torch.cli import main as port_main
from empanada_tpu_torch.port.torch_port import reference_state_dict
from empanada_tpu_torch.port.weights import from_flax
from test_torch_cli import ARCH, SIDES, registries, root, run_both  # noqa: F401
from test_torch_refport import _Holder


def test_models(root, capsys):
    out = run_both(root, capsys, ["models", "list"], device=False)
    names = {s: [line.split("\t")[0] for line in out[s]] for s in SIDES}
    assert names["port"] == names["jax"] and "MitoNet_v1" in names["port"]
    out = run_both(root, capsys, ["models", "info", "--name", "NucleoNet_base_v2"],
                   device=False)
    desc = [i for i, line in enumerate(out["jax"]) if line.startswith("Description")][0]
    assert [line for i, line in enumerate(out["port"]) if i != desc + 1] == \
        [line for i, line in enumerate(out["jax"]) if i != desc + 1]
    # register the tiny model, then export, import and archive it
    for side, add in (("jax", jax_utils.add_new_model), ("port", port_utils.add_new_model)):
        cfg = yaml.safe_load((root / side / "tiny_model.yaml").read_text())
        add("tiny", cfg, model_file=cfg["model"])
    for argv in (["export", "--name", "tiny", "--path", "{d}/tiny_export"],
                 ["import", "--path", "{d}/tiny_export.EXT", "--name", "tiny2"],
                 ["archive", "--name", "tiny2", "--path", "{d}/archive"],
                 ["list"]):
        for side, ext in (("jax", ".empanada_tpu"), ("port", ".empanada_torch")):
            argv_side = [a.replace(".EXT", ext) for a in argv]
            (jax_main if side == "jax" else port_main)(
                ["models"] + [a.replace("{d}", str(root / side)) for a in argv_side])
            out[side] = capsys.readouterr().out
        if argv[0] == "list":
            assert [line.split("\t")[0] for line in out["port"].splitlines()] == \
                [line.split("\t")[0] for line in out["jax"].splitlines()]
            assert "tiny2" in out["port"]
        else:
            norm = {s: out[s].replace(str(root / s), "D").replace(".empanada_torch", "")
                    .replace(".empanada_tpu", "") for s in SIDES}
            assert norm["port"] == norm["jax"]
    with zipfile.ZipFile(root / "port" / "archive" / "tiny2.empanada_torch") as zf:
        assert sorted(n.rsplit(".", 1)[-1] for n in zf.namelist()) == ["eptorch", "yaml"]
    imported = api.load_model_from_config(api.load_config("tiny2"), device="cpu")
    original = api.load_model_bundle(str(root / "port_bundle.eptorch"), device="cpu")
    for k, v in original.state_dict().items():
        assert torch.equal(imported.state_dict()[k], v), k


@pytest.mark.parametrize("fmt", ["raw", "training", "torchscript"])
def test_port(fmt, root, capsys):
    """A reference-named state dict of the tiny model, in each format, ported
    by both command lines: the same printed lines, and the port's bundle
    equal to the JAX bundle carried over by the weight bridge."""
    tiny = api.load_model_bundle(str(root / "port_bundle.eptorch"), device="cpu")
    sd = reference_state_dict(tiny, ARCH, SMALL_PR)
    jax_port_state_dict(sd, ARCH, SMALL_PR)  # JAX maps every name of it
    for side in SIDES:
        path = str(root / side / f"ref_{fmt}.pth")
        if fmt == "raw":
            torch.save(sd, path)
        elif fmt == "training":
            torch.save({"state_dict": sd, "norms": {"mean": 0.5, "std": 0.2}}, path)
        else:
            torch.jit.save(torch.jit.script(_Holder(sd)), path)
    # raw and training checkpoints need the architecture (here from a
    # config that names it); TorchScript's is recovered from the weights
    extra = [] if fmt == "torchscript" else ["--model", "{d}/tiny_arch.yaml"]
    out = run_both(root, capsys, ["port", f"{{d}}/ref_{fmt}.pth", "-o", f"{{d}}/ported_{fmt}"]
                   + extra, device=False)
    assert out["port"] == out["jax"]
    assert out["port"][-1].startswith(f"ported D/ref_{fmt}.pth")
    if fmt == "torchscript":
        assert out["port"][0].startswith(f"inferred arch={ARCH}")
    _, jvars = jax_api.load_model_bundle(str(root / "jax" / f"ported_{fmt}.eptpu"))
    got = api.load_model_bundle(str(root / "port" / f"ported_{fmt}.eptorch"), device="cpu")
    want = from_flax(jax.tree_util.tree_map(np.asarray, dict(jvars)), got)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, tiny.state_dict()[k]), k


def test_port_unreadable_checkpoint(root):
    for side, main in (("jax", jax_main), ("port", port_main)):
        path = root / side / "bad.pth"
        path.write_bytes(b"not a checkpoint")
        with pytest.raises(SystemExit, match="--arch or --model"):
            main(["port", str(path), "-o", str(root / side / "bad_out")])


def _train_config(root, side, name, model_config=None):
    cfg = {
        "model_name": name,
        "seed": 0,
        "DATASET": {"class_names": {1: "blob"}, "labels": [1], "thing_list": [1],
                    "norms": {"mean": 0.6, "std": 0.2}},
        "TRAIN": {
            "train_dir": str(root / "train"), "model_dir": str(root / side / f"{name}_out"),
            "save_freq": 1, "amp": False, "epochs": 2, "batch_size": 2, "print_freq": 1,
            "criterion": "PanopticLoss", "criterion_params": {"top_k_percent": 0.2},
            "schedule_params": {"max_lr": 3e-3, "pct_start": 0.3},
            "optimizer_params": {"weight_decay": 0.01},
            "dataset_class": "SingleClassInstanceDataset",
            "dataset_params": {"weight_gamma": 0.3},
            "augmentations": [{"aug": "RandomCrop", "height": 64, "width": 64}],
            "metrics": [],
        },
    }
    if model_config is None:
        cfg["MODEL"] = {"arch": "PanopticDeepLab", "encoder": "resnet18",
                        "decoder_channels": 32, "low_level_stages": [1],
                        "low_level_channels_project": [16], "ins_decoder": False}
    else:
        cfg["model_config"] = model_config
        cfg["TRAIN"]["epochs"] = 1
    path = root / side / f"{name}.yaml"
    path.write_text(yaml.dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def train_dir(root):
    d = root / "train" / "src"
    (d / "images").mkdir(parents=True)
    (d / "masks").mkdir(parents=True)
    for i in range(4):
        img = make_blob_image((64, 64), n_blobs=3, seed=i)
        Image.fromarray(img).save(d / "images" / f"{i:03d}.png")
        Image.fromarray((img < 100).astype(np.uint16)).save(d / "masks" / f"{i:03d}.png")
    return d


def _log(lines):
    """Log lines with their numbers masked, and the losses."""
    masked = [re.sub(r"\d+\.?\d*", "#", line) for line in lines]
    losses = [float(m) for line in lines for m in re.findall(r"loss ([\d.]+)", line)]
    return masked, losses


def test_train(root, train_dir, capsys):
    """``train``: the same log (two epochs of two steps, a loss a step) and
    each package's checkpoint, which the port's ``--resume`` continues."""
    for side in SIDES:
        _train_config(root, side, "cli_tiny")
    out = run_both(root, capsys, ["train", "{d}/cli_tiny.yaml"])
    (jax_log, jax_loss), (port_log, port_loss) = _log(out["jax"]), _log(out["port"])
    assert port_log == jax_log and len(port_loss) == 4
    assert np.isfinite(port_loss).all()
    assert os.path.isfile(root / "jax" / "cli_tiny_out" / "cli_tiny_checkpoint.msgpack")
    assert os.path.isfile(root / "port" / "cli_tiny_out" / "cli_tiny_checkpoint.pt")
    port_main(["train", str(root / "port" / "cli_tiny.yaml"), "--resume", "--device", "cpu"])
    resumed = capsys.readouterr().out
    assert "resumed" in resumed and "loss" not in resumed  # both epochs were done


def test_finetune(root, train_dir, capsys):
    """``finetune`` of the tiny model (the same weights in both registries'
    bundles): the same log and the finetuned bundle registered.  The losses
    are not compared: the packages draw the random PointRend training
    points and augmentations from their own generators (the loop's
    numbers are held to JAX's in ``test_torch_train_loop.py``)."""
    for side in SIDES:
        _train_config(root, side, "cli_ft_tiny", str(root / side / "tiny_model.yaml"))
    out = run_both(root, capsys, ["finetune", "{d}/cli_ft_tiny.yaml"])
    (jax_log, jax_loss), (port_log, port_loss) = _log(out["jax"]), _log(out["port"])
    assert port_log == jax_log and len(port_loss) == 2
    assert np.isfinite(port_loss).all()
    assert out["port"][-1] == "finetuned bundle: D/cli_ft_tiny_out/cli_ft_tiny.BUNDLE"
    assert "cli_ft_tiny" in api.get_configs() and "cli_ft_tiny" in jax_api.get_configs()
