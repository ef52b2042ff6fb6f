"""The reference-checkpoint importer (``port/torch_port.py``) against the
JAX package's (``empanada_tpu/port/torch_port.py``).

For each registry architecture at small widths, a reference-named state
dict is made from a port model by the inverse of the port's name map.  The
JAX package's ``port_state_dict`` must map every name of it (it raises on
an unmapped one), and its flax variables carried over by the weight bridge
(``port/weights.py::from_flax``) must equal the port's own ``port_state_dict``
tensor for tensor.  The one exception is a ``ConvTranspose2d`` weight: the
bridge flips it in space for flax's ``ConvTranspose``, which the JAX port of
a torch kernel does not (ROADMAP C6), while a torch kernel loaded into the
port needs no flip.  ``infer_arch_and_kwargs`` must agree with JAX's; the
three checkpoint formats, the errors, and the reference's ``.empanada``
archives are checked too (no reference checkout or download: synthetic
state dicts, as ``tests/test_port_artifacts.py`` would use published ones).
"""

import argparse
import os
import zipfile

import pytest
import torch
import yaml

from _torch_port import one_torch_thread  # noqa: F401
from empanada_tpu.port.torch_port import infer_arch_and_kwargs as jax_infer
from empanada_tpu.port.torch_port import port_state_dict as jax_port_state_dict
from empanada_tpu_torch.api import export, utils
from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.port import torch_port as tp
from empanada_tpu_torch.port.weights import from_flax

ARCHS = {
    "pdl_resnet18": ("PanopticDeepLab", dict(
        encoder="resnet18", num_classes=1, decoder_channels=32, low_level_stages=[3, 2, 1],
        low_level_channels_project=[32, 16, 8], ins_decoder=True, ins_ratio=0.5)),
    "pdlpr_resnet18": ("PanopticDeepLabPR", dict(
        encoder="resnet18", num_classes=1, decoder_channels=32, low_level_stages=[1],
        low_level_channels_project=[16], ins_decoder=True, num_fc=3)),
    "pdlpr_resnet50_aspp": ("PanopticDeepLabPR", dict(
        encoder="resnet50", num_classes=2, decoder_channels=32, aspp_channels=48,
        low_level_stages=[2, 1], low_level_channels_project=[24, 12], ins_decoder=False,
        num_fc=2)),
    "pdlbc_resnet18": ("PanopticDeepLabBC", dict(
        encoder="resnet18", num_classes=1, decoder_channels=32, low_level_stages=[1],
        low_level_channels_project=[16], ins_decoder=False)),
    "bifpn_resnet18": ("PanopticBiFPN", dict(
        encoder="resnet18", num_classes=1, fpn_dim=32, fpn_layers=2, ins_decoder=True)),
    "bifpn_regnet": ("PanopticBiFPN", dict(
        encoder="regnety_200mf", num_classes=1, fpn_dim=32, fpn_layers=1, ins_decoder=False)),
    "bifpnpr_resnet18": ("PanopticBiFPNPR", dict(
        encoder="resnet18", num_classes=1, fpn_dim=32, fpn_layers=1, ins_decoder=False)),
    "bifpnpr_regnet_se": ("PanopticBiFPNPR", dict(
        encoder="regnety_6p4gf", num_classes=1, fpn_dim=32, fpn_layers=1, ins_decoder=True)),
}


def _seeded(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=g).abs() + 0.1)
    return model


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    arch, kw = ARCHS[request.param]
    model = _seeded(create_model(arch, device="cpu", **kw))
    return arch, kw, model, tp.reference_state_dict(model, arch, kw)


def test_port_matches_jax_and_the_bridge(case):
    arch, kw, model, ref = case
    variables = jax_port_state_dict(ref, arch, kw)  # raises on an unmapped name
    bridged = from_flax(variables, model)
    ported = tp.port_state_dict(ref, arch, kw)
    assert sorted(ported) == sorted(model.state_dict()) == sorted(bridged)
    n_tconv = 0
    for k, t in ported.items():
        assert torch.equal(t, model.state_dict()[k]), k
        if k.endswith("tconv.weight"):  # C6: flax's ConvTranspose reads taps flipped
            n_tconv += 1
            assert torch.equal(bridged[k], t.flip(2, 3)) and not torch.equal(bridged[k], t), k
        else:
            assert torch.equal(bridged[k], t), k
    assert n_tconv == (0 if arch.startswith("PanopticDeepLab") else
                       5 * (1 + bool(kw.get("ins_decoder"))))


def test_infer_arch_and_kwargs_agree_with_jax(case):
    arch, kw, model, ref = case
    got = tp.infer_arch_and_kwargs(ref)
    assert got == jax_infer(ref)
    assert got[0] == arch
    assert {k: got[1][k] for k in kw if k in got[1]} == {
        k: (list(v) if isinstance(v, tuple) else v) for k, v in kw.items() if k in got[1]}
    rebuilt = tp.load_reference_model(ref, *got)
    for k, v in rebuilt.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_reference_extras_are_dropped(case):
    """DataParallel's prefix, batch-norm counters and quantization stubs."""
    arch, kw, model, ref = case
    noisy = {f"module.{k}": v for k, v in ref.items()}
    noisy["quant.scale"] = torch.ones(1)
    noisy["semantic_head.activation_post_process.scale"] = torch.ones(1)
    assert any(k.endswith("num_batches_tracked") for k in noisy)
    ported = tp.port_state_dict(noisy, arch, kw)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in ported.items())


def test_unmapped_missing_and_diverged_keys_raise(case):
    arch, kw, model, ref = case
    with pytest.raises(ValueError, match="unmapped torch parameters"):
        tp.port_state_dict({**ref, "extra_head.weight": torch.ones(1)}, arch, kw)
    with pytest.raises(ValueError, match="unmapped"):  # JAX raises on it alike
        jax_port_state_dict({**ref, "extra_head.weight": torch.ones(1)}, arch, kw)
    short = dict(ref)
    del short["semantic_head.head.1.weight"]
    with pytest.raises(KeyError, match="semantic_head.head.1.weight"):
        tp.port_state_dict(short, arch, kw)
    shared = [k for k in ref if ".after_combines.1." in k]
    if shared:  # the reference shares the module: its copies must agree
        with pytest.raises(ValueError, match="differs from"):
            tp.port_state_dict({**ref, shared[0]: ref[shared[0]] + 1}, arch, kw)


class _Holder(torch.nn.Module):
    """A module tree whose state dict holds ``sd``'s tensors under its keys."""

    def __init__(self, sd):
        super().__init__()
        for key, t in sd.items():
            node = self
            *mods, leaf = key.split(".")
            for m in mods:
                if not hasattr(node, m):
                    node.add_module(m, torch.nn.Module())
                node = getattr(node, m)
            node.register_buffer(leaf, t.clone())

    def forward(self, x):
        return x


SMALL = ARCHS["pdlpr_resnet18"]


@pytest.fixture(scope="module")
def small_ref():
    arch, kw = SMALL
    model = _seeded(create_model(arch, device="cpu", **kw), seed=3)
    return model, tp.reference_state_dict(model, arch, kw)


@pytest.mark.parametrize("fmt", ["raw", "training", "torchscript", "training_arch"])
def test_checkpoint_formats(fmt, small_ref, tmp_path):
    model, ref = small_ref
    path = str(tmp_path / "ckpt.pth")
    if fmt == "raw":
        torch.save(ref, path)
    elif fmt.startswith("training"):
        blob = {"state_dict": ref, "norms": {"mean": 0.5, "std": 0.2}}
        if fmt == "training_arch":
            blob["arch"] = SMALL[0]
        torch.save(blob, path)
    else:
        torch.jit.save(torch.jit.script(_Holder(ref)), path)
    sd, arch = tp.load_torch_checkpoint(path)
    assert arch == (SMALL[0] if fmt == "training_arch" else None)
    assert sorted(sd) == sorted(ref) and all(torch.equal(sd[k], ref[k]) for k in ref)


def test_unreadable_checkpoints_raise(small_ref, tmp_path):
    _, ref = small_ref
    path = tmp_path / "ckpt.pth"
    torch.save(ref, path)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 3])
    with pytest.raises(tp.CheckpointReadError, match="not a readable torch checkpoint"):
        tp.load_torch_checkpoint(str(path))
    path.write_bytes(b"not a checkpoint at all")
    with pytest.raises(tp.CheckpointReadError, match="allow_pickle"):
        tp.load_torch_checkpoint(str(path))


def test_non_tensor_entries_need_allow_pickle(small_ref, tmp_path):
    _, ref = small_ref
    path = str(tmp_path / "legacy.pth")
    torch.save({"state_dict": ref, "args": argparse.Namespace(lr=0.1)}, path)
    with pytest.raises(tp.CheckpointReadError, match="allow_pickle"):
        tp.load_torch_checkpoint(path)
    sd, _ = tp.load_torch_checkpoint(path, allow_pickle=True)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


@pytest.mark.parametrize("with_arch", [False, True])
def test_import_reference_empanada_archive(with_arch, small_ref, tmp_path, monkeypatch):
    """A reference ``.empanada`` zip (a yaml without ``arch``, as every
    reference yaml, and a TorchScript ``.pth`` under a subdirectory) is
    ported into a port bundle and registered."""
    monkeypatch.setattr(utils, "MODEL_DIR", str(tmp_path / "home"))
    model, ref = small_ref
    ts = tmp_path / "MitoTiny.pth"
    torch.jit.save(torch.jit.script(_Holder(ref)), str(ts))
    cfg = {"class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
           "model": "https://example.invalid/MitoTiny.pth", "padding_factor": 16,
           "norms": {"mean": 0.5, "std": 0.2}, "model_quantized": None}
    if with_arch:
        cfg.update(arch=SMALL[0], model_kwargs=SMALL[1])
    archive = tmp_path / "MitoTiny.empanada"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("MitoTiny.yaml", yaml.dump(cfg))
        zf.write(ts, arcname="../../weights/MitoTiny.pth")  # flattened, never outside
    assert export.import_model(str(archive)) == "MitoTiny"
    registered = utils.load_config("MitoTiny")
    assert registered["arch"] == SMALL[0] and "model_quantized" not in registered
    assert os.path.dirname(registered["model"]) == str(tmp_path / "home" / "models")
    assert sorted(os.listdir(tmp_path / "home" / "models")) == ["MitoTiny.eptorch"]
    loaded = utils.load_model_from_config(registered, device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_jax_archives_and_quantize_are_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(utils, "MODEL_DIR", str(tmp_path / "home"))
    archive = tmp_path / "tiny.empanada_tpu"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("tiny.yaml", yaml.dump({"model": "tiny.eptpu"}))
        zf.writestr("tiny.eptpu", b"flax msgpack")
    with pytest.raises(ValueError, match="JAX package archive"):
        export.import_model(str(archive))
    # int8 export re-saves the bundle, which the port reads only in its own
    # format: a registered JAX bundle (flax msgpack) is refused
    jax_bundle = tmp_path / "tiny.eptpu"
    with zipfile.ZipFile(jax_bundle, "w") as zf:
        zf.writestr("config.json", "{}")
        zf.writestr("params.msgpack", b"flax msgpack")
    utils.add_new_model("tiny_jax", {"model": str(jax_bundle)})
    with pytest.raises(ValueError, match="not a bundle of the port"):
        export.export_model("tiny_jax", str(tmp_path / "x"), quantize=True)
