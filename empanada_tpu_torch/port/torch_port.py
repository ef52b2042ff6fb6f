"""Reference empanada checkpoints loaded straight into the port's modules
(counterpart of ``empanada_tpu/port/torch_port.py``).

The reference's PyTorch models (``empanada/models/*``, the names its
TorchScript archives and ``.pth`` files carry) and the port are both torch,
so a checkpoint needs only a name map: the port names its submodules after
the JAX package's flax modules, and ``name_map`` walks the reference names
as the JAX package's ``_TreeBuilder`` does, writing the port's key for
each.  Tensors keep their layout, except the PointRend point head's
``Conv1d`` weights ``(out, in, 1)``, which become ``nn.Linear``'s ``(out,
in)``.  A ``ConvTranspose2d`` weight is taken as it is: the reference and
the port both run torch's ``conv_transpose2d`` (only the flax bridge,
``port/weights.py``, flips it in space).

- ``load_torch_checkpoint(path)``: a TorchScript archive, a ``{state_dict,
  ...}`` training checkpoint or a raw state dict -> (state dict, arch or
  None); ``torch.load`` with ``weights_only=True`` unless ``allow_pickle``;
  an unreadable file raises ``CheckpointReadError``;
- ``infer_arch_and_kwargs(state_dict)``: the architecture and its
  constructor kwargs from the weights alone;
- ``port_state_dict(state_dict, arch, model_kwargs)``: the port's state
  dict; a reference tensor that maps to nothing, or a missing one, raises;
- ``load_reference_model(state_dict, arch, model_kwargs)``: the port's
  model (on the CPU) with those weights;
- ``reference_state_dict(model, arch, model_kwargs)``: the inverse, the
  reference-named state dict of a port model.
"""

from __future__ import annotations

import math
import re

import torch

from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.models.regnet import RegNetParams, regnet_configs
from empanada_tpu_torch.models.resnet import resnet_configs

__all__ = ["CheckpointReadError", "infer_arch_and_kwargs", "load_reference_model",
           "load_torch_checkpoint", "name_map", "port_state_dict", "reference_state_dict"]

RESNET_WIDTHS = {name: tuple(p * (1 if cfg["block"] == "basic" else 4)
                             for p in (64, 128, 256, 512))
                 for name, cfg in resnet_configs.items()}


class _NameMap:
    """Reference key -> (port key, conversion) of one architecture.

    ``present(ref_key, port_key)`` answers for the optional entries (a
    downsample, a resample conv, a bias): from the reference keys when
    porting, from the port's keys when inverting.  ``shared`` maps the
    extra copies of a module the reference shares (BiFPN's after-combine)
    to the key of its first copy."""

    def __init__(self, present):
        self.present = present
        self.pairs: dict = {}
        self.shared: dict = {}

    def put(self, ref, port, kind="same"):
        self.pairs[ref] = (port, kind)

    def conv(self, ref, *path, bias=None):
        port = ".".join(path)
        self.put(ref, port + ".weight")
        if bias is not None and self.present(bias, port + ".bias"):
            self.put(bias, port + ".bias")

    def dense1d(self, ref_prefix, *path):
        port = ".".join(path)
        self.put(ref_prefix + ".weight", port + ".weight", "conv1d")
        self.put(ref_prefix + ".bias", port + ".bias")

    def bn(self, ref_prefix, *path, leaf="bn"):
        port = ".".join(path + (leaf,))
        for r, p in (("weight", "weight"), ("bias", "bias"), ("running_mean", "running_mean"),
                     ("running_var", "running_var")):
            self.put(f"{ref_prefix}.{r}", f"{port}.{p}")

    def conv_bn(self, ref_conv, ref_bn, *path):
        self.conv(ref_conv, *path, "conv")
        self.bn(ref_bn, *path)

    def sep_conv_bn(self, ref_prefix, *path):
        self.conv(ref_prefix + ".0.sepconv.0.weight", *path, "sepconv", "depthwise")
        self.conv(ref_prefix + ".0.sepconv.1.weight", *path, "sepconv", "pointwise")
        self.bn(ref_prefix + ".1", *path)

    def head(self, ref_prefix, *path):
        self.sep_conv_bn(ref_prefix + ".head.0", *path, "conv")
        self.conv(ref_prefix + ".head.1.weight", *path, "predict",
                  bias=ref_prefix + ".head.1.bias")

    def has(self, ref, *port_path) -> bool:
        return self.present(ref, ".".join(port_path))


def _resnet(m: _NameMap, layers, block):
    m.conv("encoder.conv1.weight", "encoder", "stem_conv")
    m.bn("encoder.bn1", "encoder", leaf="stem_bn")
    n_convs = 3 if block == "bottleneck" else 2
    for k, depth in enumerate(layers, start=1):
        for j in range(depth):
            tb, fb = f"encoder.layer{k}.{j}", ("encoder", f"layer{k}_block{j + 1}")
            for c in range(1, n_convs + 1):
                m.conv_bn(f"{tb}.conv{c}.weight", f"{tb}.bn{c}", *fb, f"cba{c}")
            if m.has(f"{tb}.downsample.0.weight", *fb, "downsample", "conv", "weight"):
                m.conv_bn(f"{tb}.downsample.0.weight", f"{tb}.downsample.1", *fb, "downsample")


def _regnet(m: _NameMap, depths, use_se):
    m.conv_bn("encoder.stem.cbr.0.weight", "encoder.stem.cbr.1", "encoder", "stem")
    for k, depth in enumerate(depths, start=1):
        for j in range(1, depth + 1):
            tb, fb = f"encoder.stage{k}.block{j}", ("encoder", f"stage{k}_block{j}")
            for name in ("a", "b", "c"):
                m.conv_bn(f"{tb}.bottleneck.{name}.0.weight", f"{tb}.bottleneck.{name}.1",
                          *fb, name)
            if use_se:
                m.conv(f"{tb}.bottleneck.se.se.0.weight", *fb, "se", "squeeze",
                       bias=f"{tb}.bottleneck.se.se.0.bias")
                m.conv(f"{tb}.bottleneck.se.se.2.weight", *fb, "se", "excite",
                       bias=f"{tb}.bottleneck.se.se.2.bias")
            if m.has(f"{tb}.downsample.conv.0.weight", *fb, "downsample", "conv", "conv",
                     "weight"):
                m.conv_bn(f"{tb}.downsample.conv.0.weight", f"{tb}.downsample.conv.1",
                          *fb, "downsample", "conv")


def _pdl_decoder(m: _NameMap, tp, n_stages, n_rates):
    m.conv_bn(f"{tp}.aspp.convs.0.0.weight", f"{tp}.aspp.convs.0.1", tp, "aspp", "conv1x1")
    for i in range(1, n_rates + 1):
        m.conv_bn(f"{tp}.aspp.convs.{i}.0.weight", f"{tp}.aspp.convs.{i}.1",
                  tp, "aspp", f"aspp_conv{i}")
    m.conv(f"{tp}.aspp.convs.{n_rates + 1}.aspp_pooling.1.weight", tp, "aspp", "pool_conv")
    m.conv_bn(f"{tp}.aspp.project.0.weight", f"{tp}.aspp.project.1", tp, "aspp", "project")
    for i in range(n_stages):
        m.conv_bn(f"{tp}.project.{i}.0.weight", f"{tp}.project.{i}.1", tp, f"project{i}")
        m.sep_conv_bn(f"{tp}.fuse.{i}", tp, f"fuse{i}")


def _resample(m: _NameMap, ref_prefix, *path):
    if m.has(f"{ref_prefix}.conv.0.weight", *path, "conv", "conv", "weight"):
        m.conv_bn(f"{ref_prefix}.conv.0.weight", f"{ref_prefix}.conv.1", *path, "conv")


_SEP_CONV_BN = (".0.sepconv.0.weight", ".0.sepconv.1.weight",
                ".1.weight", ".1.bias", ".1.running_mean", ".1.running_var")


def _bifpn(m: _NameMap, tp, num_layers, n_scales=5):
    """The reference appends one after-combine module to its list once a
    level, so ``after_combines.1..`` are copies of ``after_combines.0``,
    the port's one ``after_combine`` a pass."""
    _resample(m, f"{tp}.p6_resample", tp, "p6_resample")
    for i in range(num_layers):
        for ref_dir, port_dir in (("top_down_fpn", "top_down"), ("bottom_up_fpn", "bottom_up")):
            tl, fl = f"{tp}.bifpns.{i}.{ref_dir}", (tp, f"bifpn{i + 1}", port_dir)
            m.put(f"{tl}.weights", ".".join(fl + ("fusion_weights",)))
            m.sep_conv_bn(f"{tl}.after_combines.0", *fl, "after_combine")
            for j in range(1, n_scales - 1):
                for suffix in _SEP_CONV_BN:
                    m.shared[f"{tl}.after_combines.{j}{suffix}"] = \
                        f"{tl}.after_combines.0{suffix}"
            for j in range(n_scales - 1):
                _resample(m, f"{tl}.resamplings.{j}", *fl, f"resample{j}")


def _bifpn_decoder(m: _NameMap, tp, n_scales=5):
    for i in range(n_scales):
        m.conv(f"{tp}.upsamplings.{i}.0.weight", tp, f"up{i}", "tconv")
        m.bn(f"{tp}.upsamplings.{i}.1", tp, f"up{i}")
    m.sep_conv_bn(f"{tp}.fusion", tp, "fusion")


def _point_rend(m: _NameMap, tp, num_fc):
    for k in range(num_fc):
        m.dense1d(f"{tp}.point_head.fc_layers.{k}.0", tp, "point_head", f"fc{k + 1}")
    m.dense1d(f"{tp}.point_head.predictor", tp, "point_head", "predictor")


def name_map(arch: str, model_kwargs: dict, present) -> _NameMap:
    """The reference-to-port name map of ``arch`` built with ``model_kwargs``
    (the architectures JAX's ``port_state_dict`` takes: PanopticDeepLab,
    ...PR and ...BC on a resnet, PanopticBiFPN and ...PR on a resnet or a
    regnet)."""
    m = _NameMap(present)
    encoder = model_kwargs.get("encoder", "resnet50")
    if arch.startswith("PanopticBiFPN"):
        if encoder in resnet_configs:
            _resnet(m, resnet_configs[encoder]["layers"], resnet_configs[encoder]["block"])
        else:
            p = RegNetParams(**regnet_configs[encoder])
            _regnet(m, p.depths, p.use_se)
        _resample(m, "p2_resample", "p2_resample")
        fpn_layers = model_kwargs.get("fpn_layers", 3)
        _bifpn(m, "semantic_fpn", fpn_layers)
        _bifpn_decoder(m, "semantic_decoder")
        if model_kwargs.get("ins_decoder"):
            _bifpn(m, "instance_fpn", fpn_layers)
            _bifpn_decoder(m, "instance_decoder")
        for head in ("semantic_head", "ins_center", "ins_xy"):
            m.head(head, head)
        if arch == "PanopticBiFPNPR":
            _point_rend(m, "semantic_pr", model_kwargs.get("num_fc", 3))
        return m
    if encoder not in resnet_configs:
        raise ValueError(f"{arch} takes a resnet encoder, not {encoder!r}")
    _resnet(m, resnet_configs[encoder]["layers"], resnet_configs[encoder]["block"])
    n_stages = len(model_kwargs.get("low_level_stages", (3, 2, 1)))
    n_rates = len(model_kwargs.get("atrous_rates", (2, 4, 6)))
    _pdl_decoder(m, "semantic_decoder", n_stages, n_rates)
    if model_kwargs.get("ins_decoder"):
        _pdl_decoder(m, "instance_decoder", n_stages, n_rates)
    heads = ("semantic_head", "boundary_head") if arch == "PanopticDeepLabBC" else (
        "semantic_head", "ins_center", "ins_xy")
    for head in heads:
        m.head(head, head)
    num_fc = model_kwargs.get("num_fc", 3)
    if arch in ("PanopticDeepLabPR", "PanopticDeepLabBC"):
        _point_rend(m, "semantic_pr", num_fc)
    if arch == "PanopticDeepLabBC":
        _point_rend(m, "boundary_pr", num_fc)
    return m


def _normalize_state_dict(state_dict: dict) -> dict:
    """Without DataParallel's ``module.`` prefix, batch-norm counters and
    quantization observers."""
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")
            and ".activation_post_process" not in k
            and not k.startswith(("quant.", "dequant."))}


def port_state_dict(state_dict: dict, arch: str, model_kwargs: dict) -> dict:
    """The port's state dict (``create_model(arch, **model_kwargs)``'s keys)
    from a reference state dict.  Raises on a reference tensor that maps
    to nothing, a missing one, and copies of a shared module that differ."""
    sd = _normalize_state_dict(state_dict)
    m = name_map(arch, model_kwargs, lambda ref, port: ref in sd)
    missing = sorted(k for k in m.pairs if k not in sd)
    if missing:
        raise KeyError(f"reference tensors missing for {arch}: {missing[:10]} "
                       f"(+{max(0, len(missing) - 10)})")
    unused = sorted(set(sd) - set(m.pairs) - set(m.shared))
    if unused:
        raise ValueError(f"unmapped torch parameters: {unused[:10]} "
                         f"(+{max(0, len(unused) - 10)})")
    for copy, first in m.shared.items():
        if copy in sd and not torch.equal(torch.as_tensor(sd[copy]), torch.as_tensor(sd[first])):
            raise ValueError(f"{copy} differs from {first}: the module is shared in the "
                             "reference, one tensor in the port")
    out = {}
    for ref, (port, kind) in m.pairs.items():
        t = torch.as_tensor(sd[ref]).detach().cpu()
        out[port] = (t[..., 0] if kind == "conv1d" else t).contiguous().clone()
    return out


def load_reference_model(state_dict: dict, arch: str, model_kwargs: dict,
                         dtype=torch.float32):
    """``create_model(arch, **model_kwargs)`` on the CPU with a reference
    state dict loaded (strictly: every port parameter must be set)."""
    model = create_model(arch, device="cpu", dtype=dtype, **model_kwargs)
    model.load_state_dict(port_state_dict(state_dict, arch, model_kwargs))
    return model


def reference_state_dict(model: torch.nn.Module, arch: str, model_kwargs: dict) -> dict:
    """The inverse map: ``model``'s weights under the reference's names
    (with batch-norm ``num_batches_tracked`` counters and the copies of
    shared modules, as a reference state dict holds them)."""
    ps = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    m = name_map(arch, model_kwargs, lambda ref, port: port in ps)
    left = sorted(set(ps) - {port for port, _ in m.pairs.values()})
    if left:
        raise KeyError(f"port parameters outside the reference map of {arch}: {left[:10]}")
    sd = {}
    for ref, (port, kind) in m.pairs.items():
        t = ps[port]
        sd[ref] = (t[..., None] if kind == "conv1d" else t).clone()
        if ref.endswith(".running_var"):
            sd[ref[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    for copy, first in m.shared.items():
        sd[copy] = sd[first].clone()
    return sd


def _infer_encoder(sd: dict, keys: set) -> str:
    """The encoder's registry name from weight names and shapes."""
    if "encoder.conv1.weight" in keys:
        block = "bottleneck" if "encoder.layer1.0.conv3.weight" in keys else "basic"
        layers = []
        for k in range(1, 5):
            n = 0
            while f"encoder.layer{k}.{n}.conv1.weight" in keys:
                n += 1
            layers.append(n)
        layers = tuple(layers)
        hits = [n for n, cfg in resnet_configs.items()
                if cfg["block"] == block and tuple(cfg["layers"]) == layers]
        if len(hits) > 1 and block == "bottleneck":
            # one depth, several widths and group counts (resnet50,
            # resnext50, wide_resnet50): the first block's conv widths decide
            width = int(sd["encoder.layer1.0.conv1.weight"].shape[0])
            conv2_in = int(sd["encoder.layer1.0.conv2.weight"].shape[1])

            def expected(cfg):
                groups = cfg.get("groups", 1)
                w = int(64 * cfg.get("width_per_group", 64) / 64) * groups
                return w, w // groups

            hits = [n for n in hits if expected(resnet_configs[n]) == (width, conv2_in)]
        if len(hits) != 1:
            raise ValueError(f"cannot identify resnet encoder (block={block}, layers={layers})")
        return hits[0]
    if "encoder.stem.cbr.0.weight" in keys:
        depths, widths = [], []
        for k in range(1, 5):
            n = 0
            while f"encoder.stage{k}.block{n + 1}.bottleneck.a.0.weight" in keys:
                n += 1
            depths.append(n)
            widths.append(int(sd[f"encoder.stage{k}.block1.bottleneck.c.0.weight"].shape[0]))
        use_se = any(".se." in k for k in keys)
        for name, cfg in regnet_configs.items():
            p = RegNetParams(**cfg)
            if (list(p.depths), [int(w) for w in p.widths], bool(p.use_se)) == (
                    depths, widths, use_se):
                return name
        raise ValueError(f"cannot identify regnet encoder (depths={depths}, widths={widths})")
    raise ValueError("state dict has neither a resnet nor a regnet encoder")


def infer_arch_and_kwargs(state_dict: dict) -> tuple:
    """``(arch, model_kwargs)`` recovered from a reference state dict.

    Published archives carry no architecture; whatever shapes and names
    show is read from them, and what they do not show (atrous rate
    values, ``stage4_stride``, dropout, PointRend's sampling settings)
    takes the reference's defaults, which every published model uses."""
    sd = _normalize_state_dict(state_dict)
    keys = set(sd)

    def has(prefix):
        return any(k.startswith(prefix) for k in keys)

    encoder = _infer_encoder(sd, keys)
    kw: dict = {"encoder": encoder,
                "num_classes": int(sd["semantic_head.head.1.weight"].shape[0])}
    if has("semantic_fpn."):
        arch = "PanopticBiFPNPR" if has("semantic_pr.") else "PanopticBiFPN"
        kw["fpn_dim"] = int(sd["p2_resample.conv.0.weight"].shape[0])
        n = 0
        while f"semantic_fpn.bifpns.{n}.top_down_fpn.weights" in keys:
            n += 1
        kw["fpn_layers"] = n
        kw["ins_decoder"] = has("instance_fpn.")
    else:
        if has("boundary_head."):
            arch = "PanopticDeepLabBC"
        elif has("semantic_pr."):
            arch = "PanopticDeepLabPR"
        else:
            arch = "PanopticDeepLab"
        enc_widths = list(RESNET_WIDTHS[encoder])
        kw["decoder_channels"] = int(sd["semantic_decoder.fuse.0.0.sepconv.1.weight"].shape[0])
        aspp_ch = int(sd["semantic_decoder.aspp.project.0.weight"].shape[0])
        kw["aspp_channels"] = None if aspp_ch == kw["decoder_channels"] else aspp_ch
        n_rates = 0
        while f"semantic_decoder.aspp.convs.{n_rates + 1}.0.weight" in keys:
            n_rates += 1
        # the rates are dilations, invisible in the shapes: (2, 4, 6) is
        # every published model's
        kw["atrous_rates"] = [2, 4, 6][:n_rates] if n_rates <= 3 else [
            2 * (i + 1) for i in range(n_rates)]
        stages, proj = [], []
        i = 0
        while f"semantic_decoder.project.{i}.0.weight" in keys:
            w = sd[f"semantic_decoder.project.{i}.0.weight"]
            stages.append(enc_widths.index(int(w.shape[1])) + 1)
            proj.append(int(w.shape[0]))
            i += 1
        kw["low_level_stages"] = stages
        kw["low_level_channels_project"] = proj
        kw["ins_decoder"] = has("instance_decoder.")
        if kw["ins_decoder"]:
            # the reference's instance projections are int(ins_ratio *
            # proj[i]): take the shortest decimal ratio that gives every one
            ins_projs = []
            i = 0
            while f"instance_decoder.project.{i}.0.weight" in keys:
                ins_projs.append(int(sd[f"instance_decoder.project.{i}.0.weight"].shape[0]))
                i += 1
            lo = max(p / q for p, q in zip(ins_projs, proj))
            hi = min((p + 1) / q for p, q in zip(ins_projs, proj))
            if not lo < hi:
                raise ValueError(
                    f"cannot recover ins_ratio: instance-decoder projection widths "
                    f"{ins_projs} are inconsistent with semantic projection widths "
                    f"{proj[:len(ins_projs)]} under any single truncating ratio; pass "
                    "model_kwargs explicitly")
            kw["ins_ratio"] = lo
            for nd in range(1, 7):
                cand = math.ceil(lo * 10 ** nd) / 10 ** nd
                if lo <= cand < hi:
                    kw["ins_ratio"] = cand
                    break
    if has("semantic_pr."):
        n_fc = 0
        while f"semantic_pr.point_head.fc_layers.{n_fc}.0.weight" in keys:
            n_fc += 1
        kw["num_fc"] = n_fc
    return arch, kw


class CheckpointReadError(ValueError):
    """The file is not a readable torch checkpoint in any supported format."""


def load_torch_checkpoint(path: str, allow_pickle: bool = False):
    """(state dict, arch or None) of a reference checkpoint file: a
    TorchScript archive (``torch.jit.save``, the published format), a
    ``{state_dict, ...}`` training checkpoint or a raw state dict.

    Checkpoints come from other machines, so ``torch.load`` runs with
    ``weights_only=True`` (tensors only); a legacy checkpoint that pickles
    other objects needs ``allow_pickle=True``.  Raises
    ``CheckpointReadError`` when no format reads the file."""
    import pickle
    import zipfile

    blob = None
    try:
        blob = torch.jit.load(path, map_location="cpu")
    except (RuntimeError, ValueError, zipfile.BadZipFile, EOFError, OSError):
        errors = []
        for weights_only in (True, False) if allow_pickle else (True,):
            try:
                blob = torch.load(path, map_location="cpu", weights_only=weights_only)
                break
            except (RuntimeError, ValueError, pickle.UnpicklingError, zipfile.BadZipFile,
                    EOFError, OSError, AttributeError, ModuleNotFoundError) as e:
                errors.append(e)
        if blob is None:
            hint = "" if allow_pickle else (" (if this is a trusted legacy pickle checkpoint, "
                                            "retry with allow_pickle)")
            raise CheckpointReadError(
                f"{path} is not a readable torch checkpoint (tried torch.jit.load and "
                f"torch.load): {errors[-1]}{hint}")
    if hasattr(blob, "state_dict"):
        return blob.state_dict(), getattr(blob, "arch", None)
    if isinstance(blob, dict) and "state_dict" in blob:
        return blob["state_dict"], blob.get("arch")
    return blob, None
