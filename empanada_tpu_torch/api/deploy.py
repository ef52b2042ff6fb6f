"""Serving artifacts (counterpart of ``empanada_tpu/api/deploy.py``): the
whole device pipeline of one 2D request baked into one file with
``torch.export``.

The pipeline, as ``Engine2d`` runs it on one uint8 slice: normalization
with the engine's float32 arithmetic, ``factor_pad``, the forward with
``render_steps`` PointRend steps, the instance cells on the coarse grid,
the hardened logits, the coarse merge and the crop.  The weights are
baked in as the program's constants.

Artifact layout (a zip):
    meta.json  the JAX artifact's keys (format, model name, classes, input
               shape and dtype, ``platforms``, engine parameters);
               ``platforms`` names the one device the program was
               exported for, ``"cuda"`` or ``"cpu"``
    fn.pt2     ``torch.export.save`` of the exported program

An artifact is specialized to one (H, W) and one device.  Unlike the JAX
package's StableHLO artifact, it needs the port's op library to load: on
the card the PointRend refine steps are calls of the registered op
``torch.ops.empanada_tpu_torch.pointrend_refine``
(``ops/pointrend_refine.py``), which launches the hand-written kernel;
``load_serving_artifact`` imports that module first.  A CUDA export holds
exactly the op calls that the engine's eager path launches, never the
plain version of the step.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from empanada_tpu_torch.api.utils import load_model_from_config
from empanada_tpu_torch.models.point_rend import PointRendSemSegHead
from empanada_tpu_torch.ops import pointrend_refine as prr
from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.utils import resolve_device

__all__ = ["export_serving_artifact", "load_serving_artifact", "ServingModel"]

_FORMAT = "empanada_tpu_torch-serving-v1"
PLATFORMS = ("cuda", "cpu")


def _platform(platforms) -> str:
    """The one device of ``platforms`` (a name or a sequence of one)."""
    names = [platforms] if isinstance(platforms, str) else list(platforms)
    if len(names) != 1:
        raise ValueError(f"platforms {names}: an exported program is specialized to one "
                         f"device; export one artifact each of {PLATFORMS}")
    if names[0] == "tpu":
        raise ValueError("platforms tpu: the port exports for NVIDIA GPUs (cuda) or the "
                         "CPU; a TPU artifact is the JAX package's (empanada_tpu.api.deploy)")
    if names[0] not in PLATFORMS:
        raise ValueError(f"platform {names[0]!r}: expected one of {PLATFORMS}")
    return names[0]


class _Pipeline(torch.nn.Module):
    """uint8 (H, W) -> int32 (H, W) panoptic map: one request's device
    chain, as ``Engine2d`` dispatches it."""

    def __init__(self, model, size, padding_factor, norm_sub, norm_mul, thing_list,
                 num_classes, label_divisor, nms_threshold, nms_kernel, confidence_thr,
                 stuff_area, void_label, max_centers, coarse, render_steps):
        super().__init__()
        self.model = model
        self.dtype = next(model.parameters()).dtype
        self.size = size
        self.padding_factor = padding_factor
        self.norm_sub, self.norm_mul = norm_sub, norm_mul
        self.thing_list = thing_list
        self.num_classes = num_classes
        self.label_divisor = label_divisor
        self.nms_threshold, self.nms_kernel = nms_threshold, nms_kernel
        self.confidence_thr = confidence_thr
        self.stuff_area, self.void_label = stuff_area, void_label
        self.max_centers = max_centers
        self.coarse = coarse
        self.render_steps = render_steps

    def forward(self, image_u8):
        # Preprocessor's float32 arithmetic: subtract mean * 255, multiply
        # by the reciprocal of std * 255 (another association differs in
        # the last ulp and can flip a pixel at the threshold)
        x = (image_u8.to(torch.float32) - self.norm_sub) * self.norm_mul
        x = pp.factor_pad(x[None, :, :, None].to(self.dtype), self.padding_factor)
        out = self.model(x, render_steps=self.render_steps, interpolate_ins=not self.coarse)
        cells = pp.get_instance_cells(out["ctr_hmp"], out["offsets"], self.coarse, 1,
                                      self.nms_threshold, self.nms_kernel, self.max_centers,
                                      keep_coarse=True)
        sem = pp.harden_logits(out["sem_logits"], self.confidence_thr)
        pan = pp.merge_semantic_and_instance_coarse(
            sem, cells, self.label_divisor, self.thing_list, self.stuff_area,
            self.void_label, self.num_classes, self.max_centers,
            step=4 if self.coarse else 1)
        h, w = self.size
        return pan[0, :h, :w]


def _freeze_point_heads(model) -> None:
    """Pack, once, the point heads whose steps the refine kernel takes (one
    logit, F a multiple of 128, bf16), so that the trace reads no cache
    key (``StandardPointHead.freeze_packed``)."""
    dtype = next(model.parameters()).dtype
    for m in model.modules():
        if isinstance(m, PointRendSemSegHead) and m.num_classes == 1:
            fdim = m.point_head.fc1.in_features - m.num_classes
            if dtype == torch.bfloat16 and fdim % 128 == 0:
                m.point_head.freeze_packed(fdim)


def export_serving_artifact(model_config: dict, out_path: str, input_shape,
                            platforms=("cuda",), model=None, label_divisor: int = 1000,
                            nms_threshold: float = 0.1, nms_kernel: int = 3,
                            confidence_thr: float = 0.3, stuff_area: int = 64,
                            void_label: int = 0, max_centers: int = 256,
                            fine_boundaries: bool = False, render_steps: int = 2,
                            compute_dtype=None) -> str:
    """Bake the config's model and the whole panoptic pipeline of an
    ``input_shape`` (H, W) uint8 slice into one file at ``out_path``.

    ``platforms``: the one device to export for, ``"cuda"`` (default) or
    ``"cpu"``; ``"tpu"`` is refused.  ``model``: a port model (default:
    the config's bundle), copied before it is prepared for the export.
    ``compute_dtype`` defaults to bfloat16 on the card (the dtype the
    refine kernel takes) and float32 on the CPU, as the command line's.
    The pipeline runs once eagerly first; on the card the exported program
    must call the refine op as many times as that run launched the kernel.
    """
    platform = _platform(platforms)
    dev = resolve_device(platform)
    dtype = compute_dtype or (torch.bfloat16 if dev.type == "cuda" else torch.float32)
    if model is None:
        model = load_model_from_config(model_config, device="cpu")
    model = copy.deepcopy(model).to(device=dev, dtype=dtype).eval()
    _freeze_point_heads(model)
    h, w = int(input_shape[0]), int(input_shape[1])
    mean = float(model_config["norms"]["mean"])
    std = float(model_config["norms"]["std"])
    thing_list = tuple(int(t) for t in model_config["thing_list"])
    pipeline = _Pipeline(
        model, (h, w), int(model_config.get("padding_factor", 128)),
        float(np.float32(mean) * np.float32(255.0)),
        float(np.reciprocal(np.float32(std) * np.float32(255.0), dtype=np.float32)),
        thing_list, int(model.num_classes) + 1, int(label_divisor), float(nms_threshold),
        int(nms_kernel), float(confidence_thr), int(stuff_area), int(void_label),
        int(max_centers), not fine_boundaries, int(render_steps))
    sample = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        before = prr.launches["full"]
        pipeline(sample)
        launched = prr.launches["full"] - before
        program = torch.export.export(pipeline, (sample,), strict=False)
    calls = sum(1 for node in program.graph.nodes
                if node.op == "call_function"
                and node.target is torch.ops.empanada_tpu_torch.pointrend_refine.default)
    if dev.type == "cuda" and calls != launched:
        raise RuntimeError(f"the exported program calls the refine op {calls} times where "
                           f"the eager pipeline launched the kernel {launched} times")

    meta = {
        "format": _FORMAT,
        "model_name": model_config.get("model_name", ""),
        "class_names": {str(k): v for k, v in model_config.get("class_names", {}).items()},
        "labels": [int(c) for c in model_config.get("labels", [])],
        "thing_list": list(thing_list),
        "input_shape": [h, w],
        "input_dtype": "uint8",
        "platforms": [platform],
        "label_divisor": label_divisor,
        "engine_params": {
            "nms_threshold": nms_threshold, "nms_kernel": nms_kernel,
            "confidence_thr": confidence_thr, "stuff_area": stuff_area,
            "void_label": void_label, "max_centers": max_centers,
            "fine_boundaries": fine_boundaries, "render_steps": render_steps,
        },
        "compute_dtype": str(dtype).replace("torch.", ""),
        "refine_op_calls": calls,
    }
    tmp = out_path + ".tmp"
    with tempfile.TemporaryDirectory() as td:
        pt2 = os.path.join(td, "fn.pt2")
        torch.export.save(program, pt2)
        # stored: the weights are most of the bytes and barely compress
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
            z.writestr("meta.json", json.dumps(meta, indent=2))
            z.write(pt2, arcname="fn.pt2")
    os.replace(tmp, out_path)
    return out_path


class ServingModel:
    """A loaded serving artifact: ``model(image_u8)`` -> (H, W) int32
    panoptic map (numpy)."""

    def __init__(self, program, meta: dict, device):
        self._program = program
        self._fn = program.module()
        self.meta = meta
        self.device = device
        self.input_shape = tuple(meta["input_shape"])

    def __call__(self, image: np.ndarray) -> np.ndarray:
        image = np.asarray(image)
        if image.shape != self.input_shape:
            raise ValueError(f"artifact is specialized for {self.input_shape}, got "
                             f"{image.shape} — export one artifact per input shape")
        if image.dtype != np.uint8:
            # a silent cast would wrap uint16 mod 256 or truncate floats
            raise ValueError(f"artifact expects uint8 input (normalization baked for the "
                             f"0-255 range), got {image.dtype} — rescale to uint8 first")
        return self.dispatch(torch.from_numpy(np.ascontiguousarray(image))).cpu().numpy()

    @torch.no_grad()
    def dispatch(self, image: torch.Tensor) -> torch.Tensor:
        """Run the program on a uint8 tensor of the artifact's shape; the
        unfetched map on the artifact's device."""
        return self._fn(image.to(self.device, non_blocking=True))


def load_serving_artifact(path: str) -> ServingModel:
    """Load a serving artifact onto the device it was exported for (a
    "cuda" artifact raises without a GPU).  Needs the port's op library,
    which this module imports, and no model code or config."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a {_FORMAT} artifact")
        device = resolve_device(_platform(meta["platforms"]))
        with tempfile.TemporaryDirectory() as td:
            z.extract("fn.pt2", td)
            program = torch.export.load(os.path.join(td, "fn.pt2"))
    return ServingModel(program, meta, device)
