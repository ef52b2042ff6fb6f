"""One PointRend eval subdivision step for single-logit bf16 models, as a
hand-written CUDA kernel (``csrc/pointrend_refine.cu``) and its plain
PyTorch version (counterpart of ``empanada_tpu/ops/pallas_pointrend.py``).

The step: upsample the logits 2x (bilinear, align_corners=False, bf16 per
pass), find the exact K-th smallest |logit| ``thr``, and where
``|up| <= thr`` replace the logit by the point head's prediction from the
bilinearly sampled features and coarse logits (zero padding); elsewhere
keep ``up``.  The upsample and the threshold run in plain torch, as XLA ran
them around the Pallas kernel; the kernel does the per-tile test, the
sampling, the point MLP and the blend.

``weights`` is ``StandardPointHead.fused_weights(F)``: a list of
``(W_fine (K, D), W_coarse (1, D), bias (1, D))`` per hidden layer and
``(w_pred (1, D), w_pred_coarse, b_pred)`` for the predictor.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.  ``launches`` counts kernel launches by phase:
"full" is the step the main path runs; "gather" and "interp" are its cuts
for timing (``ops/refine_profile.py``).
"""

from __future__ import annotations

import ctypes

import torch

from empanada_tpu_torch.ops.interpolate import bilinear_resize, resize_taps
from empanada_tpu_torch.ops.select import kth_smallest_nonneg

__all__ = [
    "TILE_H",
    "TILE_W",
    "fused_step_supported",
    "fused_refine_step",
    "launch",
    "refine",
    "refine_reference",
    "refine_step_reference",
    "step_inputs",
    "pack_weights",
    "sample_points",
    "launch_phase",
    "launches",
    "PHASES",
]

TILE_H = 16   # output tile rows; the kernel's skip granularity is one tile
TILE_W = 128  # output tile columns
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90

# kernel entry point of each phase of the step (csrc/pointrend_refine.cu)
PHASES = {"full": "pointrend_refine_launch",
          "gather": "pointrend_refine_gather_launch",
          "interp": "pointrend_refine_interp_launch"}
launches = dict.fromkeys(PHASES, 0)


def fused_step_supported(h2: int, w2: int, hc: int, wc: int, num_classes: int,
                         feature_dim: int, dtype) -> bool:
    """Whether one subdivision step (to (h2, w2) from an (hc, wc) feature
    grid) can run through the kernel: bf16, one logit, isotropic scale
    factor 2, 4 or 8, and F % 128 == 0.  Unlike the Pallas kernel, the CUDA
    kernel masks a ragged last tile, so (h2, w2) need not be whole tiles."""
    if num_classes != 1 or dtype != torch.bfloat16:
        return False
    if h2 % hc or w2 % wc or h2 // hc != w2 // wc:
        return False
    return h2 // hc in (2, 4, 8) and feature_dim % 128 == 0


def step_inputs(sem: torch.Tensor, num_points: int):
    """(N, h, w, 1) logits -> the 2x upsampled logits (N, 2h, 2w, 1) and the
    per-image refine threshold (N,) float32: the exact K-th smallest |up|."""
    n, h, w, _ = sem.shape
    up = bilinear_resize(sem, (2 * h, 2 * w), align_corners=False)
    thr = kth_smallest_nonneg(up.float().abs().reshape(n, -1),
                              min(num_points, 4 * h * w))
    return up, thr


def sample_points(features, coarse, b, r, c, h2, w2):
    """Zero-padded bilinear samples of NHWC ``features`` and ``coarse`` at
    upsampled-grid pixels (b, r, c): rows first, rounded to the feature
    dtype, then columns, rounded — the dense zeros-padding resize's values."""
    hc, wc = features.shape[1], features.shape[2]
    dev = features.device
    ty = [torch.from_numpy(a).to(dev)[r] for a in resize_taps(hc, h2, False, True)]
    tx = [torch.from_numpy(a).to(dev)[c] for a in resize_taps(wc, w2, False, True)]
    y0, y1, wy0, wy1 = ty
    x0, x1, wx0, wx1 = tx

    def lerp_rows(src, x):
        a = src[b, y0, x].float() * wy0[:, None] + src[b, y1, x].float() * wy1[:, None]
        return a.to(src.dtype)

    def sample(src):
        a = lerp_rows(src, x0).float()
        z = lerp_rows(src, x1).float()
        return (a * wx0[:, None] + z * wx1[:, None]).to(src.dtype)

    return sample(features), sample(coarse.to(features.dtype))[:, 0]


def _point_mlp(x, cv, weights):
    """Point head on (P, F) samples and (P,) coarse values, bf16 between
    layers and f32 inside each product, as the kernel computes it."""
    layers, (wp, wpc, bp) = weights
    dt = x.dtype
    c = cv.float()[:, None]
    h = x
    for wf, wcol, bias in layers:
        d = h.float() @ wf.float() + c * wcol.float()
        h = torch.relu((d.to(dt).float() + bias.float()).to(dt))
    d = h.float() @ wp.float().reshape(-1) + c[:, 0] * wpc.to(dt).float()
    return (d.to(dt).float() + bp.to(dt).float()).to(dt)


def refine_reference(up, thr, features, coarse, weights) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, H2, W2, 1) ``up`` and (N,)
    ``thr`` -> refined logits (N, H2, W2, 1).  Runs the MLP on the selected
    pixels only, like the kernel."""
    n, h2, w2, _ = up.shape
    u = up[..., 0]
    mask = u.float().abs() <= thr.float()[:, None, None]
    b, r, c = mask.nonzero(as_tuple=True)
    x, cv = sample_points(features, coarse, b, r, c, h2, w2)
    out = u.clone()
    out[b, r, c] = _point_mlp(x, cv, weights)
    return out[..., None]


def pack_weights(weights) -> torch.Tensor:
    """The kernel's single bf16 weight buffer: W_fine of every layer, then
    the coarse rows, the biases, w_pred, w_pred_coarse and b_pred."""
    layers, (wp, wpc, bp) = weights
    parts = [wf for wf, _, _ in layers] + [wc for _, wc, _ in layers]
    parts += [bias for _, _, bias in layers] + [wp, wpc, bp]
    return torch.cat([p.reshape(-1).to(torch.bfloat16) for p in parts])


def launch(up, thr, features, coarse, weights) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises, never falls back, when
    there is no card or an input is not what the kernel takes."""
    return launch_phase("full", up, thr, features, coarse, weights)


def launch_phase(phase, up, thr, features, coarse, weights) -> torch.Tensor:
    """Launch the kernel cut at ``phase`` (a key of ``PHASES``) on CUDA
    tensors and count the launch; the checks of ``launch``."""
    from empanada_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise RuntimeError("pointrend refine kernel: no CUDA device is "
                           "available; pass CPU tensors (device='cpu') to run "
                           "the plain version")

    n, h2, w2, _ = up.shape
    _, hc, wc, fdim = features.shape
    layers = weights[0]
    dfc = layers[0][0].shape[1]
    dev = up.device
    tensors = {"sem": up, "features": features, "coarse": coarse}
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous bf16 tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if thr.device != dev or thr.dtype != torch.float32 or thr.shape != (n,):
        raise ValueError("thr: expected float32 (N,) on the logits' device")
    if coarse.shape != (n, hc, wc, 1) or up.shape[-1] != 1:
        raise ValueError(f"single-logit maps expected, got coarse {tuple(coarse.shape)}")
    if not fused_step_supported(h2, w2, hc, wc, 1, fdim, torch.bfloat16):
        raise ValueError(f"unsupported step geometry: ({h2}, {w2}) from "
                         f"({hc}, {wc}) with F={fdim}")
    if layers[0][0].shape[0] != fdim or dfc % 16 or dfc > 256:
        raise ValueError(f"point head widths F={fdim}, D={dfc}: the kernel takes "
                         "D % 16 == 0, D <= 256")
    lib = _build.load("pointrend_refine")
    lib.pointrend_refine_smem_bytes.restype = ctypes.c_size_t
    lib.pointrend_refine_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    if lib.pointrend_refine_smem_bytes(fdim, dfc) > SMEM_LIMIT:
        raise ValueError(f"F={fdim}, D={dfc} need more shared memory than a block has")
    packed = pack_weights(weights).to(dev)
    out = torch.empty_like(up)
    fn = getattr(lib, PHASES[phase])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    err = fn(up.data_ptr(), thr.data_ptr(), features.data_ptr(), coarse.data_ptr(),
             packed.data_ptr(), out.data_ptr(), n, h2, w2, hc, wc, fdim, dfc,
             len(layers), h2 // hc, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointrend_refine {phase} launch failed: CUDA error {err}")
    launches[phase] += 1
    return out


def refine(up, thr, features, coarse, weights) -> torch.Tensor:
    """The kernel's part of the step: on CUDA tensors a launch (or an
    error), on CPU tensors ``refine_reference``."""
    if up.device.type == "cpu":
        return refine_reference(up, thr, features, coarse, weights)
    if up.device.type != "cuda":
        raise ValueError(f"pointrend refine: no kernel for device {up.device}")
    return launch(up, thr, features, coarse, weights)


def refine_step_reference(sem, features, coarse, weights, num_points: int):
    """Plain PyTorch version of the whole step."""
    up, thr = step_inputs(sem, num_points)
    return refine_reference(up, thr, features, coarse, weights)


def fused_refine_step(sem, features, coarse, weights, num_points: int):
    """One subdivision step (N, h, w, 1) -> (N, 2h, 2w, 1) through the kernel
    on CUDA tensors (the plain version on CPU tensors).  Allocates its
    output and does not synchronise."""
    up, thr = step_inputs(sem, num_points)
    return refine(up, thr, features, coarse, weights)
