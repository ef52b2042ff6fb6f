"""One PointRend eval subdivision step for single-logit bf16 models, as a
hand-written CUDA kernel (``csrc/pointrend_refine.cu``) and its plain
PyTorch version (counterpart of ``empanada_tpu/ops/pallas_pointrend.py``).

The step: upsample the logits 2x (bilinear, align_corners=False, bf16 per
pass), find the exact K-th smallest |logit| ``thr``, and where
``|up| <= thr`` replace the logit by the point head's prediction from the
bilinearly sampled features and coarse logits (zero padding); elsewhere
keep ``up``.  The upsample and the threshold run in plain torch, as XLA ran
them around the Pallas kernel; the kernel does the rest in two passes on
one stream: a select pass that copies ``up`` through and compacts the
selected pixels into a device list (``select_points_reference`` is its
plain version), and a persistent refine pass over that list (sampling, the
point MLP on the tensor cores, the blend).  Nothing is read back to the
host between them.

``weights`` is ``StandardPointHead.fused_weights(F)``: a list of
``(W_fine (K, D), W_coarse (1, D), bias (1, D))`` per hidden layer and
``(w_pred (1, D), w_pred_coarse, b_pred)`` for the predictor; or that
list packed once by ``pack_weights`` into the kernel's layout
(``StandardPointHead.packed_weights`` caches it).

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.  ``launches`` counts steps by phase (one step
is the two CUDA launches): "full" is the step the main path runs;
"gather" and "interp" are its cuts for timing (``ops/refine_profile.py``).

The kernel's part of the step is also the registered op
``torch.ops.empanada_tpu_torch.pointrend_refine`` (``refine_op``; tensors
and ints only: the packed weight buffer and the head's widths), so that
``torch.export`` can trace a program through it (``api/deploy.py``): its
CUDA implementation is ``launch``, its fake one allocates the output's
shape, its CPU one is ``refine_reference``.  ``refine`` reaches CUDA
tensors through the op, so the engines and an exported program share one
way to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from empanada_tpu_torch.ops.interpolate import bilinear_resize, resize_taps
from empanada_tpu_torch.ops.select import kth_smallest_nonneg

__all__ = [
    "TILE_H",
    "TILE_W",
    "POINTS_PER_CHUNK",
    "PackedWeights",
    "fused_step_supported",
    "fused_refine_step",
    "launch",
    "refine",
    "refine_op",
    "refine_reference",
    "refine_step_reference",
    "select_points_reference",
    "step_inputs",
    "pack_weights",
    "unpack_weights",
    "persistent_grid",
    "sample_points",
    "launch_phase",
    "launches",
    "PHASES",
]

TILE_H = 16   # tile rows of the profiling copies and of tile statistics
TILE_W = 128  # tile columns
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90
HIDDEN = 256  # the kernel's hidden width: a narrower D is padded with zeros
SLICE_K = 64  # rows of W per weight slice (one 128-byte swizzle row)
POINTS_PER_CHUNK = 64  # points a refine chunk: the M = 64 rows of its wgmma products
SELECT_VEC, WARP = 8, 32  # pixels per thread and threads per warp of the select pass

# phase ids of csrc/pointrend_refine.cu
PHASES = {"gather": 0, "interp": 1, "full": 2}
launches = dict.fromkeys(PHASES, 0)
_grid_cache: dict = {}


@dataclass(frozen=True, eq=False)
class PackedWeights:
    """The point head in the kernel's layout (``pack_weights``)."""

    buf: torch.Tensor  # 1-D bf16
    in_features: int   # F
    fc_dim: int        # D
    num_fc: int        # hidden layers


def fused_step_supported(h2: int, w2: int, hc: int, wc: int, num_classes: int,
                         feature_dim: int, dtype) -> bool:
    """Whether one subdivision step (to (h2, w2) from an (hc, wc) feature
    grid) can run through the kernel: bf16, one logit, isotropic scale
    factor 2, 4 or 8, and F % 128 == 0.  Unlike the Pallas kernel, the CUDA
    kernel works on a list of points, so (h2, w2) need not be whole tiles."""
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
    if isinstance(weights, PackedWeights):
        weights = unpack_weights(weights)
    n, h2, w2, _ = up.shape
    u = up[..., 0]
    mask = u.float().abs() <= thr.float()[:, None, None]
    b, r, c = mask.nonzero(as_tuple=True)
    x, cv = sample_points(features, coarse, b, r, c, h2, w2)
    out = u.clone()
    out[b, r, c] = _point_mlp(x, cv, weights)
    return out[..., None]


def select_points_reference(up, thr):
    """Plain version of the select pass: the selected pixels (|up| <= thr[b])
    as a (P, 3) (b, r, c) tensor in the order the kernel's warps list them
    (each thread tests 8 consecutive pixels, a warp 256; within a warp its
    pixels go k-major, k the place in a thread's 8), warps in ascending
    order (on the card the atomics order the warps), and the count P."""
    n, h2, w2, _ = up.shape
    u = up.reshape(-1)
    total = u.numel()
    flat = torch.arange(total, device=up.device)
    sel = u.float().abs() <= thr.float()[flat // (h2 * w2)]
    pad = (-total) % (SELECT_VEC * WARP)
    # (warp, lane, k) -> (warp, k, lane): the order of the list
    sel = F.pad(sel, (0, pad)).reshape(-1, WARP, SELECT_VEC).transpose(1, 2)
    flat = F.pad(flat, (0, pad)).reshape(-1, WARP, SELECT_VEC).transpose(1, 2)
    idx = flat[sel]
    points = torch.stack([idx // (h2 * w2), idx % (h2 * w2) // w2, idx % w2], dim=1)
    return points, int(idx.numel())


def _swizzle_perm(device):
    """(n, chunk) -> the 16-byte chunk that holds logical chunk ``chunk`` of
    row n in wgmma's 128-byte swizzle: chunk XOR (n % 8)."""
    n = torch.arange(HIDDEN, device=device)
    return n[:, None], torch.arange(8, device=device)[None, :] ^ (n[:, None] % 8)


def pack_weights(weights) -> PackedWeights:
    """The kernel's single bf16 weight buffer.  Per hidden layer l, W_l^T
    (HIDDEN x K_l: output column n by input row k, zero-padded to D =
    HIDDEN, K_0 = F, K_l = HIDDEN after) cut into K-slices of 64; each
    slice is HIDDEN rows of 64 bf16 (128 bytes) with the 16-byte chunks of
    row n XOR-swizzled by n % 8, the layout wgmma reads from shared memory
    (csrc/pointrend_refine.cu), so one bulk copy moves a slice.  Then
    w_coarse (L x HIDDEN), bias (L x HIDDEN), w_pred (HIDDEN) and 8 values:
    w_pred_coarse, b_pred, zeros."""
    layers, (wp, wpc, bp) = weights
    fdim, dfc = layers[0][0].shape
    if fdim % SLICE_K or dfc > HIDDEN:
        raise ValueError(f"pack_weights: F={fdim} must be a multiple of {SLICE_K} "
                         f"and D={dfc} at most {HIDDEN}")
    dev, bf16 = layers[0][0].device, torch.bfloat16
    rows, perm = _swizzle_perm(dev)
    parts = []
    for l, (wf, _, _) in enumerate(layers):
        kp = fdim if l == 0 else HIDDEN
        wt = torch.zeros(HIDDEN, kp, dtype=bf16, device=dev)
        wt[:dfc, :wf.shape[0]] = wf.t().to(bf16)
        logical = wt.reshape(HIDDEN, kp // SLICE_K, 8, 8).transpose(0, 1)  # (s, n, chunk, e)
        slices = torch.empty_like(logical)
        slices[:, rows, perm] = logical
        parts.append(slices.reshape(-1))
    num_fc = len(layers)
    vecs = torch.zeros(2 * num_fc + 1, HIDDEN, dtype=bf16, device=dev)
    for l, (_, wc, bias) in enumerate(layers):
        vecs[l, :dfc] = wc.reshape(-1).to(bf16)
        vecs[num_fc + l, :dfc] = bias.reshape(-1).to(bf16)
    vecs[2 * num_fc, :dfc] = wp.reshape(-1).to(bf16)
    tail = torch.zeros(8, dtype=bf16, device=dev)
    tail[0], tail[1] = wpc.to(bf16), bp.to(bf16)
    buf = torch.cat(parts + [vecs.reshape(-1), tail])
    return PackedWeights(buf, int(fdim), int(dfc), num_fc)


def unpack_weights(packed: PackedWeights):
    """Inverse of ``pack_weights`` (plain torch): the fused weights, bf16,
    with the two predictor scalars as 0-d tensors."""
    fdim, dfc, num_fc = packed.in_features, packed.fc_dim, packed.num_fc
    buf = packed.buf
    rows, perm = _swizzle_perm(buf.device)
    ws, off = [], 0
    for l in range(num_fc):
        kp = fdim if l == 0 else HIDDEN
        slices = buf[off:off + HIDDEN * kp].reshape(kp // SLICE_K, HIDDEN, 8, 8)
        wt = slices[:, rows, perm].transpose(0, 1).reshape(HIDDEN, kp)
        ws.append(wt[:dfc, :fdim if l == 0 else dfc].t().contiguous())
        off += HIDDEN * kp
    vecs = buf[off:off + (2 * num_fc + 1) * HIDDEN].reshape(2 * num_fc + 1, HIDDEN)
    tail = buf[off + vecs.numel():]
    layers = [(ws[l], vecs[l, None, :dfc], vecs[num_fc + l, None, :dfc])
              for l in range(num_fc)]
    return layers, (vecs[2 * num_fc, None, :dfc], tail[0], tail[1])


@functools.cache
def _lib():
    from empanada_tpu_torch.ops import _build

    lib = _build.load("pointrend_refine")
    lib.pointrend_refine_smem_bytes.restype = ctypes.c_size_t
    lib.pointrend_refine_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pointrend_refine_blocks_per_sm.restype = ctypes.c_int
    lib.pointrend_refine_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.pointrend_refine_launch.restype = ctypes.c_int
    lib.pointrend_refine_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                                            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return lib


def persistent_grid(device, phase: str = "full", feature_dim: int = 256) -> int:
    """Blocks of the refine pass on ``device``: the blocks of this phase
    that fit on one SM times the card's SMs, read once per (device, phase,
    F) and cached."""
    device = torch.device(device)
    key = (device.index, phase, feature_dim)
    if key not in _grid_cache:
        per_sm = _lib().pointrend_refine_blocks_per_sm(PHASES[phase], feature_dim)
        if per_sm <= 0:
            raise RuntimeError(f"pointrend refine {phase}, F={feature_dim}: no block fits "
                               f"(code {per_sm})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _grid_cache[key] = per_sm * sms
    return _grid_cache[key]


def launch(up, thr, features, coarse, weights) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises, never falls back, when
    there is no card or an input is not what the kernel takes."""
    return launch_phase("full", up, thr, features, coarse, weights)


def launch_phase(phase, up, thr, features, coarse, weights) -> torch.Tensor:
    """Run the step cut at ``phase`` (a key of ``PHASES``) on CUDA tensors:
    the select pass and the refine pass (over ``persistent_grid`` blocks,
    ``POINTS_PER_CHUNK`` points a chunk), and count one step; the checks of
    ``launch``.  Allocates the output, the point list and its counter; does
    not synchronise."""
    if not torch.cuda.is_available():
        raise RuntimeError("pointrend refine kernel: no CUDA device is "
                           "available; pass CPU tensors (device='cpu') to run "
                           "the plain version")

    n, h2, w2, _ = up.shape
    _, hc, wc, fdim = features.shape
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
    total = n * h2 * w2
    if not 0 < total < 2 ** 31 - 4096:
        raise ValueError(f"{total} pixels: the kernel indexes up to 2^31 - 4096")
    packed = weights if isinstance(weights, PackedWeights) else None
    in_dim, dfc = ((packed.in_features, packed.fc_dim) if packed is not None
                   else tuple(weights[0][0][0].shape))
    if in_dim != fdim or dfc % 16 or dfc > HIDDEN:
        raise ValueError(f"point head widths F={in_dim}, D={dfc} for F={fdim} features: "
                         f"the kernel takes D % 16 == 0, D <= {HIDDEN}")
    lib = _lib()
    if lib.pointrend_refine_smem_bytes(fdim, dfc) > SMEM_LIMIT:
        raise ValueError(f"F={fdim}, D={dfc} need more shared memory than a block has")
    if packed is None:
        packed = pack_weights(weights)
    if packed.buf.device != dev or features.data_ptr() % 16 or packed.buf.data_ptr() % 16:
        raise ValueError("features and packed weights: expected 16-byte aligned tensors "
                         "on the logits' device")
    grid = persistent_grid(dev, phase, fdim)
    out = torch.empty_like(up)
    points = torch.empty(total, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.pointrend_refine_launch(
        PHASES[phase], grid, up.data_ptr(), thr.data_ptr(),
        features.data_ptr(), coarse.data_ptr(), packed.buf.data_ptr(), out.data_ptr(),
        points.data_ptr(), count.data_ptr(), n, h2, w2, hc, wc, fdim, packed.num_fc,
        h2 // hc, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointrend_refine {phase} launch failed: CUDA error {err}")
    launches[phase] += 1
    return out


@torch.library.custom_op("empanada_tpu_torch::pointrend_refine", mutates_args=(),
                         device_types="cpu")
def refine_op(up: torch.Tensor, thr: torch.Tensor, features: torch.Tensor,
              coarse: torch.Tensor, weights: torch.Tensor, in_features: int, fc_dim: int,
              num_fc: int) -> torch.Tensor:
    """The kernel's part of the step as a registered op; ``weights`` is
    ``PackedWeights.buf``.  This body is the CPU implementation, the plain
    version (for ``torch.library.opcheck`` and programs exported on the
    CPU)."""
    return refine_reference(up, thr, features, coarse,
                            PackedWeights(weights, in_features, fc_dim, num_fc))


@refine_op.register_kernel("cuda")
def _refine_op_cuda(up, thr, features, coarse, weights, in_features, fc_dim, num_fc):
    return launch(up, thr, features, coarse,
                  PackedWeights(weights, in_features, fc_dim, num_fc))


@refine_op.register_fake
def _refine_op_fake(up, thr, features, coarse, weights, in_features, fc_dim, num_fc):
    n = up.shape[0]
    if up.dim() != 4 or up.shape[-1] != 1 or features.dim() != 4 or coarse.dim() != 4:
        raise ValueError("pointrend_refine: expected NHWC up (N, H2, W2, 1), features "
                         "and coarse")
    if thr.dtype != torch.float32 or tuple(thr.shape) != (n,):
        raise ValueError("pointrend_refine: thr must be float32 (N,)")
    if features.shape[-1] != in_features or weights.dim() != 1:
        raise ValueError(f"pointrend_refine: {features.shape[-1]} feature channels for a "
                         f"head of {in_features}, or a weight buffer that is not 1-D")
    if features.dtype != up.dtype or coarse.dtype != up.dtype:
        raise ValueError("pointrend_refine: up, features and coarse must share a dtype")
    return torch.empty_like(up)


def refine(up, thr, features, coarse, weights) -> torch.Tensor:
    """The kernel's part of the step: on CUDA tensors the registered op (a
    launch or an error), on CPU tensors ``refine_reference``."""
    if up.device.type == "cpu":
        return refine_reference(up, thr, features, coarse, weights)
    if up.device.type != "cuda":
        raise ValueError(f"pointrend refine: no kernel for device {up.device}")
    packed = weights if isinstance(weights, PackedWeights) else pack_weights(weights)
    return refine_op(up, thr, features, coarse, packed.buf, packed.in_features,
                     packed.fc_dim, packed.num_fc)


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
