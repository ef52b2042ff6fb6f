"""Profiling kernels of the PointRend refine step (counterparts of the TPU
profiling kernels in ``benchmarks/profile_overhead.py`` and
``benchmarks/profile_refine_parts.py``), each a hand-written CUDA kernel
with its plain PyTorch version:

- ``tile_copy``: (N, H, W) bf16 copied through 16 x 128 tiles, a
  256-thread block covering four tiles of a tile row (``k_copy``); plain
  version ``x.clone()``;
- ``gated_tile_copy``: per tile, 2 * s where any |s| <= thr[n], else s
  (``k_when``; with ``reserve`` the refine kernel's dynamic shared memory
  is reserved, unused: ``k_when_scratch`` and ``k_full_skip``), on a
  persistent grid whose rule ``gated_plan`` states;
- ``refine_gather`` / ``refine_interp``: the refine kernel cut after the
  selected points' feature-tap loads and after the bilinear interpolation
  (``profile_refine_parts.py`` modes ``dma`` and ``interp``); at each
  selected pixel the f32 sum over the F channels of the top-left tap or of
  the sampled feature, rounded to bf16; other pixels copy ``up`` through.
  The whole step is ``pointrend_refine.launch`` (mode ``full``).

The copies use 16 x 128 tiles, not the TPU's 32 x 128 tiles, VMEM scratch
or phase-major layout; the refine cuts run over the refine kernel's point
list and persistent grid.  On a CPU tensor each wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises.  ``launches`` counts
the launches of ``tile_copy`` and ``gated_tile_copy``; the refine cuts
count in ``pointrend_refine.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from empanada_tpu_torch.ops import pointrend_refine as prr
from empanada_tpu_torch.ops.pointrend_refine import TILE_H, TILE_W

__all__ = [
    "tile_copy",
    "tile_copy_reference",
    "gated_tile_copy",
    "gated_tile_copy_reference",
    "gated_plan",
    "gated_launch_info",
    "tile_origin",
    "GATED_TILES",
    "refine_gather",
    "refine_interp",
    "refine_phase_reference",
    "launches",
]

launches = {"tile_copy": 0, "gated_tile_copy": 0}
GATED_TILES = 4  # tiles of a gated copy group (csrc/refine_profile.cu kGatedTiles)


def tile_copy_reference(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def gated_tile_copy_reference(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """2 * x on the 16 x 128 tiles of image n holding a pixel with
    |x| <= thr[n], x elsewhere."""
    n, h, w = x.shape
    sel = (x.float().abs() <= thr.float()[:, None, None]).float()
    sel = F.pad(sel, (0, (-w) % TILE_W, 0, (-h) % TILE_H))
    tiles = sel.reshape(n, sel.shape[1] // TILE_H, TILE_H, sel.shape[2] // TILE_W, TILE_W)
    gate = tiles.amax(dim=(2, 4)) > 0
    gate = gate.repeat_interleave(TILE_H, 1).repeat_interleave(TILE_W, 2)[:, :h, :w]
    return torch.where(gate, x * 2, x)


def tile_origin(q: int, h: int, w: int):
    """(image, first row, first column) of flat tile ``q`` of (N, h, w):
    tiles numbered over (image, tile row, tile column), columns fastest."""
    nty, ntx = -(-h // TILE_H), -(-w // TILE_W)
    image, rem = divmod(q, nty * ntx)
    ty, tx = divmod(rem, ntx)
    return image, ty * TILE_H, tx * TILE_W


def gated_plan(n: int, h: int, w: int, blocks_per_sm: int, sms: int):
    """The gated copy's persistent grid, the rule of its launcher: the tiles
    (``tile_origin``'s numbering) cut into groups of ``GATED_TILES``
    consecutive tiles, min(groups, ``blocks_per_sm`` x ``sms``) blocks,
    block b taking groups b, b + grid, ...  Returns (grid, the flat tiles
    of each block)."""
    if blocks_per_sm <= 0 or sms <= 0:
        raise ValueError(f"gated_plan: no block fits (blocks_per_sm={blocks_per_sm}, "
                         f"sms={sms})")
    k = GATED_TILES
    tiles = n * -(-h // TILE_H) * -(-w // TILE_W)
    groups = -(-tiles // k)
    grid = min(groups, blocks_per_sm * sms)
    blocks = [[q for g in range(b, groups, grid) for q in range(g * k, min((g + 1) * k, tiles))]
              for b in range(grid)]
    return grid, blocks


def _top_left_taps(features, b, r, c, h2, w2):
    """The (P, F) top-left bilinear taps of upsampled-grid pixels (b, r, c)
    on the zero-padded feature map."""
    hc, wc = features.shape[1], features.shape[2]
    y0 = torch.floor((r.double() + 0.5) * (hc / h2) - 0.5).long()
    x0 = torch.floor((c.double() + 0.5) * (wc / w2) - 0.5).long()
    inside = (y0 >= 0) & (y0 < hc) & (x0 >= 0) & (x0 < wc)
    taps = features[b, y0.clamp(0, hc - 1), x0.clamp(0, wc - 1)]
    return taps * inside[:, None].to(taps.dtype)


def refine_phase_reference(phase: str, up, thr, features, coarse) -> torch.Tensor:
    """Plain version of a refine cut: ``up`` (N, H2, W2, 1) with each
    selected pixel (|up| <= thr) replaced by the f32 channel sum, rounded
    to ``up``'s dtype, of its top-left tap ("gather") or of its sampled
    feature ("interp", ``pointrend_refine.sample_points``)."""
    n, h2, w2, _ = up.shape
    u = up[..., 0]
    b, r, c = (u.float().abs() <= thr.float()[:, None, None]).nonzero(as_tuple=True)
    if phase == "gather":
        x = _top_left_taps(features, b, r, c, h2, w2)
    elif phase == "interp":
        x, _ = prr.sample_points(features, coarse, b, r, c, h2, w2)
    else:
        raise ValueError(f"phase {phase!r}: expected 'gather' or 'interp'")
    out = u.clone()
    out[b, r, c] = x.float().sum(dim=-1).to(u.dtype)
    return out[..., None]


def _check_cuda(name, *tensors):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} kernel: no CUDA device is available; pass CPU "
                           "tensors (device='cpu') to run the plain version")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors on {dev}")


def _lib():
    from empanada_tpu_torch.ops import _build

    return _build.load("refine_profile")


def _launch(name: str, *args) -> None:
    """Call the C entry ``<name>_launch`` and count one launch of ``name``."""
    fn = getattr(_lib(), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if isinstance(a, ctypes.c_void_p) else ctypes.c_int
                   for a in args]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def _reserve(reserve):
    fdim, dfc = reserve if reserve is not None else (0, 0)
    return int(fdim), int(dfc)


def gated_launch_info(device, n: int, h: int, w: int, reserve=None) -> dict:
    """What the gated copy's launcher picks for a contiguous (n, h, w) bf16
    input on the CUDA ``device`` at ``reserve``: its grid, the blocks of
    the kernel it launches that fit on one SM (read once per device,
    kernel and reservation, and cached) and the card's SMs, for holding
    against ``gated_plan``."""
    if not torch.cuda.is_available():
        raise RuntimeError("gated_tile_copy kernel: no CUDA device is available")
    fn = _lib().gated_tile_copy_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    grid, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    device = torch.device(device)
    with torch.cuda.device(device):
        err = fn(n, h, w, *_reserve(reserve), ctypes.byref(grid), ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"gated_tile_copy plan failed: CUDA error {err}")
    return {"grid": grid.value, "blocks_per_sm": per_sm.value,
            "sms": torch.cuda.get_device_properties(device).multi_processor_count}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _device(name, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


def tile_copy(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bf16 copied through 16 x 128 tiles, four tiles of a tile
    row a block."""
    if _device("tile_copy", x) == "cpu":
        return tile_copy_reference(x)
    _check_cuda("tile_copy", x)
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError("tile_copy: expected an (N, H, W) bf16 tensor")
    out = torch.empty_like(x)
    n, h, w = x.shape
    _launch("tile_copy", _ptr(x), _ptr(out), n, h, w, _stream(x))
    return out


def gated_tile_copy(x: torch.Tensor, thr: torch.Tensor, reserve=None) -> torch.Tensor:
    """Per 16 x 128 tile of image n: 2 * x where any |x| <= thr[n], else x.
    ``reserve`` = (F, D) reserves the dynamic shared memory of a refine
    block of those widths, unused."""
    if _device("gated_tile_copy", x) == "cpu":
        return gated_tile_copy_reference(x, thr)
    _check_cuda("gated_tile_copy", x, thr)
    n, h, w = x.shape
    if x.dtype != torch.bfloat16 or thr.dtype != torch.float32 or thr.shape != (n,):
        raise ValueError("gated_tile_copy: expected (N, H, W) bf16 and (N,) float32")
    out = torch.empty_like(x)
    _launch("gated_tile_copy", _ptr(x), _ptr(thr), _ptr(out), n, h, w, *_reserve(reserve),
            _stream(x))
    return out


def _refine_cut(phase, up, thr, features, coarse, weights):
    if _device(f"refine_{phase}", up) == "cpu":
        return refine_phase_reference(phase, up, thr, features, coarse)
    return prr.launch_phase(phase, up, thr, features, coarse, weights)


def refine_gather(up, thr, features, coarse, weights) -> torch.Tensor:
    """The refine step cut after the selected points' feature-tap loads."""
    return _refine_cut("gather", up, thr, features, coarse, weights)


def refine_interp(up, thr, features, coarse, weights) -> torch.Tensor:
    """The refine step cut after the bilinear interpolation."""
    return _refine_cut("interp", up, thr, features, coarse, weights)
