"""The s8 x s8 -> s32 convolution of ``int8_execution`` models, as a
hand-written CUDA kernel (``csrc/int8_conv.cu``) and its plain PyTorch
version (counterpart of ``empanada_tpu/models/blocks.py::int8_conv``, XLA's
integer convolution there; not a Pallas kernel).

Per call: the activation is quantized with ONE scale for the whole tensor,
``a_scale = max(max|x|, 1e-12) / 127`` (the batch's images share it), to
``xq = clip(rint(x / a_scale), -127, 127)``; the weights were quantized
once per output channel from their float32 master values
(``quantize_weight``); the products accumulate in int32 and the output is
``dtype(float(acc) * (a_scale * w_scale[o]))``.  Rounding is half to even,
``x / a_scale`` and ``w / w_scale`` are IEEE divisions and ``/ 127`` is a
multiplication by float32(1/127), as XLA computes the JAX function, so the
kernel, the plain version and the JAX function agree bit for bit.

Tensors are NCHW; the kernel reads the activation in ``channels_last``
memory (the port's models run so) and the int8 weights in
``channels_last`` memory, [C_out][kh][kw][C_in], as ``quantize_weight``
returns them; it writes a ``channels_last`` output.

On a CPU tensor ``int8_conv`` runs the plain version; on a CUDA tensor it
calls the registered op ``torch.ops.empanada_tpu_torch.int8_conv``, whose
CUDA implementation launches the kernel (or raises; there is no fallback),
so that ``torch.export`` and the profiler see one op.  ``launches["conv"]``
counts the op's CUDA calls (three kernels each: absmax, quantize, GEMM);
``launches["quantize"]`` counts the quantize passes launched alone, only to
check them.

A call's host work is kept small: the launch plan of a shape (``plan``:
tiles, the split of K, and the SM count it was made for) and the weights'
TMA map (``_weight_map``, keyed by their address and geometry) are cached,
and the C entry point takes eight arguments.

What bounds it on an H100: at MitoNet_v1's shapes the integer operations
(1.2-4.8 G a convolution of a 512 x 512 request, against under 5 MB moved)
on the tensor cores' int8 rate, 1,979 TOP/s dense.  The quantize passes
move bytes.  The kernel runs ``wgmma`` s8 from swizzled shared memory, K
split across a cluster where a request's grid is small; its times beside
the bound are in PERF.md.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

__all__ = [
    "int8_conv",
    "int8_conv_op",
    "int8_conv_reference",
    "launch",
    "launch_plan",
    "launch_quantize",
    "launches",
    "output_size",
    "plan",
    "quantize_activation_reference",
    "quantize_weight",
    "split_range",
]

launches = {"conv": 0, "quantize": 0}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_cards: dict = {}


def output_size(size: int, k: int, stride: int, pad: int, dilation: int) -> int:
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


# float32(1) / float32(127): XLA folds the scales' ``/ 127.0`` into a
# multiplication by this reciprocal, so the port multiplies too
INV127 = float(np.float32(1) / np.float32(127))


def quantize_weight(w: torch.Tensor):
    """(wq, w_scale) of an OIHW weight, from its float32 values:
    ``w_scale = max(max|w| over (I, H, W) / 127, 1e-12)`` (O,) float32 and
    ``wq = clip(rint(w / w_scale), -127, 127)`` int8, in ``channels_last``
    memory ([O][kh][kw][I], the kernel's layout)."""
    wf = w.detach().to(torch.float32)
    w_scale = (wf.abs().amax(dim=(1, 2, 3)) * INV127).clamp_min(1e-12)
    wq = torch.round(wf / w_scale[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return wq.contiguous(memory_format=torch.channels_last), w_scale


def quantize_activation_reference(x: torch.Tensor):
    """(xq int8 of x's shape, a_scale 0-d float32): the per-tensor
    quantization of the plain version and of the kernel's first two
    passes."""
    xf = x.to(torch.float32)
    a_scale = xf.abs().amax().clamp_min(1e-12) * INV127
    xq = torch.round(xf / a_scale).clamp_(-127, 127).to(torch.int8)
    return xq, a_scale


def int8_conv_reference(x, wq, w_scale, stride: int, pad: int, dilation: int,
                        dtype=None) -> torch.Tensor:
    """Plain PyTorch version: the int32 sums exactly, as a float64
    convolution of the int8 values (|acc| <= 127^2 * K < 2^53), then
    ``float32(acc) * (a_scale * w_scale)`` cast to ``dtype`` (default x's),
    in ``channels_last`` memory."""
    dtype = dtype or x.dtype
    xq, a_scale = quantize_activation_reference(x)
    acc = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), stride=stride, padding=pad,
                   dilation=dilation)
    scale = a_scale * w_scale.to(torch.float32)
    y = (acc.to(torch.float32) * scale[None, :, None, None]).to(dtype)
    out = torch.empty(y.shape, dtype=dtype, device=y.device,
                      memory_format=torch.channels_last)
    return out.copy_(y)


@functools.cache
def _lib():
    from empanada_tpu_torch.ops import _build

    lib = _build.load("int8_conv")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.int8_quantize_launch.restype = ci
    lib.int8_quantize_launch.argtypes = [ci, vp, ctypes.c_longlong, vp, vp, vp, vp]
    lib.int8_weight_map.restype = ci
    lib.int8_weight_map.argtypes = [vp, ci, ctypes.c_longlong, vp]
    lib.int8_conv_launch.restype = ci
    lib.int8_conv_launch.argtypes = [ci] + [vp] * 7
    lib.int8_max_clusters.restype = ci
    lib.int8_max_clusters.argtypes = [ci]
    return lib


# the GEMM's tile (rows x columns x K bytes a step) and the largest split
# (a cluster of blocks: past 4 the reduction through distributed shared memory
# costs more than the K steps it saves, PERF.md); the prologue's blocks and
# partial maxima
BM = BN = BK = 128
MAX_SPLIT = 4
REDUCE_BLOCKS = 1056


class Plan(NamedTuple):
    """The kernel's launch plan of one shape, the order of ``ConvPlan``
    in ``csrc/int8_conv.cu``: grid (split * tiles_m, tiles_n).  ``wb`` > 0:
    the activations come by TMA and an M tile is a block of BM // wb rows
    of wb output pixels of one image; 0: by ``cp.async``, BM consecutive
    output pixels."""

    n: int
    h: int
    w: int
    c: int
    o: int
    kh: int
    kw: int
    stride: int
    pad: int
    dilation: int
    ho: int
    wo: int
    tiles_m: int
    tiles_n: int
    split: int
    k_steps: int
    wb: int


@functools.lru_cache(maxsize=512)
def plan(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int, stride: int, pad: int,
         dilation: int, sms: int, clusters: tuple | None = None) -> Plan:
    """The launch plan of an NHWC (n, h, w, c) input and (o, c, kh, kw)
    weights on a card of ``sms`` SMs, or ValueError for what the kernel
    does not take.  ``clusters[s - 1]``: the most clusters of s blocks the
    card holds at once (``_card``; default ``sms // s``, which a card
    whose GPCs differ in size does not reach).  Tiles are BM x BN; K runs
    in steps of BK bytes, one tap taking ceil(c / BK) of them.  A grid of
    tiles that covers at least half the SMs is not split (a batch of 8); a
    smaller one (a request) splits K over the most blocks a cluster such
    that all its clusters are resident at once, at most ``MAX_SPLIT`` and
    at most one a K step.  Where the activations come by TMA
    (``_tile_width``), M tiles are spatial blocks of one image, else runs
    of BM output pixels."""
    if c % 32:
        raise ValueError(f"int8 conv: {c} input channels; the kernel takes C_in % 32 == 0")
    if o % 8:
        raise ValueError(f"int8 conv: {o} output channels; the kernel takes C_out % 8 == 0")
    if min(n, h, w, kh, kw, stride, dilation) < 1 or pad < 0:
        raise ValueError(f"int8 conv: input {n} x {h} x {w}, kernel {kh} x {kw}, stride "
                         f"{stride}, padding {pad}, dilation {dilation} out of range")
    if n * h * w * c >= 2 ** 31:
        raise ValueError(f"int8 conv: {n * h * w * c} elements; the kernel indexes below 2^31")
    ho, wo = (output_size(h, kh, stride, pad, dilation),
              output_size(w, kw, stride, pad, dilation))
    if ho <= 0 or wo <= 0 or n * ho * wo * o >= 2 ** 31:
        raise ValueError(f"int8 conv: output {n} x {o} x {ho} x {wo} out of the kernel's range")
    wb = _tile_width(c, stride, ho, wo)
    if wb:
        tiles_m = n * -(-ho // (BM // wb)) * -(-wo // wb)
    else:
        tiles_m = -(-n * ho * wo // BM)
    tiles_n = -(-o // BN)
    k_steps = kh * kw * -(-c // BK)
    tiles = tiles_m * tiles_n
    clusters = clusters or tuple(sms // s for s in range(1, MAX_SPLIT + 1))
    split = 1
    if 2 * tiles < sms:
        split = max([s for s in range(1, min(MAX_SPLIT, k_steps) + 1)
                     if tiles <= clusters[s - 1]], default=1)
    return Plan(n, h, w, c, o, kh, kw, stride, pad, dilation, ho, wo, tiles_m, tiles_n,
                split, k_steps, wb)


def _tile_width(c: int, stride: int, ho: int, wo: int) -> int:
    """The output pixels a row of a TMA-fed M tile (0: the ``cp.async``
    path): at least BK input channels (a box's 128 bytes), a stride that a
    TMA box can traverse (<= 8, the box <= 256 elements a side); the width
    of the fewest tiles, the wider of equals."""
    if c < BK or stride > 8:
        return 0
    fits = [wb for wb in (128, 64, 32, 16, 8, 4, 2, 1)
            if wb * stride <= 256 and BM // wb * stride <= 256]
    return min(fits, key=lambda wb: -(-ho // (BM // wb)) * -(-wo // wb))


def split_range(k_steps: int, split: int, rank: int) -> tuple:
    """The K steps [lo, hi) of block ``rank`` of a split, as the kernel
    takes them."""
    return rank * k_steps // split, (rank + 1) * k_steps // split


@functools.lru_cache(maxsize=512)
def _plan_ints(shape: tuple, sms: int, clusters: tuple):
    return (ctypes.c_int * len(Plan._fields))(*plan(*shape, sms, clusters))


@functools.lru_cache(maxsize=256)
def _weight_map(ptr: int, o: int, k: int):
    """The TMA map of int8 weights [O, K] at ``ptr`` (128 bytes, encoded
    once; it holds the address and the geometry, not the values)."""
    buf = ctypes.create_string_buffer(128)
    err = _lib().int8_weight_map(ptr, o, k, buf)
    if err != 0:
        raise RuntimeError(f"int8 conv: weight tensor map failed: CUDA error {err}")
    return buf


def _card(device) -> tuple:
    """(SMs, the most clusters of 1..MAX_SPLIT GEMM blocks held at once)
    of a CUDA device, asked once."""
    index = device.index
    if index not in _cards:
        with torch.cuda.device(index):
            clusters = tuple(_lib().int8_max_clusters(s) for s in range(1, MAX_SPLIT + 1))
        if min(clusters) < 1:
            raise RuntimeError(f"int8 conv: cluster occupancy query failed: {clusters}")
        _cards[index] = (torch.cuda.get_device_properties(index).multi_processor_count,
                            clusters)
    return _cards[index]


def _check_input(x):
    if not torch.cuda.is_available():
        raise RuntimeError("int8 conv kernel: no CUDA device is available; pass CPU "
                           "tensors (device='cpu') to run the plain version")
    if x.device.type != "cuda" or x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"int8 conv: expected a 4-D bf16 or float32 CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.shape[1] % 32:
        raise ValueError(f"int8 conv: {x.shape[1]} input channels; the kernel takes "
                         "C_in % 32 == 0")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"int8 conv: {x.numel()} elements; the kernel indexes below 2^31")
    return x.contiguous(memory_format=torch.channels_last)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _scratch(x):
    """One call's scratch: xq (x.numel() int8), then the max and the
    prologue's partial maxima (float32)."""
    return torch.empty(x.numel() + 4 * (1 + REDUCE_BLOCKS), dtype=torch.int8, device=x.device)


def launch_quantize(x: torch.Tensor):
    """The kernel's first two passes alone on a CUDA tensor: (xq int8 of
    x's shape in ``channels_last`` memory, a_scale 0-d float32, and the
    (1,) int32 bits of max|x|)."""
    x = _check_input(x)
    n, c, h, w = x.shape
    scratch = _scratch(x)
    amax = scratch[x.numel():x.numel() + 4].view(torch.int32)
    err = _lib().int8_quantize_launch(_DTYPES[x.dtype], x.data_ptr(), x.numel(),
                                      amax.data_ptr(), amax.data_ptr() + 4,
                                      scratch.data_ptr(), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"int8 quantize launch failed: CUDA error {err}")
    launches["quantize"] += 1
    xq = scratch[:x.numel()].view(n, h, w, c).permute(0, 3, 1, 2)
    a_scale = amax.view(torch.float32).clamp_min(1e-12)[0] * INV127
    return xq, a_scale, amax


def _launch_args(x, wq, w_scale, stride, pad, dilation):
    x = _check_input(x)
    n, c, h, w = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 4 or wq.shape[1] != c or wq.device != x.device:
        raise ValueError(f"int8 conv: weights {wq.dtype} {tuple(wq.shape)} on {wq.device} "
                         f"for {c} input channels on {x.device}")
    o, _, kh, kw = wq.shape
    if (w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (o,)
            or w_scale.device != x.device):
        raise ValueError("int8 conv: w_scale must be float32 (C_out,) on the input's device")
    shape = (n, h, w, c, o, kh, kw, stride, pad, dilation)
    return x, shape, _card(x.device)


def launch_plan(x, wq, w_scale, stride: int, pad: int, dilation: int) -> Plan:
    """The plan ``launch`` takes for these CUDA tensors on their card."""
    _, shape, card = _launch_args(x, wq, w_scale, stride, pad, dilation)
    return plan(*shape, *card)


def launch(x, wq, w_scale, stride: int, pad: int, dilation: int) -> torch.Tensor:
    """The whole function on CUDA tensors (quantize, then the implicit
    GEMM), output in x's type: allocates the output and its scratch, does
    not synchronise, raises (never falls back) without a card or on inputs
    the kernel does not take."""
    x, shape, card = _launch_args(x, wq, w_scale, stride, pad, dilation)
    p = plan(*shape, *card)
    n, _, _, c, o, kh, kw = shape[:7]
    wq = wq.contiguous(memory_format=torch.channels_last)
    w_scale = w_scale.contiguous()
    out = torch.empty((n, o, p.ho, p.wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    scratch = _scratch(x)
    err = _lib().int8_conv_launch(_DTYPES[x.dtype], x.data_ptr(), scratch.data_ptr(),
                                  _weight_map(wq.data_ptr(), o, kh * kw * c),
                                  w_scale.data_ptr(), out.data_ptr(), _plan_ints(shape, *card),
                                  _stream(x.device))
    if err != 0:
        raise RuntimeError(f"int8 conv launch failed: CUDA error {err}")
    launches["conv"] += 1
    return out


@torch.library.custom_op("empanada_tpu_torch::int8_conv", mutates_args=(),
                         device_types="cpu")
def int8_conv_op(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, stride: int,
                 pad: int, dilation: int) -> torch.Tensor:
    """The convolution as a registered op, output in x's type; this body
    is the CPU implementation, the plain version."""
    return int8_conv_reference(x, wq, w_scale, stride, pad, dilation)


@int8_conv_op.register_kernel("cuda")
def _int8_conv_op_cuda(x, wq, w_scale, stride, pad, dilation):
    return launch(x, wq, w_scale, stride, pad, dilation)


@int8_conv_op.register_fake
def _int8_conv_op_fake(x, wq, w_scale, stride, pad, dilation):
    if x.dim() != 4 or wq.dim() != 4 or wq.shape[1] != x.shape[1]:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} and weights {tuple(wq.shape)}")
    if wq.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError("int8_conv: int8 weights and float32 scales expected")
    n, _, h, w = x.shape
    o, _, kh, kw = wq.shape
    shape = (n, o, output_size(h, kh, stride, pad, dilation),
             output_size(w, kw, stride, pad, dilation))
    return torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)


@register_flop_formula(torch.ops.empanada_tpu_torch.int8_conv)
def _int8_conv_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """Two operations per multiply-add, as for a float convolution, so that
    a FLOP count of an int8 model's forward keeps its convolutions."""
    return conv_flop_count(list(x_shape), list(w_shape), list(out_shape))


def int8_conv(x, wq, w_scale, stride: int, pad: int, dilation: int,
              dtype=None) -> torch.Tensor:
    """NCHW ``x`` (any float type) convolved with the int8 OIHW ``wq`` and
    its (O,) float32 scales (``quantize_weight``), symmetric padding
    ``pad``, output in ``dtype`` (default x's): the plain version on CPU
    tensors, the registered op (the kernel) on CUDA tensors, which writes
    x's type only."""
    dtype = dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv_reference(x, wq, w_scale, stride, pad, dilation, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8 conv: no kernel for device {x.device}")
    if dtype != x.dtype:
        raise ValueError(f"int8 conv: output {dtype} for a {x.dtype} input; the kernel "
                         "writes the input's type")
    return int8_conv_op(x, wq, w_scale, stride, pad, dilation)
