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
counts the op's CUDA calls (a memset and three kernels each);
``launches["quantize"]`` counts the quantize passes launched alone, only to
check them.

What bounds it on an H100: at MitoNet_v1's shapes the integer operations
(1.2-4.8 G a convolution of a 512 x 512 request, against under 5 MB moved)
on the tensor cores' int8 rate, 1,979 TOP/s dense.  The quantize passes
move bytes.  The first kernel runs ``mma.sync`` from registers; its times
beside the bound are in PERF.md.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

__all__ = [
    "int8_conv",
    "int8_conv_op",
    "int8_conv_reference",
    "launch",
    "launch_quantize",
    "launches",
    "output_size",
    "quantize_activation_reference",
    "quantize_weight",
]

launches = {"conv": 0, "quantize": 0}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_sm_cache: dict = {}


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
    lib.int8_quantize_launch.restype = ctypes.c_int
    lib.int8_quantize_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.int8_conv_launch.restype = ctypes.c_int
    lib.int8_conv_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    return lib


def _tile_rows(m: int, o: int, device) -> int:
    """The conv kernel's m16 tiles a warp (rows a block: 32 of them): the
    largest of 4, 2, 1 whose grid covers the card's SMs, else 1."""
    device = torch.device(device)
    if device.index not in _sm_cache:
        _sm_cache[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    sms = _sm_cache[device.index]
    for mt in (4, 2):
        if -(-m // (32 * mt)) * -(-o // 128) >= sms:
            return mt
    return 1


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


def launch_quantize(x: torch.Tensor):
    """The kernel's first two passes alone on a CUDA tensor: (xq int8 of
    x's shape in ``channels_last`` memory, a_scale 0-d float32, and the
    (1,) int32 bits of max|x|)."""
    x = _check_input(x)
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device,
                     memory_format=torch.channels_last)
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    err = _lib().int8_quantize_launch(_DTYPES[x.dtype], x.data_ptr(), x.numel(),
                                      amax.data_ptr(), xq.data_ptr(), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"int8 quantize launch failed: CUDA error {err}")
    launches["quantize"] += 1
    a_scale = amax.view(torch.float32).clamp_min(1e-12)[0] * INV127
    return xq, a_scale, amax


def _conv_args(x, wq, w_scale, stride, pad, dilation):
    n, c, h, w = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 4 or wq.shape[1] != c or wq.device != x.device:
        raise ValueError(f"int8 conv: weights {wq.dtype} {tuple(wq.shape)} on {wq.device} "
                         f"for {c} input channels on {x.device}")
    o, _, kh, kw = wq.shape
    if o % 8:
        raise ValueError(f"int8 conv: {o} output channels; the kernel takes C_out % 8 == 0")
    if (w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (o,)
            or w_scale.device != x.device):
        raise ValueError("int8 conv: w_scale must be float32 (C_out,) on the input's device")
    ho, wo = (output_size(h, kh, stride, pad, dilation),
              output_size(w, kw, stride, pad, dilation))
    if ho <= 0 or wo <= 0 or n * ho * wo * o >= 2 ** 31:
        raise ValueError(f"int8 conv: output {n} x {o} x {ho} x {wo} out of the kernel's range")
    out = torch.empty((n, o, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    shape = (n, h, w, c, o, kh, kw, stride, pad, dilation, ho, wo)
    return (wq.contiguous(memory_format=torch.channels_last), w_scale.contiguous(), out,
            shape, _tile_rows(n * ho * wo, o, x.device))


def launch(x, wq, w_scale, stride: int, pad: int, dilation: int) -> torch.Tensor:
    """The whole function on CUDA tensors (quantize, then the implicit
    GEMM), output in x's type: allocates the output and its scratch, does
    not synchronise, raises (never falls back) without a card or on inputs
    the kernel does not take."""
    x = _check_input(x)
    wq, w_scale, out, shape, mt = _conv_args(x, wq, w_scale, stride, pad, dilation)
    xq = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    err = _lib().int8_conv_launch(_DTYPES[x.dtype], mt, x.data_ptr(),
                                  xq.data_ptr(), amax.data_ptr(), wq.data_ptr(),
                                  w_scale.data_ptr(), out.data_ptr(), *shape,
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
