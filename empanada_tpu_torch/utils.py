"""Device resolution and numerics switches shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "fp32_strict"]


def resolve_device(device=None) -> torch.device:
    """Entry-point device rule: ``None`` means ``"cuda"``.

    A CUDA request without a usable GPU raises instead of carrying on
    silently on the CPU; the CPU is used only when the caller asks for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def fp32_strict() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions, so float32
    checks on the card run in full float32 (cuDNN defaults to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
