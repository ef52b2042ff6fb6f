"""Device resolution, numerics switches, asynchronous host copies and a
killable device probe (counterpart of ``empanada_tpu/utils/devices.py``)."""

from __future__ import annotations

import os
import subprocess
import sys

import torch
import torch.distributed as dist

__all__ = ["resolve_device", "local_rank", "fp32_strict", "to_host_async",
           "probe_device_count"]


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` where a launcher
    sets it (torchrun), else the rank of the ``torch.distributed`` world
    modulo the host's card count (0 outside a world)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    n = torch.cuda.device_count()
    return dist.get_rank() % n if n else 0


def resolve_device(device=None) -> torch.device:
    """Entry-point device rule: ``None`` means ``"cuda"``, and in a world of
    processes (``parallel.multihost``) ``cuda:<local_rank>``, this rank's
    card; a device the caller names wins.

    A CUDA request without a usable GPU raises instead of carrying on
    silently on the CPU; the CPU is used only when the caller asks for it.
    """
    if device is None:
        in_world = dist.is_available() and dist.is_initialized()
        device = f"cuda:{local_rank()}" if in_world else "cuda"
    dev = torch.device(device)
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


def to_host_async(t: torch.Tensor):
    """Start the device-to-host copy of ``t``: (host tensor, CUDA event
    recorded after the copy, or None for a tensor already on the CPU).  The
    host bytes may be read only after the event has completed, so a copy
    started before the next dispatch overlaps it."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def probe_device_count(timeout: float = 180.0) -> int | None:
    """Number of CUDA devices a fresh interpreter sees, counted in a
    subprocess that can be killed (a driver that hangs in its
    initialization blocks inside C++, where no signal handler runs), or
    None when the probe failed or timed out."""
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode == 0:
            return int(proc.stdout.strip().splitlines()[-1])
    except (subprocess.TimeoutExpired, ValueError, IndexError):
        pass
    return None
