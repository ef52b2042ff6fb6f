"""Utilities shared by the port's entry points (counterpart of
``empanada_tpu/utils/``): device resolution and probing, numerics
switches and asynchronous host copies (``devices``), tracing, stage
timing and device timing (``profiling``), progress lines (``progress``)."""

from empanada_tpu_torch.utils.devices import (
    fp32_strict,
    local_rank,
    probe_device_count,
    resolve_device,
    to_host_async,
)
from empanada_tpu_torch.utils.profiling import StageTimer, device_time, trace
from empanada_tpu_torch.utils.progress import Progress

__all__ = ["resolve_device", "local_rank", "fp32_strict", "to_host_async", "StageTimer",
           "Progress", "device_time", "trace", "probe_device_count"]
