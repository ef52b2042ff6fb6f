"""Inference engines."""

from empanada_tpu_torch.engine.engines import (
    MedianQueue,
    PanopticDeepLabRenderEngine,
    PanopticDeepLabRenderEngine3d,
)

__all__ = ["MedianQueue", "PanopticDeepLabRenderEngine", "PanopticDeepLabRenderEngine3d"]
