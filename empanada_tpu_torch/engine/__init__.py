"""Inference engines."""

from empanada_tpu_torch.engine.engines import (
    BCEngine,
    BCEngine3d,
    MedianQueue,
    PanopticDeepLabEngine,
    PanopticDeepLabEngine3d,
    PanopticDeepLabRenderEngine,
    PanopticDeepLabRenderEngine3d,
)

__all__ = ["BCEngine", "BCEngine3d", "MedianQueue", "PanopticDeepLabEngine",
           "PanopticDeepLabEngine3d", "PanopticDeepLabRenderEngine",
           "PanopticDeepLabRenderEngine3d"]
