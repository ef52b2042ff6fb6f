"""Ops: resize and sampling, order statistics, the PointRend refine kernel
and the panoptic postprocess."""

from empanada_tpu_torch.ops.interpolate import (
    bilinear_resize,
    grid_sample,
    nearest_resize,
    point_sample,
)

__all__ = ["bilinear_resize", "grid_sample", "nearest_resize", "point_sample"]
