"""Ops: resize and sampling, order statistics, the PointRend refine kernel
and the panoptic postprocess."""
