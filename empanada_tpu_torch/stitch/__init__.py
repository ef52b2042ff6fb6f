"""Host stitching layer (counterpart of ``empanada_tpu/stitch``): per-slice
instance records, cross-slice matching, 3D tracking, filters, the
ortho-plane and tile consensus, the tiler, and the BC watershed."""

from empanada_tpu_torch.stitch.consensus import (
    merge_objects_from_tiles,
    merge_objects_from_trackers,
    merge_semantic_from_tiles,
    merge_semantic_from_trackers,
)
from empanada_tpu_torch.stitch.matcher import RLEMatcher, fast_matcher, rle_matcher
from empanada_tpu_torch.stitch.rle_seg import (
    pan_seg_to_rle_seg,
    rle_seg_to_pan_seg,
    unpack_rle_attrs,
)
from empanada_tpu_torch.stitch.tile import Tiler
from empanada_tpu_torch.stitch.tracker import InstanceTracker
from empanada_tpu_torch.stitch.watershed import bc_watershed

__all__ = [
    "merge_objects_from_tiles", "merge_objects_from_trackers", "merge_semantic_from_tiles",
    "merge_semantic_from_trackers", "RLEMatcher", "fast_matcher", "rle_matcher",
    "pan_seg_to_rle_seg", "rle_seg_to_pan_seg", "unpack_rle_attrs", "Tiler",
    "InstanceTracker", "bc_watershed",
]
