"""Host array and RLE layer of the 3D path (counterpart of
``empanada_tpu/core``): run extraction and connected components over runs,
the flat instance form, RLE and range algebra, and the native library's
bindings (``native.py``)."""

from empanada_tpu_torch.core.boxes import (
    box_area,
    box_intersection,
    box_iou,
    merge_boxes,
    overlapping_box_pairs,
)
from empanada_tpu_torch.core.labeling import (
    connected_components_runs,
    extract_runs,
    label_2d,
    runs_to_regions,
)
from empanada_tpu_torch.core.masks import crop_and_binarize, mask_ioa, mask_iou, put, take
from empanada_tpu_torch.core.ranges import (
    concat_sort_ranges,
    coverage_ranges,
    intersection_from_ranges,
    invert_ranges,
    join_ranges,
    ranges_to_rle,
    rle_to_ranges,
    rle_voting,
    vote_by_ranges,
)
from empanada_tpu_torch.core.rle import (
    merge_rles,
    numpy_fill_instances,
    rle_area,
    rle_decode,
    rle_encode,
    rle_intersection,
    rle_ioa,
    rle_iou,
    rle_to_string,
    string_to_rle,
)

__all__ = [
    "box_area", "box_intersection", "box_iou", "merge_boxes", "overlapping_box_pairs",
    "connected_components_runs", "extract_runs", "label_2d", "runs_to_regions",
    "crop_and_binarize", "mask_ioa", "mask_iou", "put", "take",
    "concat_sort_ranges", "coverage_ranges", "intersection_from_ranges", "invert_ranges",
    "join_ranges", "ranges_to_rle", "rle_to_ranges", "rle_voting", "vote_by_ranges",
    "merge_rles", "numpy_fill_instances", "rle_area", "rle_decode", "rle_encode",
    "rle_intersection", "rle_ioa", "rle_iou", "rle_to_string", "string_to_rle",
]
