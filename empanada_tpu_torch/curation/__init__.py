"""Label curation without a GUI (counterpart of ``empanada_tpu/curation``):
merge, split, morphology and delete, filters, counting, patch picking,
offline tiling, export and accuracy."""

from empanada_tpu_torch.curation.accuracy import (
    compute_instance_metrics,
    compute_pixel_metrics,
)
from empanada_tpu_torch.curation.count import count_labels, save_label_lists
from empanada_tpu_torch.curation.export import export_segmentations
from empanada_tpu_torch.curation.filters import (
    apply_label_filter,
    filter_out_small_label_areas,
    remove_boundary_labels,
)
from empanada_tpu_torch.curation.ops import (
    delete_labels,
    find_next_available_label,
    jump_to_label,
    labels_at_points,
    line_to_indices,
    merge_labels,
    morph_labels,
    split_labels,
)
from empanada_tpu_torch.curation.patches import (
    patch_boxes_from_points,
    pick_flipbooks,
    pick_patches_2d,
    store_dataset,
)
from empanada_tpu_torch.curation.tiles import chop_into_tiles, merge_tiles

__all__ = [
    "compute_instance_metrics", "compute_pixel_metrics",
    "count_labels", "save_label_lists", "export_segmentations",
    "apply_label_filter", "filter_out_small_label_areas", "remove_boundary_labels",
    "delete_labels", "find_next_available_label", "jump_to_label",
    "labels_at_points", "line_to_indices", "merge_labels", "morph_labels",
    "split_labels", "pick_flipbooks", "pick_patches_2d", "store_dataset",
    "patch_boxes_from_points",
    "chop_into_tiles", "merge_tiles",
]
