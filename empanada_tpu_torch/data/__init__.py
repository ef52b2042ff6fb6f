"""Data layer (counterpart of ``empanada_tpu/data``): volume slicing and
the scale-down, the training datasets and loader, their targets and
augmentations."""

from empanada_tpu_torch.data.augment import AUGMENTATIONS, Compose, create_augmentations
from empanada_tpu_torch.data.datasets import (
    BaseDataset,
    BCDataset,
    PanopticDataset,
    SingleClassInstanceDataset,
    WeightedBatchLoader,
    create_dataset,
)
from empanada_tpu_torch.data.targets import heatmap_and_offsets, seg_to_instance_bd
from empanada_tpu_torch.data.volume import VolumeDataset, factor_pad_numpy, resize_by_factor

__all__ = [
    "VolumeDataset", "factor_pad_numpy", "resize_by_factor",
    "AUGMENTATIONS", "Compose", "create_augmentations",
    "BaseDataset", "BCDataset", "PanopticDataset", "SingleClassInstanceDataset",
    "WeightedBatchLoader", "create_dataset",
    "heatmap_and_offsets", "seg_to_instance_bd",
]
