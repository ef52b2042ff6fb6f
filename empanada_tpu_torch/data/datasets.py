"""Training datasets (counterpart of ``empanada_tpu/data/datasets.py``).

Directory layout: ``data_dir/<source>/images/*`` and
``data_dir/<source>/masks/*``, paired by sorted position.  Per-source
inverse-frequency^gamma sampling weights, dataset addition, and the three
dataset flavours: multiclass panoptic, single instance class and
boundary-contour.  Files are read by ``data.imread.imread_gray`` (PNG and
uncompressed TIFF, without cv2 or PIL).

Batches are numpy dicts with channel-last targets (the train step's
contract: image (B, H, W, 1), sem (B, H, W), ctr_hmp (B, H, W, 1),
offsets (B, H, W, 2)); ``WeightedBatchLoader`` draws them with the JAX
package's numpy draws, with an optional shard slice of the sample stream.
"""

from __future__ import annotations

import os
from copy import deepcopy
from glob import glob

import numpy as np

from empanada_tpu_torch.data.imread import imread_gray
from empanada_tpu_torch.data.targets import heatmap_and_offsets, seg_to_instance_bd

__all__ = [
    "BaseDataset",
    "PanopticDataset",
    "SingleClassInstanceDataset",
    "BCDataset",
    "WeightedBatchLoader",
    "DATASET_REGISTRY",
    "create_dataset",
]


class BaseDataset:
    """Directory-of-subdirs dataset with per-source sampling weights."""

    def __init__(self, data_dir, transforms=None, weight_gamma=None):
        self.data_dir = data_dir
        self.subdirs = sorted(
            sd for sd in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, sd))
        )
        self.impaths_dict = {}
        self.mskpaths_dict = {}
        for sd in self.subdirs:
            imgs = sorted(glob(os.path.join(data_dir, sd, "images", "*")))
            msks = sorted(glob(os.path.join(data_dir, sd, "masks", "*")))
            # images/masks pair by sorted position: a single missing file
            # would silently shift every later pairing (and with multiple
            # sources even total lengths can still match), so fail loudly
            if len(imgs) != len(msks):
                raise ValueError(
                    f"{os.path.join(data_dir, sd)}: {len(imgs)} images but "
                    f"{len(msks)} masks — every images/ file needs a "
                    "matching masks/ file"
                )
            if not imgs:
                raise ValueError(
                    f"{os.path.join(data_dir, sd)}: contains no images — "
                    "remove the empty source dir or add images/ + masks/"
                )
            self.impaths_dict[sd] = imgs
            self.mskpaths_dict[sd] = msks

        self.weight_gamma = weight_gamma
        self.weights = (
            self._example_weights(self.impaths_dict, gamma=weight_gamma)
            if weight_gamma is not None
            else None
        )
        self._unpack()
        self.transforms = transforms

    def _unpack(self):
        self.impaths = [p for paths in self.impaths_dict.values() for p in paths]
        self.mskpaths = [p for paths in self.mskpaths_dict.values() for p in paths]

    def __len__(self):
        return len(self.impaths)

    def __add__(self, other):
        merged = deepcopy(self)
        for sd in other.impaths_dict:
            if sd in merged.impaths_dict:
                merged.impaths_dict[sd] += other.impaths_dict[sd]
                merged.mskpaths_dict[sd] += other.mskpaths_dict[sd]
            else:
                merged.impaths_dict[sd] = other.impaths_dict[sd]
                merged.mskpaths_dict[sd] = other.mskpaths_dict[sd]
        if merged.weight_gamma is not None:
            merged.weights = self._example_weights(merged.impaths_dict, merged.weight_gamma)
        merged._unpack()
        return merged

    @staticmethod
    def _example_weights(paths_dict, gamma=0.3):
        """Inverse-frequency^gamma weights per example, normalized per source."""
        counts = np.array([len(paths) for paths in paths_dict.values()], dtype=float)
        weights = (1.0 / counts) ** gamma
        weights /= weights.sum()
        example_weights = []
        for w, c in zip(weights, counts.astype(int)):
            example_weights.extend([w] * c)
        return np.array(example_weights)

    def _load_pair(self, idx):
        image = imread_gray(self.impaths[idx])
        mask = imread_gray(self.mskpaths[idx]).astype(np.int64)
        if self.transforms is not None:
            out = self.transforms(image=image, mask=mask)
            return out["image"], out["mask"]
        return image, mask

    def __getitem__(self, idx):
        raise NotImplementedError


class PanopticDataset(BaseDataset):
    """Multiclass: the mask encodes class_id * label_divisor + instance."""

    def __init__(
        self, data_dir, labels, thing_list, label_divisor,
        transforms=None, heatmap_sigma=6, weight_gamma=0.3,
    ):
        super().__init__(data_dir, transforms, weight_gamma)
        assert len(labels) > 1, (
            "Must be more than 1 label class! Use SingleClassInstanceDataset instead."
        )
        assert all(l > 0 for l in labels), "Labels must be positive non-zero integers!"
        self.labels = labels
        self.thing_list = thing_list
        self.label_divisor = label_divisor
        self.heatmap_sigma = heatmap_sigma

    def __getitem__(self, idx):
        image, mask = self._load_pair(idx)

        sem_seg = np.zeros_like(mask)
        thing_seg = np.zeros_like(mask)
        for class_id in self.labels:
            min_id = class_id * self.label_divisor
            max_id = min_id + self.label_divisor
            inside = (mask >= min_id) & (mask < max_id)
            sem_seg[inside] = class_id
            if class_id in self.thing_list:
                thing_seg[inside] = mask[inside]

        heatmap, offsets = heatmap_and_offsets(thing_seg, self.heatmap_sigma)
        return {
            "image": np.asarray(image, np.float32)[..., None],
            "sem": sem_seg.astype(np.int32),
            "ctr_hmp": heatmap,
            "offsets": offsets,
        }


class SingleClassInstanceDataset(BaseDataset):
    """Single instance class: any nonzero mask value is an instance."""

    def __init__(self, data_dir, transforms=None, heatmap_sigma=6, weight_gamma=0.3, **kwargs):
        super().__init__(data_dir, transforms, weight_gamma)
        self.heatmap_sigma = heatmap_sigma

    def __getitem__(self, idx):
        image, mask = self._load_pair(idx)
        heatmap, offsets = heatmap_and_offsets(mask, self.heatmap_sigma)
        return {
            "image": np.asarray(image, np.float32)[..., None],
            "sem": (mask > 0).astype(np.int32),
            "ctr_hmp": heatmap,
            "offsets": offsets,
        }


class BCDataset(BaseDataset):
    """Boundary-contour targets from Sobel contours."""

    def __init__(self, data_dir, transforms=None, weight_gamma=0.3, tsz_h=1, **kwargs):
        super().__init__(data_dir, transforms, weight_gamma)
        self.tsz_h = tsz_h

    def __getitem__(self, idx):
        image, mask = self._load_pair(idx)
        cnt = seg_to_instance_bd(mask[None], tsz_h=self.tsz_h)[0]
        return {
            "image": np.asarray(image, np.float32)[..., None],
            "sem": (mask > 0).astype(np.int32),
            "cnt": cnt.astype(np.int32),
        }


class WeightedBatchLoader:
    """Weighted random batch sampler over a dataset.

    With ``shard``/``num_shards`` each process draws a disjoint slice of
    the sample stream.  ``rng`` carries on from epoch to epoch (a resumed
    run restores its state, ``state_dict``/``load_state_dict``).
    """

    def __init__(
        self, dataset, batch_size: int, seed: int = 0,
        shard: int = 0, num_shards: int = 1, drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shard = shard
        self.num_shards = num_shards
        self.drop_last = drop_last

    def state_dict(self) -> dict:
        return self.rng.bit_generator.state

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _sample_indices(self):
        n = len(self.dataset)
        weights = getattr(self.dataset, "weights", None)
        if weights is not None:
            p = np.asarray(weights, float)
            p = p / p.sum()
            idx = self.rng.choice(n, size=n, replace=True, p=p)
        else:
            idx = self.rng.permutation(n)
        # equal shard lengths (the remainder dropped): every process
        # iterates the same number of batches, __len__'s n // num_shards
        n_even = (n // self.num_shards) * self.num_shards
        return idx[:n_even][self.shard :: self.num_shards]

    def __iter__(self):
        idx = self._sample_indices()
        for start in range(0, len(idx) - (self.batch_size - 1 if self.drop_last else 0), self.batch_size):
            items = [self.dataset[int(i)] for i in idx[start : start + self.batch_size]]
            if not items:
                return
            batch = {
                k: np.stack([item[k] for item in items]) for k in items[0]
            }
            yield batch


DATASET_REGISTRY = {
    "PanopticDataset": PanopticDataset,
    "SingleClassInstanceDataset": SingleClassInstanceDataset,
    "BCDataset": BCDataset,
}


def create_dataset(name: str, *args, **kwargs):
    return DATASET_REGISTRY[name](*args, **kwargs)
