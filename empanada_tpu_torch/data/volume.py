"""Volume slicing dataset + pad helper (counterpart of
``empanada_tpu/data/volume.py``).

Slices are taken along an axis of a numpy array (or any array-like with
numpy-style indexing) and normalised by the given preprocessor.  The JAX
package downsamples by a power-of-two ``scale`` with cv2's bilinear resize;
the port does not depend on cv2, so a scale above 1 raises here.
"""

from __future__ import annotations

import math

import numpy as np

from empanada_tpu_torch.core.masks import take

__all__ = ["resize_by_factor", "factor_pad_numpy", "VolumeDataset"]


def resize_by_factor(image: np.ndarray, scale_factor: int = 1) -> np.ndarray:
    """Identity at scale 1; the bilinear downsample of a larger scale (cv2's
    in the JAX package) is not ported yet and raises."""
    if scale_factor == 1:
        return image
    raise NotImplementedError(
        f"inference_scale {scale_factor} > 1 needs the bilinear downsample, "
        "which the port does not have yet (it does not depend on cv2)")


def factor_pad_numpy(image: np.ndarray, factor: int = 128) -> np.ndarray:
    """Bottom/right zero pad to a multiple of factor (transforms.py:23)."""
    h, w = image.shape[:2]
    pad_bottom = (-h) % factor
    pad_right = (-w) % factor
    if image.ndim == 3:
        padding = ((0, pad_bottom), (0, pad_right), (0, 0))
    elif image.ndim == 2:
        padding = ((0, pad_bottom), (0, pad_right))
    else:
        raise Exception(f"unsupported ndim {image.ndim}")
    return np.pad(image, padding)


class VolumeDataset:
    """Iterable of {'index', 'image', 'size'} slices along an axis."""

    def __init__(self, array, axis: int = 0, tfs=None, scale: int = 1,
                 start: int = 0):
        if not math.log2(scale).is_integer():
            raise Exception(f"Image rescaling must be log base 2, got {scale}")
        self.array = array
        self.axis = axis
        self.tfs = tfs
        self.scale = scale
        # first slice index the iteration yields
        self.start = start

    def __len__(self):
        return self.array.shape[self.axis]

    def __getitem__(self, idx: int) -> dict:
        image = np.asarray(take(self.array, idx, self.axis))
        h, w = image.shape
        image = resize_by_factor(image, self.scale)
        assert (image.shape[0] * self.scale) >= h
        assert (image.shape[1] * self.scale) >= w
        if self.tfs is not None:
            image = self.tfs(image=image)["image"]
        return {"index": idx, "image": image, "size": (h, w)}

    def __iter__(self):
        for idx in range(self.start, len(self)):
            yield self[idx]
