"""Patch and flipbook picking and dataset storage (counterpart of
``empanada_tpu/curation/patches.py``): random or point-centred 2D patches
and 5-slice "flipbooks" (isotropic picks from xy, xz and yz too), stored as
TIFFs in the ``<save_dir>/<prefix>/images|masks`` layout that the training
datasets read.  File names carry the source location
(``-LOC-{axis}_{plane}_{y}-{x}``).
"""

from __future__ import annotations

import os

import numpy as np

from empanada_tpu_torch.data.imwrite import imwrite

__all__ = [
    "pick_patches_2d",
    "pick_flipbooks",
    "store_dataset",
    "patch_boxes_from_points",
]

FLIPBOOK_DEPTH = 5


def patch_boxes_from_points(points, tile_width: int) -> list[np.ndarray]:
    """Rectangle corners of the patch each point would pick: a point's last
    two coordinates are the patch centre, leading ones (z, time, ...) are
    carried onto every corner.  Returns (4, ndim) float arrays ordered
    top-left, top-right, bottom-right, bottom-left (a napari Shapes
    layer's data)."""
    out = []
    for point in np.atleast_2d(np.asarray(points, dtype=float)):
        y, x = point[-2], point[-1]
        half = tile_width / 2
        y1, x1 = int(y - half), int(x - half)
        y2, x2 = int(y + half), int(x + half)
        corners = [(y1, x1), (y1, x2), (y2, x2), (y2, x1)]
        lead = list(point[:-2])
        out.append(np.asarray([lead + list(c) for c in corners], dtype=float))
    return out


def _crop_at(volume2d: np.ndarray, cy: int, cx: int, size: int):
    h, w = volume2d.shape[:2]
    y0 = int(np.clip(cy - size // 2, 0, max(0, h - size)))
    x0 = int(np.clip(cx - size // 2, 0, max(0, w - size)))
    return volume2d[y0 : y0 + size, x0 : x0 + size], (y0, x0)


def pick_patches_2d(
    image: np.ndarray,
    points=None,
    n_patches: int = 4,
    patch_size: int = 256,
    labels: np.ndarray | None = None,
    seed: int = 0,
    axis_name: str = "xy",
    plane: int = 0,
):
    """Pick 2D patches, random or centered at points.

    Returns list of dicts {image, mask (optional), suffix}.
    """
    rng = np.random.default_rng(seed)
    h, w = image.shape[:2]
    out = []

    if points is None:
        centers = [
            (int(rng.integers(0, h)), int(rng.integers(0, w))) for _ in range(n_patches)
        ]
    else:
        centers = [(int(p[-2]), int(p[-1])) for p in points]

    for cy, cx in centers:
        patch, (y0, x0) = _crop_at(image, cy, cx, patch_size)
        rec = {
            "image": patch,
            "suffix": f"-LOC-{axis_name}_{plane}_{y0}-{x0}",
        }
        if labels is not None:
            rec["mask"] = _crop_at(labels, cy, cx, patch_size)[0]
        out.append(rec)
    return out


def pick_flipbooks(
    volume: np.ndarray,
    points=None,
    n_flipbooks: int = 4,
    patch_size: int = 256,
    labels: np.ndarray | None = None,
    isotropic: bool = False,
    seed: int = 0,
):
    """Pick 5-slice flipbooks (the middle slice is the one to annotate);
    with ``isotropic`` from the xy, xz and yz orientations."""
    rng = np.random.default_rng(seed)
    axes = [0, 1, 2] if isotropic else [0]
    axis_names = {0: "xy", 1: "xz", 2: "yz"}
    out = []

    if points is not None:
        picks = [(0, tuple(int(c) for c in p)) for p in points]
    else:
        picks = []
        for _ in range(n_flipbooks):
            axis = int(rng.choice(axes))
            coord = tuple(int(rng.integers(0, s)) for s in volume.shape)
            picks.append((axis, coord))

    for axis, coord in picks:
        depth = volume.shape[axis]
        if depth < FLIPBOOK_DEPTH:
            raise ValueError(
                f"volume is only {depth} deep along axis {axis}; flipbooks "
                f"need >= {FLIPBOOK_DEPTH} slices"
            )
        mid = int(np.clip(coord[axis], FLIPBOOK_DEPTH // 2, depth - 1 - FLIPBOOK_DEPTH // 2))
        sel = [slice(None)] * 3
        sel[axis] = slice(mid - FLIPBOOK_DEPTH // 2, mid + FLIPBOOK_DEPTH // 2 + 1)
        sub = np.moveaxis(volume[tuple(sel)], axis, 0)

        plane_axes = [i for i in range(3) if i != axis]
        cy, cx = coord[plane_axes[0]], coord[plane_axes[1]]
        fb = np.stack([_crop_at(sl, cy, cx, patch_size)[0] for sl in sub])
        y0, x0 = _crop_at(sub[0], cy, cx, patch_size)[1]
        rec = {
            "image": fb,
            "suffix": f"-LOC-{axis_names[axis]}_{mid}_{y0}-{x0}",
        }
        if labels is not None:
            lsub = np.moveaxis(labels[tuple(sel)], axis, 0)
            rec["mask"] = np.stack([_crop_at(sl, cy, cx, patch_size)[0] for sl in lsub])
        out.append(rec)
    return out


def store_dataset(save_dir: str, prefix: str, patches, start_index: int = 0) -> int:
    """Write picked patches as ``save_dir/<prefix>/images|masks`` TIFFs
    (masks as int32 unless uint8, uint16 or int32).  Returns the number
    written."""
    img_dir = os.path.join(save_dir, prefix, "images")
    msk_dir = os.path.join(save_dir, prefix, "masks")
    os.makedirs(img_dir, exist_ok=True)
    n = 0
    for i, rec in enumerate(patches, start=start_index):
        name = f"{prefix}_{i:05d}{rec.get('suffix', '')}.tiff"
        imwrite(os.path.join(img_dir, name), rec["image"])
        if "mask" in rec and rec["mask"] is not None:
            os.makedirs(msk_dir, exist_ok=True)
            mask = rec["mask"]
            if mask.dtype not in (np.uint8, np.uint16, np.int32):
                mask = mask.astype(np.int32)
            imwrite(os.path.join(msk_dir, name), mask)
        n += 1
    return n
