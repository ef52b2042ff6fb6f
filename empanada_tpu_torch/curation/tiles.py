"""Offline big-image tiling to disk and its inverse (counterpart of
``empanada_tpu/curation/tiles.py``): chop a large 2D image (and a mask)
into zero-padded ``patch_size``² TIFF tiles with a ``metadata.json``
sidecar, and stitch tiles back.  ``.npy`` inputs are read through a
memmap, PNG, TIFF, JPEG, BMP, PNM, GIF, SPIDER, TGA and Sun raster ones
by ``data.imread.imread`` (every form it and ``data/raster.py`` read)."""

from __future__ import annotations

import json
import os

import numpy as np

from empanada_tpu_torch.data.imread import imread
from empanada_tpu_torch.data.imwrite import imwrite

__all__ = ["chop_into_tiles", "merge_tiles"]


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    return imread(path)


def chop_into_tiles(image_path: str, save_directory: str, patch_size: int = 2048,
                    mask_path: str | None = None) -> dict:
    """Chop a 2D image into padded patch_size tiles under
    ``save_directory/im`` (and ``/msk``), writing ``metadata.json``."""
    im = _load_image(image_path)
    if im.ndim != 2:
        raise ValueError(f"{image_path}: a 2D (height x width) image, not {im.shape}")
    original_shape = tuple(int(s) for s in im.shape)

    pad_h = (-original_shape[0]) % patch_size
    pad_w = (-original_shape[1]) % patch_size
    padded_shape = (original_shape[0] + pad_h, original_shape[1] + pad_w)

    msk = None
    if mask_path is not None:
        if not os.path.exists(mask_path):
            raise FileNotFoundError(
                f"mask file {mask_path!r} does not exist (an explicitly "
                "provided mask must be loadable — a typo here would "
                "silently chop without masks)"
            )
        msk = _load_image(mask_path)
        if msk.shape != im.shape:
            raise ValueError(f"mask {msk.shape} and image {im.shape} differ in shape")

    im_dir = os.path.join(save_directory, "im")
    os.makedirs(im_dir, exist_ok=True)
    if msk is not None:
        msk_dir = os.path.join(save_directory, "msk")
        os.makedirs(msk_dir, exist_ok=True)

    ny = padded_shape[0] // patch_size
    nx = padded_shape[1] // patch_size
    for iy in range(ny):
        for ix in range(nx):
            y0, x0 = iy * patch_size, ix * patch_size
            tile = np.zeros((patch_size, patch_size), dtype=im.dtype)
            ys = min(patch_size, original_shape[0] - y0)
            xs = min(patch_size, original_shape[1] - x0)
            if ys > 0 and xs > 0:
                tile[:ys, :xs] = im[y0 : y0 + ys, x0 : x0 + xs]
            imwrite(os.path.join(im_dir, f"tile_{iy:04d}_{ix:04d}.tiff"), tile)
            if msk is not None:
                mtile = np.zeros((patch_size, patch_size), dtype=msk.dtype)
                if ys > 0 and xs > 0:
                    mtile[:ys, :xs] = msk[y0 : y0 + ys, x0 : x0 + xs]
                imwrite(os.path.join(msk_dir, f"tile_{iy:04d}_{ix:04d}.tiff"), mtile)

    metadata = {
        "original_image_shape": list(original_shape),
        "padded_image_shape": list(padded_shape),
        "patch_size": patch_size,
        "mask_available": msk is not None,
    }
    with open(os.path.join(save_directory, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    return metadata


def merge_tiles(patch_directory: str, save_directory: str) -> dict:
    """Inverse of chop_into_tiles: stitch ``im`` (and ``msk``) tiles back to
    the original shape and save merged tiffs."""
    with open(os.path.join(patch_directory, "metadata.json")) as f:
        metadata = json.load(f)
    original_shape = tuple(metadata["original_image_shape"])
    padded_shape = tuple(metadata["padded_image_shape"])
    patch_size = metadata["patch_size"]
    ny = padded_shape[0] // patch_size
    nx = padded_shape[1] // patch_size

    os.makedirs(save_directory, exist_ok=True)
    out_paths = {}
    for sub, out_name in (("im", "merged_image.tiff"), ("msk", "merged_mask.tiff")):
        d = os.path.join(patch_directory, sub)
        if not os.path.isdir(d):
            continue
        files = sorted(f for f in os.listdir(d) if f.lower().endswith((".tif", ".tiff")))
        if not files:
            raise FileNotFoundError(f"no tiff tiles in {d!r} — nothing to merge")
        if len(files) != ny * nx:
            raise ValueError(
                f"{d!r} holds {len(files)} tiles but the metadata grid is "
                f"{ny}x{nx} = {ny * nx} — refusing a partial merge"
            )
        first = imread(os.path.join(d, files[0]))
        merged = np.zeros(padded_shape, dtype=first.dtype)
        for fn in files:
            stem = os.path.splitext(fn)[0]
            _, iy, ix = stem.rsplit("_", 2)
            y0, x0 = int(iy) * patch_size, int(ix) * patch_size
            merged[y0 : y0 + patch_size, x0 : x0 + patch_size] = imread(os.path.join(d, fn))
        merged = merged[: original_shape[0], : original_shape[1]]
        out = os.path.join(save_directory, out_name)
        imwrite(out, merged)
        out_paths[sub] = out
    return out_paths
