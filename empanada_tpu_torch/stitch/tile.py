"""Overlapping 2D tiles of a big image (counterpart of
``empanada_tpu/stitch/tile.py``).

Tiles have a fixed size and overlap by at least ``overlap_width``; their
origins are spread as evenly as possible, so no border tile is degenerate.
``overlap_rle`` is the flat RLE of every pixel that two or more tiles
cover: ``consensus.merge_objects_from_tiles`` drops a single-tile object
that lies mostly inside it.
"""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core.ranges import rle_voting
from empanada_tpu_torch.core.rle import merge_rles

__all__ = ["Tiler", "calculate_overlap_rle", "tile_ranges_1d"]


def tile_ranges_1d(length: int, tile: int, min_overlap: int):
    """(start, end) of the fewest tiles of size ``min(tile, length)`` that
    cover ``[0, length)`` with at least ``min_overlap`` overlap, their
    starts spread evenly from 0 to ``length - tile``."""
    tile = min(tile, length)
    if tile == length:
        return [(0, length)]
    if min_overlap >= tile:
        raise ValueError(f"overlap ({min_overlap}) must be smaller than the tile size "
                         f"({tile}): a tile could not advance")
    # n tiles cover n * tile - (n - 1) * overlap >= length
    n = max(int(np.ceil((length - min_overlap) / (tile - min_overlap))), 1)
    if n == 1:
        return [(0, tile)]
    step = (length - tile) / (n - 1)
    return [(int(round(i * step)), int(round(i * step)) + tile) for i in range(n)]


def calculate_overlap_rle(yranges, xranges, image_shape):
    """Flat RLE ``(starts, runs)`` of the pixels covered by two or more
    tiles: whole rows where tile rows overlap, plus columns where tile
    columns overlap."""
    h, w = image_shape
    y = rle_voting(np.unique(np.stack(yranges, axis=0), axis=0), vote_thr=2)
    x = rle_voting(np.unique(np.stack(xranges, axis=0), axis=0), vote_thr=2)
    row_starts = y[:, 0] * w if len(y) else []
    row_runs = y[:, 1] * w - row_starts if len(y) else []
    if len(x):
        col_ranges = np.concatenate([x + r * w for r in range(h)], axis=0)
        col_starts, col_runs = col_ranges[:, 0], col_ranges[:, 1] - col_ranges[:, 0]
    else:
        col_starts, col_runs = [], []
    if len(row_starts) or len(col_starts):
        return merge_rles(row_starts, row_runs, col_starts, col_runs)
    return [], []


class Tiler:
    """The tiles of an (H, W) image in row-major order: ``tiler(image, i)``
    is tile i, ``translate_rle_seg`` moves a tile's instances into the
    image's frame."""

    def __init__(self, image_shape, tile_size=2048, overlap_width=128):
        if isinstance(tile_size, int):
            tile_size = (tile_size, tile_size)
        if len(image_shape) != 2:
            raise ValueError(f"Tiler takes a 2D image shape, not {tuple(image_shape)}")
        self.image_shape = tuple(image_shape)
        self.tile_size = tile_size
        self.overlap_width = int(overlap_width)
        ys = tile_ranges_1d(image_shape[0], min(tile_size[0], image_shape[0]),
                            self.overlap_width)
        xs = tile_ranges_1d(image_shape[1], min(tile_size[1], image_shape[1]),
                            self.overlap_width)
        self.yranges = [y for y in ys for _ in xs]
        self.xranges = [x for _ in ys for x in xs]
        self.overlap_rle = calculate_overlap_rle(self.yranges, self.xranges,
                                                 self.image_shape)

    def __len__(self):
        return len(self.yranges)

    def overlap_mask(self) -> np.ndarray:
        overlap = np.zeros(int(np.prod(self.image_shape)))
        for s, r in zip(*self.overlap_rle):
            overlap[s:s + r] = 1
        return overlap.reshape(self.image_shape)

    @staticmethod
    def _split_runs_by_row(starts, runs, width):
        """Flat runs split at row ends, so each piece lies in one row of
        the tile (a run of a flat RLE may wrap rows)."""
        starts = np.asarray(starts, dtype=np.int64)
        runs = np.asarray(runs, dtype=np.int64)
        cols = starts % width
        n_rows = (cols + runs + width - 1) // width
        if (n_rows <= 1).all():
            return starts, runs
        out_s, out_r = [], []
        for s, n, c, k in zip(starts, runs, cols, n_rows):
            if k == 1:
                out_s.append(s)
                out_r.append(n)
                continue
            first = width - c
            out_s.append(s)
            out_r.append(first)
            pos, rem = s + first, n - first
            while rem > 0:
                piece = min(width, rem)
                out_s.append(pos)
                out_r.append(piece)
                pos += piece
                rem -= piece
        return np.array(out_s, dtype=np.int64), np.array(out_r, dtype=np.int64)

    def translate_rle_seg(self, rle_seg: dict, tile_index: int) -> dict:
        """Shift tile ``tile_index``'s boxes and RLEs into the image's
        frame, in place."""
        ys, _ = self.yranges[tile_index]
        xs, xe = self.xranges[tile_index]
        w = xe - xs
        for labels in rle_seg.values():
            for attrs in labels.values():
                y1, x1, y2, x2 = attrs["box"]
                attrs["box"] = (y1 + ys, x1 + xs, y2 + ys, x2 + xs)
                starts, runs = self._split_runs_by_row(attrs["starts"], attrs["runs"], w)
                attrs["starts"] = np.ravel_multi_index(
                    (starts // w + ys, starts % w + xs), dims=self.image_shape)
                attrs["runs"] = runs
        return rle_seg

    def __call__(self, image: np.ndarray, tile_index: int) -> np.ndarray:
        if tile_index >= len(self):
            raise IndexError("Tile index out of range")
        if image.shape[:2] != self.image_shape:
            raise ValueError(f"image shape {image.shape} does not match the tiler's "
                             f"{self.image_shape}")
        return image[slice(*self.yranges[tile_index]), slice(*self.xranges[tile_index])]
