"""Half-open index-range algebra for run-length encoded segmentations
(counterpart of ``empanada_tpu/core/ranges.py``, in numpy only: the port's
matcher reaches it only on its numpy path).

A "range" is a pair ``[start, end)`` of flat voxel indices; an instance mask is
a sorted array of non-overlapping ranges of shape ``(n, 2)``.  Union (join)
and pairwise intersection are what the matcher needs.

Coverage counts come from one sort + cumsum over (start, +1)/(end, -1)
events, which is exact and O(n log n).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "ranges_to_rle",
    "concat_sort_ranges",
    "join_ranges",
    "intersection_from_ranges",
    "coverage_ranges",
]

_EMPTY = np.empty((0, 2), dtype=np.int64)


def ranges_to_rle(ranges: np.ndarray) -> np.ndarray:
    """Convert an ``(n, 2)`` array of (start, end) ranges to (start, run) pairs."""
    ranges = np.asarray(ranges).copy()
    ranges[:, 1] = ranges[:, 1] - ranges[:, 0]
    return ranges


def concat_sort_ranges(list_of_ranges) -> np.ndarray:
    """Concatenate a list of range arrays and stable-sort by start index."""
    list_of_ranges = [np.asarray(r).reshape(-1, 2) for r in list_of_ranges if len(r) > 0]
    if not list_of_ranges:
        return _EMPTY.copy()
    ranges = np.concatenate(list_of_ranges, axis=0)
    order = np.argsort(ranges[:, 0], kind="stable")
    return ranges[order]


def _merge_touching(starts: np.ndarray, ends: np.ndarray, merge_adjacent: bool = True):
    """Merge sorted, possibly overlapping/touching ranges into disjoint ones."""
    if len(starts) == 0:
        return _EMPTY.copy()
    # cumulative max of ends tells us how far coverage extends so far
    cummax_ends = np.maximum.accumulate(ends)
    if merge_adjacent:
        new_group = starts[1:] > cummax_ends[:-1]
    else:
        new_group = starts[1:] >= cummax_ends[:-1]
    # group id per range; segment boundaries where a gap occurs
    group_start_idx = np.flatnonzero(np.concatenate([[True], new_group]))
    out_starts = starts[group_start_idx]
    out_ends = np.maximum.reduceat(ends, group_start_idx)
    return np.stack([out_starts, out_ends], axis=1).astype(np.int64)


def join_ranges(list_of_ranges) -> np.ndarray:
    """Union of possibly-overlapping ranges into sorted disjoint ranges.

    Adjacent ranges ([a,b) followed by [b,c)) are merged, matching the
    reference's ``_join_ranges`` (which merges when ``end >= next_start``).
    """
    if isinstance(list_of_ranges, np.ndarray) and list_of_ranges.ndim == 2:
        list_of_ranges = [list_of_ranges]
    list_of_ranges = [np.asarray(r).reshape(-1, 2) for r in list_of_ranges]

    ranges = concat_sort_ranges(list_of_ranges)
    if len(ranges) == 0:
        return _EMPTY.copy()
    return _merge_touching(ranges[:, 0], ranges[:, 1], merge_adjacent=True)


def coverage_ranges(list_of_ranges, min_count: int) -> np.ndarray:
    """Ranges of indices covered by at least ``min_count`` input ranges.

    Event-sweep: +1 at each start, -1 at each end, prefix-sum over the sorted
    breakpoints; emit the intervals whose running coverage >= min_count and
    merge the touching ones.
    """
    if isinstance(list_of_ranges, np.ndarray) and list_of_ranges.ndim == 2:
        list_of_ranges = [list_of_ranges]
    list_of_ranges = [np.asarray(r).reshape(-1, 2) for r in list_of_ranges]

    ranges = concat_sort_ranges(list_of_ranges)
    if len(ranges) == 0:
        return _EMPTY.copy()

    points = np.concatenate([ranges[:, 0], ranges[:, 1]])
    deltas = np.concatenate(
        [np.ones(len(ranges), dtype=np.int64), -np.ones(len(ranges), dtype=np.int64)]
    )
    order = np.argsort(points, kind="stable")
    points = points[order]
    deltas = deltas[order]

    # collapse duplicate breakpoints so coverage is per unique position
    uniq_points, first_idx = np.unique(points, return_index=True)
    # sum deltas per unique point
    summed = np.add.reduceat(deltas, first_idx)
    coverage = np.cumsum(summed)  # coverage on [uniq_points[i], uniq_points[i+1])

    ok = coverage[:-1] >= min_count
    if not ok.any():
        return _EMPTY.copy()
    seg_starts = uniq_points[:-1][ok]
    seg_ends = uniq_points[1:][ok]
    return _merge_touching(seg_starts, seg_ends, merge_adjacent=True)


def intersection_from_ranges(ranges_a: np.ndarray, ranges_b: np.ndarray) -> int:
    """Total overlap (in indices) between two disjoint-sorted range sets.

    Each set must be internally non-overlapping (true for any valid RLE), so
    the overlap equals the measure of coverage >= 2 in the union of events.
    Replaces the reference's sequential numba scan (array_utils.py:344).
    """
    ranges_a = np.asarray(ranges_a).reshape(-1, 2)
    ranges_b = np.asarray(ranges_b).reshape(-1, 2)
    if len(ranges_a) == 0 or len(ranges_b) == 0:
        return 0
    covered = coverage_ranges([ranges_a, ranges_b], 2)
    if len(covered) == 0:
        return 0
    return int((covered[:, 1] - covered[:, 0]).sum())
