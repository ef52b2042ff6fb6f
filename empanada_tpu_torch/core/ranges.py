"""Half-open index-range algebra for run-length encoded segmentations
(counterpart of ``empanada_tpu/core/ranges.py``).

A "range" is a pair ``[start, end)`` of flat voxel indices; an instance mask is
a sorted array of non-overlapping ranges of shape ``(n, 2)``.  Union (join),
pairwise intersection and the k-of-n pixel vote of the ortho-plane consensus
are built here.

Union and coverage go through the native event sweep (``native.vote_ranges``,
or the sort-free k-way merge ``native.vote_sorted_sets`` for at most 64 sets
that are each sorted and disjoint); with ``native.use_native`` off, the
matcher's numpy path takes one sort + cumsum over (start, +1)/(end, -1)
events.  The vote (``vote_by_ranges``, ``rle_voting``) is native only.
"""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core import native

__all__ = [
    "rle_to_ranges",
    "ranges_to_rle",
    "invert_ranges",
    "concat_sort_ranges",
    "join_ranges",
    "intersection_from_ranges",
    "coverage_ranges",
    "rle_voting",
    "vote_by_ranges",
]

# sets of sorted disjoint ranges up to this many take the k-way merge
_MAX_SORTED_SETS = 64

_EMPTY = np.empty((0, 2), dtype=np.int64)


def rle_to_ranges(rle: np.ndarray) -> np.ndarray:
    """Convert an ``(n, 2)`` array of (start, run) pairs to (start, end) ranges."""
    return np.cumsum(np.asarray(rle), axis=1)


def invert_ranges(ranges: np.ndarray, size: int) -> np.ndarray:
    """Complement of sorted disjoint ranges within ``[0, size)``."""
    ranges = np.asarray(ranges).reshape(-1, 2)
    if len(ranges) == 0:
        return np.array([[0, size]], dtype=np.int64)
    gap_starts = np.concatenate([[0], ranges[:, 1]])
    gap_ends = np.concatenate([ranges[:, 0], [size]])
    keep = gap_starts < gap_ends
    return np.stack([gap_starts[keep], gap_ends[keep]], axis=1).astype(np.int64)


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


def _sorted_disjoint(r: np.ndarray) -> bool:
    return len(r) < 2 or bool(np.all(r[1:, 0] >= r[:-1, 1]))


def _native_vote(list_of_ranges, min_count: int) -> np.ndarray:
    """Coverage >= ``min_count`` of the non-empty sets, natively."""
    arrs = [r for r in list_of_ranges if len(r) > 0]
    if not arrs:
        return _EMPTY.copy()
    if len(arrs) <= _MAX_SORTED_SETS and all(map(_sorted_disjoint, arrs)):
        return native.vote_sorted_sets(arrs, min_count)
    return native.vote_ranges(arrs[0] if len(arrs) == 1 else np.concatenate(arrs),
                              min_count)


def join_ranges(list_of_ranges) -> np.ndarray:
    """Union of possibly-overlapping ranges into sorted disjoint ranges.

    Adjacent ranges ([a,b) followed by [b,c)) are merged, matching the
    reference's ``_join_ranges`` (which merges when ``end >= next_start``).
    """
    if isinstance(list_of_ranges, np.ndarray) and list_of_ranges.ndim == 2:
        list_of_ranges = [list_of_ranges]
    list_of_ranges = [np.asarray(r).reshape(-1, 2) for r in list_of_ranges]
    if native.available():
        return _native_vote(list_of_ranges, 1)

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
    if native.available():
        return _native_vote(list_of_ranges, min_count)

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


def _require_native(name: str):
    if not native.available():
        raise RuntimeError(f"{name} runs on the native library only "
                           "(native.use_native is False)")


def rle_voting(ranges: np.ndarray, vote_thr: int = 2) -> np.ndarray:
    """Ranges where at least ``vote_thr`` of the input ranges overlap."""
    if vote_thr < 2:
        raise ValueError("rle_voting needs vote_thr >= 2; a vote of 1 is join_ranges")
    _require_native("rle_voting")
    return coverage_ranges(np.asarray(ranges).reshape(-1, 2), vote_thr)


def vote_by_ranges(list_of_ranges, vote_thr: int = 2) -> np.ndarray:
    """Pixel vote across range sets: the indices that at least ``vote_thr``
    sets cover.  ``vote_thr`` 1 is the union; with fewer non-empty sets
    than ``vote_thr`` nothing wins."""
    _require_native("vote_by_ranges")
    list_of_ranges = [r for r in list_of_ranges if len(r) > 0]
    if vote_thr == 1:
        return join_ranges(list_of_ranges)
    if len(list_of_ranges) >= vote_thr:
        return coverage_ranges(list_of_ranges, vote_thr)
    return _EMPTY.copy()


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
