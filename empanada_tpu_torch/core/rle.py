"""Run-length codec over flat voxel indices (counterpart of
``empanada_tpu/core/rle.py``): encode, decode, union, intersection, IoU
and IoA, and the volume fill."""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core import ranges as R

__all__ = [
    "rle_encode",
    "rle_decode",
    "merge_rles",
    "rle_intersection",
    "rle_iou",
    "rle_ioa",
    "rle_area",
    "rle_to_string",
    "string_to_rle",
    "numpy_fill_instances",
]


def rle_to_string(starts, runs) -> str:
    """The "start run start run ..." text form of an RLE."""
    return " ".join(f"{int(s)} {int(r)}" for s, r in zip(starts, runs))


def string_to_rle(encoding: str):
    """Parse the "start run start run ..." text form: ``(starts, runs)``."""
    if not encoding or not encoding.strip():
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    vals = np.array(encoding.split(), dtype=np.int64)
    return vals[::2].copy(), vals[1::2].copy()


def rle_encode(indices: np.ndarray):
    """Run-length encode a sorted array of flat indices: ``(starts, runs)``,
    a run breaking wherever the next index is not this one + 1."""
    indices = np.asarray(indices)
    if len(indices) == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    breaks = np.flatnonzero(indices[1:] != indices[:-1] + 1) + 1
    changes = np.concatenate([[0], breaks, [len(indices)]])
    return indices[changes[:-1]].astype(np.int64), np.diff(changes).astype(np.int64)


def rle_decode(starts: np.ndarray, runs: np.ndarray) -> np.ndarray:
    """Expand (starts, runs) back to the full sorted array of flat indices."""
    starts = np.asarray(starts, dtype=np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    if len(starts) == 0:
        return np.empty(0, dtype=np.int64)
    total = int(runs.sum())
    # vectorized expansion: offsets within runs via cumsum trick
    out = np.ones(total, dtype=np.int64)
    run_starts_out = np.concatenate([[0], np.cumsum(runs)[:-1]])
    out[run_starts_out] = starts
    out[run_starts_out[1:]] -= starts[:-1] + runs[:-1] - 1
    return np.cumsum(out)


def _rle_ranges(starts, runs) -> np.ndarray:
    starts = np.asarray(starts, dtype=np.int64)
    return np.stack([starts, starts + np.asarray(runs, dtype=np.int64)], axis=1)


def merge_rles(starts_a, runs_a, starts_b=None, runs_b=None):
    """Union of two RLEs (or the merge of one) into one sorted RLE of
    disjoint runs, touching runs joined: ``(starts, runs)``."""
    sets = [_rle_ranges(starts_a, runs_a)]
    if starts_b is not None and runs_b is not None:
        sets.append(_rle_ranges(starts_b, runs_b))
    rle = R.ranges_to_rle(R.join_ranges(sets))
    return rle[:, 0], rle[:, 1]


def rle_intersection(starts_a, runs_a, starts_b, runs_b) -> int:
    """Number of overlapping indices between two RLEs."""
    ranges_a = np.stack([starts_a, np.asarray(starts_a) + np.asarray(runs_a)], axis=1)
    ranges_b = np.stack([starts_b, np.asarray(starts_b) + np.asarray(runs_b)], axis=1)
    return R.intersection_from_ranges(ranges_a, ranges_b)


def rle_iou(starts_a, runs_a, starts_b, runs_b, return_intersection: bool = False):
    """Intersection-over-union between two RLEs, computed without densifying."""
    inter = rle_intersection(starts_a, runs_a, starts_b, runs_b)
    union = int(np.asarray(runs_a).sum()) + int(np.asarray(runs_b).sum()) - inter
    iou = inter / union if union > 0 else 0.0
    if return_intersection:
        return iou, inter
    return iou


def rle_ioa(starts_a, runs_a, starts_b, runs_b, return_intersection: bool = False):
    """Intersection over the area of the *second* RLE."""
    inter = rle_intersection(starts_a, runs_a, starts_b, runs_b)
    area = rle_area(runs_b)
    ioa = inter / area if area > 0 else 0.0
    if return_intersection:
        return ioa, inter
    return ioa


def rle_area(runs) -> int:
    return int(np.asarray(runs).sum())


def numpy_fill_instances(volume: np.ndarray, instances: dict) -> np.ndarray:
    """Fill a dense volume in-place from ``{instance_id: {starts, runs}}``.

    Instances are painted in dict order, so a later one overwrites an
    earlier one where they overlap (the reference's sequential semantics).
    """
    shape = volume.shape
    flat = volume.reshape(-1)
    from empanada_tpu_torch.core import native

    fast = native.available() and flat.dtype in (np.int32, np.uint32, np.int64)
    for instance_id, attrs in instances.items():
        starts = np.asarray(attrs["starts"], dtype=np.int64)
        runs = np.asarray(attrs["runs"], dtype=np.int64)
        if len(starts) == 0:
            continue
        if fast:
            native.fill_ranges(flat, np.stack([starts, starts + runs], axis=1), instance_id)
        else:
            idx = rle_decode(starts, runs)
            flat[idx] = instance_id
    return flat.reshape(shape)
