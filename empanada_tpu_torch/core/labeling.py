"""Run-based connected components and region extraction.

The host hot path of the stitching layer converts a dense panoptic label map
into per-instance {bounding box, RLE} records, optionally enforcing that every
instance is a connected component (reference ``empanada/inference/rle.py:26``,
which densely relabels with cc3d/skimage and then runs regionprops +
per-region RLE encoding).

Here the whole pipeline is run-based: the image is scanned once into
(row, col_start, col_end, value) runs (vectorized numpy), connected components
are computed with union-find *over runs* (equal-value adjacency, 4- or
8-connectivity), and boxes/RLEs fall directly out of the runs — the dense
image is never relabeled.  A native C++ kernel accelerates the union-find
pass (``core/native.py``); the numpy+Python form, taken with
``native.use_native = False``, is exact but slower.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "extract_runs",
    "connected_components_runs",
    "runs_to_flat",
    "runs_to_regions",
    "label_2d",
    "FlatInstances",
    "decode_runs_packed",
]


def extract_runs(seg: np.ndarray):
    """Extract maximal horizontal runs of constant nonzero value.

    Args:
        seg: 2D integer array (h, w).

    Returns:
        values: (n,) run values.
        rows: (n,) row index of each run.
        col_starts: (n,) first column of each run.
        col_ends: (n,) one-past-last column of each run.
    """
    seg = np.ascontiguousarray(seg)
    h, w = seg.shape
    flat = seg.reshape(-1)
    if flat.size == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e, e, e

    from empanada_tpu_torch.core import native

    if native.available():
        out = native.extract_runs(seg)
        if out is not None:
            return out

    # run boundaries: value change OR row wrap
    change = np.empty(flat.size, dtype=bool)
    change[0] = True
    np.not_equal(flat[1:], flat[:-1], out=change[1:])
    change[::w] = True  # each row starts a new run
    start_idx = np.flatnonzero(change)
    end_idx = np.concatenate([start_idx[1:], [flat.size]])

    values = flat[start_idx]
    keep = values != 0
    start_idx = start_idx[keep]
    end_idx = end_idx[keep]
    values = values[keep].astype(np.int64)

    rows = start_idx // w
    col_starts = start_idx - rows * w
    col_ends = end_idx - rows * w
    return values, rows.astype(np.int64), col_starts.astype(np.int64), col_ends.astype(np.int64)


class _UnionFind:
    __slots__ = ("parent",)

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        parent = self.parent
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def connected_components_runs(values, rows, col_starts, col_ends, connectivity: int = 8):
    """Union-find connected components over runs with equal-value adjacency.

    Two runs are connected when they are on consecutive rows, share the same
    value, and their column intervals touch (8-connectivity allows diagonal
    touch, i.e. intervals [s1,e1) and [s2,e2) with s1 < e2+1 and s2 < e1+1).

    Returns:
        comp_ids: (n,) int64 component label per run, numbered 1..n_components
        in order of first (row-major) appearance.
    """
    from empanada_tpu_torch.core import native

    if native.available():
        return native.connected_components_runs(
            values, rows, col_starts, col_ends, connectivity
        )
    return _connected_components_runs_py(values, rows, col_starts, col_ends, connectivity)


def _connected_components_runs_py(values, rows, col_starts, col_ends, connectivity=8):
    n = len(values)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    uf = _UnionFind(n)
    pad = 1 if connectivity == 8 else 0

    # row-major run order is guaranteed by extract_runs
    row_change = np.flatnonzero(np.concatenate([[True], rows[1:] != rows[:-1]]))
    row_bounds = dict(zip(rows[row_change].tolist(), row_change.tolist()))
    row_counts = np.concatenate([np.diff(row_change), [n - row_change[-1]]])
    row_len = dict(zip(rows[row_change].tolist(), row_counts.tolist()))

    for r, start in row_bounds.items():
        prev = row_bounds.get(r - 1)
        if prev is None:
            continue
        np_len, cu_len = row_len[r - 1], row_len[r]
        i, j = prev, start
        i_end, j_end = prev + np_len, start + cu_len
        # two-pointer sweep over the sorted runs of consecutive rows
        while i < i_end and j < j_end:
            # overlap test with diagonal padding
            if col_ends[i] + pad <= col_starts[j]:
                i += 1
            elif col_ends[j] + pad <= col_starts[i]:
                j += 1
            else:
                if values[i] == values[j]:
                    uf.union(i, j)
                # advance the run that ends first
                if col_ends[i] < col_ends[j]:
                    i += 1
                else:
                    j += 1

    roots = np.fromiter((uf.find(i) for i in range(n)), dtype=np.int64, count=n)
    # renumber roots by first appearance (row-major order)
    uniq, comp = np.unique(roots, return_inverse=True)
    # np.unique sorts by root index == first appearance because union keeps min
    return comp.astype(np.int64) + 1


class FlatInstances:
    """Struct-of-arrays view of one class's instance set.

    The port's 3D path carries instances only in this form (the JAX
    package also keeps the nested ``{label: {box, starts, runs}}`` dict):
    five contiguous arrays, so the matcher never re-concatenates small
    per-instance arrays.

    Invariants: instance k owns ``starts/runs[offsets[k]:offsets[k+1]]``
    (every instance has >= 1 run), ``labels`` in first-appearance order.
    """

    __slots__ = ("labels", "boxes", "offsets", "starts", "runs", "_areas")

    def __init__(self, labels, boxes, offsets, starts, runs):
        self.labels = labels
        self.boxes = boxes
        self.offsets = offsets
        self.starts = starts
        self.runs = runs
        self._areas = None

    @property
    def areas(self) -> np.ndarray:
        """Per-instance voxel counts (cached)."""
        if self._areas is None:
            if len(self.labels) == 0:
                self._areas = np.empty(0, dtype=np.int64)
            else:
                self._areas = np.add.reduceat(self.runs, self.offsets[:-1])
        return self._areas

    def __len__(self) -> int:
        return len(self.labels)

    @staticmethod
    def empty() -> "FlatInstances":
        e = np.empty(0, dtype=np.int64)
        return FlatInstances(e, np.empty((0, 4), dtype=np.int64), np.zeros(1, dtype=np.int64), e, e)

    def to_dict(self) -> dict:
        """The nested ``{label: {"box", "starts", "runs"}}`` form (the
        starts and runs are views into the flat arrays)."""
        off = self.offsets.tolist()
        boxes = self.boxes.tolist()
        return {label: {"box": tuple(boxes[k]), "starts": self.starts[off[k]: off[k + 1]],
                        "runs": self.runs[off[k]: off[k + 1]]}
                for k, label in enumerate(self.labels.tolist())}

    @staticmethod
    def from_dict(d: dict) -> "FlatInstances":
        """Inverse of ``to_dict``, instances in the dict's order."""
        if not d:
            return FlatInstances.empty()
        starts = [np.asarray(a["starts"], dtype=np.int64) for a in d.values()]
        runs = [np.asarray(a["runs"], dtype=np.int64) for a in d.values()]
        offsets = np.zeros(len(d) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in starts], out=offsets[1:])
        return FlatInstances(np.fromiter(d.keys(), dtype=np.int64, count=len(d)),
                             np.array([a["box"] for a in d.values()], dtype=np.int64),
                             offsets, np.concatenate(starts), np.concatenate(runs))


def runs_to_flat(values, rows, col_starts, col_ends, width: int) -> FlatInstances:
    """Group runs by value into a FlatInstances (vectorized over all runs).

    Boxes are the row/col extents of the ORIGINAL runs; the RLE is
    canonicalized afterwards (runs that touch across row boundaries are
    merged) so it matches the run-length encoding of the sorted flat indices.
    """
    n = len(values)
    if n == 0:
        return FlatInstances.empty()
    order = np.argsort(values, kind="stable")
    v = values[order]
    r = rows[order]
    cs = col_starts[order]
    ce = col_ends[order]

    group_idx = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
    labels = v[group_idx].astype(np.int64, copy=False)

    y1 = np.minimum.reduceat(r, group_idx)
    y2 = np.maximum.reduceat(r, group_idx) + 1
    x1 = np.minimum.reduceat(cs, group_idx)
    x2 = np.maximum.reduceat(ce, group_idx)
    boxes = np.stack([y1, x1, y2, x2], axis=1).astype(np.int64, copy=False)

    starts_flat = r * width + cs
    lens = ce - cs

    # canonicalize globally: within a label, runs are in ascending flat
    # order (stable sort over row-major runs), so touching chains are
    # consecutive; label boundaries never touch-merge (v differs)
    if n > 1:
        touch = (starts_flat[1:] == starts_flat[:-1] + lens[:-1]) & (v[1:] == v[:-1])
        if touch.any():
            keep = np.flatnonzero(np.concatenate([[True], ~touch]))
            ends = starts_flat + lens
            merged_ends = np.maximum.reduceat(ends, keep)
            starts_flat = starts_flat[keep]
            lens = merged_ends - starts_flat
            v = v[keep]
            group_idx = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))

    offsets = np.concatenate([group_idx, [len(v)]]).astype(np.int64, copy=False)
    return FlatInstances(labels, boxes, offsets, starts_flat, lens)


def runs_to_regions(values, rows, col_starts, col_ends, width: int) -> dict:
    """Runs grouped by value: ``{label: {"box": (y1, x1, y2, x2), "starts",
    "runs"}}`` with flat starts ``row * width + col_start``."""
    return runs_to_flat(values, rows, col_starts, col_ends, width).to_dict()


def label_2d(seg: np.ndarray, connectivity: int = 8) -> np.ndarray:
    """Connected components of a dense multilabel map, numbered from 1 in
    row-major order of first appearance; pixels of different values never
    merge."""
    values, rows, cs, ce = extract_runs(seg)
    comp = connected_components_runs(values, rows, cs, ce, connectivity)
    out = np.zeros(seg.shape, dtype=np.int64)
    for v, r, s, e in zip(comp, rows, cs, ce):
        out[r, s:e] = v
    return out


def decode_runs_packed(row_buf: np.ndarray, width: int):
    """Decode one slice of ``ops.postprocess.encode_runs_packed`` output.

    Args:
        row_buf: (H, 2R + 1) int16 — ``[starts(R) | values(R) | count]``.
        width: row width W of the encoded map.

    Returns:
        (values, rows, col_starts, col_ends) int64 arrays of the NONZERO
        runs (same contract as ``extract_runs``), or None when any row
        overflowed its R-run capacity (caller falls back to dense).
    """
    row_buf = np.asarray(row_buf)
    h, twr = row_buf.shape
    r = (twr - 1) // 2
    counts = row_buf[:, -1].astype(np.int64)
    if counts.max(initial=0) > r:
        return None
    starts = row_buf[:, :r].astype(np.int64)
    vals = row_buf[:, r : 2 * r].astype(np.int64) & 0xFFFF  # stored unsigned
    mask = np.arange(r)[None, :] < counts[:, None]

    rows = np.repeat(np.arange(h, dtype=np.int64), counts)
    cs = starts[mask]
    v = vals[mask]
    # run ends: the next run's start within the same row, else width
    ce = np.full(len(cs), width, dtype=np.int64)
    if len(cs) > 1:
        same_row = rows[1:] == rows[:-1]
        ce[:-1] = np.where(same_row, cs[1:], width)

    keep = v != 0
    return v[keep], rows[keep], cs[keep], ce[keep]
