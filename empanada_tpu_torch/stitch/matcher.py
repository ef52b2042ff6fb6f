"""Instance matching across slices (counterpart of
``empanada_tpu/stitch/matcher.py``, the flat form that the 3D path runs),
``fast_matcher`` on dense instance maps (the training metrics') and
``rle_matcher`` on RLE instance dicts (the evaluator's).

``RLEMatcher`` is the stateful cross-slice matcher: instances of the new
slice that match a target instance (maximum total IoU, exact assignment
with scipy's Hungarian solver, IoU >= merge_iou_thr) inherit its label,
unmatched ones with IoA >= merge_ioa_thr are absorbed (false-split repair),
others get a fresh label (forward pass) or keep their own (backward pass).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.boxes import merge_boxes, overlapping_box_pairs
from empanada_tpu_torch.core.labeling import FlatInstances, extract_runs, runs_to_regions
from empanada_tpu_torch.core.masks import crop_and_binarize, mask_ioa, mask_iou
from empanada_tpu_torch.core.ranges import join_ranges, ranges_to_rle
from empanada_tpu_torch.core.rle import merge_rles, rle_iou

__all__ = ["RLEMatcher", "fast_matcher", "rle_matcher", "rle_matcher_flat", "merge_attrs"]


def merge_attrs(rle_attr1: dict, rle_attr2: dict) -> dict:
    """Two instances' records merged: the enclosing box and the union of
    their run-length encodings."""
    starts, runs = merge_rles(rle_attr1["starts"], rle_attr1["runs"],
                              rle_attr2["starts"], rle_attr2["runs"])
    return {"box": merge_boxes(rle_attr1["box"], rle_attr2["box"]), "starts": starts,
            "runs": runs}


def _merge_collisions(mf: FlatInstances, new_labels, uniq, first_idx,
                      inverse) -> FlatInstances:
    """Merge collision groups straight from the flat form.

    ``new_labels[i]`` is instance i's destination label; ``uniq/first_idx/
    inverse`` come from ``np.unique(new_labels, ...)``.  Output order is
    first occurrence (the volume fill paints overlapping instances in
    that order).  One native call covers all groups; single-member groups round-trip unchanged because an instance's runs
    are already canonical (sorted, disjoint).
    """
    # group order = first appearance in match iteration order
    rank_order = np.argsort(first_idx)            # unique idx -> ordered rank
    grp_rank = np.empty(len(uniq), dtype=np.int64)
    grp_rank[rank_order] = np.arange(len(uniq))
    member_rank = grp_rank[inverse]               # per member
    member_order = np.argsort(member_rank, kind="stable")
    labels_ordered = uniq[rank_order].astype(np.int64, copy=False)
    sizes = np.bincount(member_rank, minlength=len(uniq))

    member_bounds = np.concatenate([[0], np.cumsum(sizes)])
    if native.available():
        # one native call: per-group segment gather + range union + box
        # reduce
        out_starts, out_runs, out_offsets, gboxes = native.merge_groups_flat(
            mf.starts, mf.runs, mf.offsets, mf.boxes, member_order, member_bounds)
        return FlatInstances(labels_ordered, gboxes, out_offsets, out_starts, out_runs)

    # numpy: a k-way union per group
    off = mf.offsets
    boxes, starts, runs = [], [], []
    for gi in range(len(labels_ordered)):
        attrs = [{"box": tuple(mf.boxes[k].tolist()),
                  "starts": mf.starts[off[k]: off[k + 1]],
                  "runs": mf.runs[off[k]: off[k + 1]]}
                 for k in member_order[member_bounds[gi]: member_bounds[gi + 1]].tolist()]
        merged = attrs[0] if len(attrs) == 1 else merge_attrs_many(attrs)
        boxes.append(merged["box"])
        starts.append(np.asarray(merged["starts"], np.int64))
        runs.append(np.asarray(merged["runs"], np.int64))
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in starts])]).astype(np.int64)
    return FlatInstances(labels_ordered, np.asarray(boxes, np.int64).reshape(-1, 4),
                         offsets, np.concatenate(starts), np.concatenate(runs))


def _bounding_box(boxes: np.ndarray) -> tuple:
    """Smallest box enclosing all rows of an (n, 2*nd) box array."""
    nd = boxes.shape[1] // 2
    return tuple(
        int(v) for v in np.concatenate([boxes[:, :nd].min(0), boxes[:, nd:].max(0)])
    )


def merge_attrs_many(attrs_list) -> dict:
    """Merge k instances in one pass: vectorized box bound + one
    concat-sort range union for the whole group."""
    box = _bounding_box(np.asarray([a["box"] for a in attrs_list]))
    ranges = [
        np.stack(
            [np.asarray(a["starts"]), np.asarray(a["starts"]) + np.asarray(a["runs"])],
            axis=1,
        )
        for a in attrs_list
    ]
    rle = ranges_to_rle(join_ranges(ranges))
    return {"box": box, "starts": rle[:, 0], "runs": rle[:, 1]}


def _batch_intersections_flat(tf: FlatInstances, mf: FlatInstances, box_matches):
    """Pairwise RLE intersections for box-screened pairs from flat forms
    (two big concats instead of ~2k small per-instance ones)."""
    if native.available():
        s_flat = np.concatenate([tf.starts, mf.starts])
        e_flat = np.concatenate([tf.starts + tf.runs, mf.starts + mf.runs])
        flat = np.stack([s_flat, e_flat], axis=1)
        offsets = np.concatenate([tf.offsets, tf.offsets[-1] + mf.offsets[1:]])
        pairs = box_matches.copy()
        pairs[:, 1] += len(tf)
        return native.batch_pair_intersection(flat, offsets, pairs)

    to, mo = tf.offsets, mf.offsets
    return np.array(
        [
            rle_iou(
                tf.starts[to[r1] : to[r1 + 1]], tf.runs[to[r1] : to[r1 + 1]],
                mf.starts[mo[r2] : mo[r2 + 1]], mf.runs[mo[r2] : mo[r2 + 1]],
                return_intersection=True,
            )[1]
            for r1, r2 in box_matches
        ],
        dtype=np.int64,
    )


def _instance_areas(runs_list) -> np.ndarray:
    """Voxel count of each instance of a list of run arrays."""
    lens = np.fromiter(map(len, runs_list), dtype=np.int64, count=len(runs_list))
    out = np.zeros(len(runs_list), dtype=np.int64)
    nz = lens > 0
    if nz.any():
        flat = np.concatenate([np.asarray(r, dtype=np.int64) for r in runs_list])
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        out[nz] = np.add.reduceat(flat, starts[nz])
    return out


def _batch_intersections(target_starts, target_runs, match_starts, match_runs,
                         box_matches, max_threads: int = 0) -> np.ndarray:
    """RLE intersections of the (k, 2) ``box_matches`` pairs (target index,
    match index) of two lists of RLEs, in one native call.  ``max_threads``
    1 keeps the call on the calling thread (callers already in a pool);
    native only."""
    if not native.available():
        raise RuntimeError("_batch_intersections runs on the native library only "
                           "(native.use_native is False)")
    starts_all = list(target_starts) + list(match_starts)
    runs_all = list(target_runs) + list(match_runs)
    lens = np.fromiter(map(len, starts_all), dtype=np.int64, count=len(starts_all))
    offsets = np.concatenate([[0], np.cumsum(lens)])
    s_flat = np.concatenate([np.asarray(s, np.int64) for s in starts_all] or
                            [np.empty(0, np.int64)])
    r_flat = np.concatenate([np.asarray(r, np.int64) for r in runs_all] or
                            [np.empty(0, np.int64)])
    pairs = np.array(box_matches, dtype=np.int64).reshape(-1, 2)
    pairs[:, 1] += len(target_starts)
    return native.batch_pair_intersection(np.stack([s_flat, s_flat + r_flat], axis=1),
                                          offsets, pairs, max_threads)


def _uf_components(n: int, erows, ecols):
    """Union-find over an edge list; per-node component ids 0..k-1."""
    parent = list(range(n))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(erows.tolist(), ecols.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    roots = np.fromiter((find(i) for i in range(n)), np.int64, count=n)
    _, comp = np.unique(roots, return_inverse=True)
    return comp.astype(np.int64, copy=False)


def _assign_edges(n1, n2, erows, ecols, evals, iou_thr):
    """Exact max-IoU assignment straight from the box-screened edge list —
    the dense Hungarian decomposed over bipartite connected components
    (zero cross-component entries never contribute to the maximum), without
    materializing the n1 x n2 matrix or a scipy csgraph.  Returns
    (match_rows, match_cols) after the ``iou_thr`` filter.

    This is the RLEMatcher hot path: at EM densities (~365 inst/slice) the
    dense-matrix route (alloc + np.nonzero + csr + csgraph) costs ~2 ms per
    slice on the sequential matcher thread; this is ~0.3 ms."""
    keep = evals > 0
    erows, ecols, evals = erows[keep], ecols[keep], evals[keep]
    if len(erows) == 0:
        e = np.empty(0, np.int64)
        return e, e
    comp = _uf_components(n1 + n2, erows, ecols + n1)
    n_comp = int(comp.max()) + 1
    rows_per = np.bincount(comp[:n1], minlength=n_comp)
    cols_per = np.bincount(comp[n1:], minlength=n_comp)

    edge_comp = comp[erows]
    order_cv = np.lexsort((evals, edge_comp))   # by comp, then value asc
    e_bounds = np.searchsorted(edge_comp[order_cv], np.arange(n_comp + 1))
    has_edge = e_bounds[1:] > e_bounds[:-1]
    best_edge = np.full(n_comp, -1, dtype=np.int64)
    best_edge[has_edge] = order_cv[e_bounds[1:][has_edge] - 1]
    # one-sided components: at most one pair can be used, so the max-value
    # edge IS the optimal assignment (the vast majority at EM densities)
    single = (np.minimum(rows_per, cols_per) == 1) & has_edge

    out_rows = [erows[best_edge[single]]]
    out_cols = [ecols[best_edge[single]]]
    out_vals = [evals[best_edge[single]]]

    multi = np.flatnonzero((rows_per > 1) & (cols_per > 1))
    if len(multi):
        order_e = np.argsort(edge_comp, kind="stable")
        eb = np.searchsorted(edge_comp[order_e], np.arange(n_comp + 1))
        node_order = np.argsort(comp, kind="stable")
        nb = np.searchsorted(comp[node_order], np.arange(n_comp + 1))
        for c in multi:
            members = node_order[nb[c]: nb[c + 1]]
            r = members[members < n1]
            k = members[members >= n1] - n1
            es = order_e[eb[c]: eb[c + 1]]
            sub = np.zeros((len(r), len(k)))
            sub[np.searchsorted(r, erows[es]),
                np.searchsorted(k, ecols[es])] = evals[es]
            sr, sc = linear_sum_assignment(sub, maximize=True)
            out_rows.append(r[sr])
            out_cols.append(k[sc])
            out_vals.append(sub[sr, sc])

    mr = np.concatenate(out_rows)
    mc = np.concatenate(out_cols)
    mv = np.concatenate(out_vals)
    if iou_thr is not None:
        sel = mv >= iou_thr
        mr, mc = mr[sel], mc[sel]
    return mr, mc


# native matcher-core gate: the C++ box screen is the quadratic row-major
# test, so bound the pair product (an EM-density 512^2 slice pair is ~130k)
_CORE_MAX_PAIRS = 1 << 19


def _solve_spill(spill, spill_vals, iou_thr):
    """Exact Hungarian resolution of the components the native core spilled
    (both sides > 1 member) — identical math to _assign_edges' multi branch:
    per component, a dense submatrix over the sorted member sets, an exact
    max-assignment solve, then the IoU threshold filter.  The native
    shortest-augmenting-path solver handles it in one call (the algorithm
    family of scipy); the numpy path solves each component with scipy."""
    if native.available():
        return native.solve_spill(spill, spill_vals, iou_thr)
    out_r, out_c = [np.empty(0, np.int64)], [np.empty(0, np.int64)]
    for c in np.unique(spill[:, 0]):
        es = np.flatnonzero(spill[:, 0] == c)
        r = np.unique(spill[es, 1])
        k = np.unique(spill[es, 2])
        sub = np.zeros((len(r), len(k)))
        sub[np.searchsorted(r, spill[es, 1]),
            np.searchsorted(k, spill[es, 2])] = spill_vals[es]
        sr, sc = linear_sum_assignment(sub, maximize=True)
        keep = sub[sr, sc] >= iou_thr
        out_r.append(r[sr][keep])
        out_c.append(k[sc][keep])
    return np.concatenate(out_r), np.concatenate(out_c)


def _col_max_arg(n2, erows, ecols, evals):
    """Per-column (max, argmax-row) of an edge-sparse matrix — equal to
    dense ``.max(axis=0)`` / ``.argmax(axis=0)`` over screened pairs,
    including first-row-on-ties argmax semantics."""
    col_max = np.zeros(n2)
    col_arg = np.zeros(n2, dtype=np.int64)
    if len(ecols):
        # within (col, value) ties, rows descending -> the LAST entry per
        # column group carries the smallest row, matching dense argmax
        order = np.lexsort((-erows, evals, ecols))
        b = np.searchsorted(ecols[order], np.arange(n2 + 1))
        has = b[1:] > b[:-1]
        last = order[b[1:][has] - 1]
        col_max[has] = evals[last]
        col_arg[has] = erows[last]
    return col_max, col_arg


def _empty_result(labels1, labels2, return_iou, return_ioa):
    empty = np.array([])
    out = ((empty, empty), (labels1, labels2), empty)
    if return_iou:
        out = out + (empty,)
    if return_ioa:
        out = out + (empty,)
    return out


def _regions_of_dense(instance_seg: np.ndarray) -> dict:
    v, r, cs, ce = extract_runs(instance_seg)
    return runs_to_regions(v, r, cs, ce, width=instance_seg.shape[-1])


def fast_matcher(target_instance_seg: np.ndarray, match_instance_seg: np.ndarray,
                 iou_thr: float = 0.5, return_iou: bool = False,
                 return_ioa: bool = False):
    """Hungarian matching of the instances of two dense (H, W) label maps:
    ((matched target labels, matched labels), (all target labels, all
    labels), matched IoUs[, IoU matrix][, IoA matrix]); pairs below
    ``iou_thr`` are dropped."""
    regions1 = _regions_of_dense(target_instance_seg)
    regions2 = _regions_of_dense(match_instance_seg)
    labels1 = np.array(sorted(regions1))
    labels2 = np.array(sorted(regions2))
    if len(labels1) == 0 or len(labels2) == 0:
        return _empty_result(labels1, labels2, return_iou, return_ioa)

    boxes1 = np.array([regions1[l]["box"] for l in labels1])
    boxes2 = np.array([regions2[l]["box"] for l in labels2])
    iou_matrix = np.zeros((len(labels1), len(labels2)), dtype=np.float32)
    ioa_matrix = np.zeros_like(iou_matrix) if return_ioa else None
    for r1, r2 in overlapping_box_pairs(boxes1, boxes2):
        box = merge_boxes(boxes1[r1], boxes2[r2])
        m1 = crop_and_binarize(target_instance_seg, box, labels1[r1])
        m2 = crop_and_binarize(match_instance_seg, box, labels2[r2])
        iou_matrix[r1, r2] = mask_iou(m1, m2)
        if return_ioa:
            ioa_matrix[r1, r2] = mask_ioa(m1, m2)
    return _assign(iou_matrix, ioa_matrix, labels1, labels2, iou_thr, return_iou,
                   return_ioa)


def rle_matcher(target_instance_rles: dict, match_instance_rles: dict,
                iou_thr: float = 0.5, return_iou: bool = False, return_ioa: bool = False):
    """``fast_matcher`` on instances given as ``{label: {"box", "starts",
    "runs"}}`` RLE dicts (the evaluator's tracker dumps)."""
    return rle_matcher_flat(FlatInstances.from_dict(target_instance_rles),
                            FlatInstances.from_dict(match_instance_rles),
                            iou_thr, return_iou, return_ioa)


def rle_matcher_flat(tf: FlatInstances, mf: FlatInstances, iou_thr: float = 0.5,
                     return_iou: bool = False, return_ioa: bool = False):
    """``rle_matcher`` on ``FlatInstances``: IoUs of the box-overlapping
    pairs from their run intersections, then the same assignment."""
    if len(tf) == 0 or len(mf) == 0:
        return _empty_result(tf.labels, mf.labels, return_iou, return_ioa)
    iou_matrix = np.zeros((len(tf), len(mf)), dtype=float)
    ioa_matrix = np.zeros_like(iou_matrix) if return_ioa else None
    box_matches = overlapping_box_pairs(tf.boxes, mf.boxes)
    if len(box_matches):
        inters = _batch_intersections_flat(tf, mf, box_matches)
        r1, r2 = box_matches[:, 0], box_matches[:, 1]
        union = tf.areas[r1] + mf.areas[r2] - inters
        iou_matrix[r1, r2] = np.where(union > 0, inters / np.maximum(union, 1), 0.0)
        if return_ioa:
            a2 = mf.areas[r2]
            ioa_matrix[r1, r2] = np.where(a2 > 0, inters / np.maximum(a2, 1), 0.0)
    return _assign(iou_matrix, ioa_matrix, tf.labels, mf.labels, iou_thr, return_iou,
                   return_ioa)


def _sparse_assignment(iou_matrix):
    """Maximum-IoU assignment solved per connected component of the nonzero
    entries (exactly the dense solve: entries across components are zero);
    a component with one node on a side takes its largest edge."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    n1, n2 = iou_matrix.shape
    rows, cols = np.nonzero(iou_matrix)
    vals = iou_matrix[rows, cols]
    adj = csr_matrix(
        (np.ones(2 * len(rows), dtype=np.int8),
         (np.concatenate([rows, cols + n1]), np.concatenate([cols + n1, rows]))),
        shape=(n1 + n2, n1 + n2))
    n_comp, comp = connected_components(adj, directed=False)

    rows_per = np.bincount(comp[:n1], minlength=n_comp)
    cols_per = np.bincount(comp[n1:], minlength=n_comp)
    edge_comp = comp[rows]
    order_cv = np.lexsort((vals, edge_comp))   # by component, then value ascending
    e_bounds = np.searchsorted(edge_comp[order_cv], np.arange(n_comp + 1))
    has_edge = e_bounds[1:] > e_bounds[:-1]
    best_edge = np.full(n_comp, -1, dtype=np.int64)
    best_edge[has_edge] = order_cv[e_bounds[1:][has_edge] - 1]
    single = (np.minimum(rows_per, cols_per) == 1) & has_edge

    out_rows = [rows[best_edge[single]]]
    out_cols = [cols[best_edge[single]]]
    multi = np.flatnonzero((rows_per > 1) & (cols_per > 1))
    if len(multi):
        order = np.argsort(comp, kind="stable")
        bounds = np.searchsorted(comp[order], np.arange(n_comp + 1))
        for c in multi:
            members = order[bounds[c]: bounds[c + 1]]
            r = members[members < n1]
            k = members[members >= n1] - n1
            sub_r, sub_c = linear_sum_assignment(iou_matrix[np.ix_(r, k)], maximize=True)
            out_rows.append(r[sub_r])
            out_cols.append(k[sub_c])
    return np.concatenate(out_rows), np.concatenate(out_cols)


def _assign(iou_matrix, ioa_matrix, labels1, labels2, iou_thr, return_iou, return_ioa):
    if min(iou_matrix.shape) > 32 and iou_thr:
        match_rows, match_cols = _sparse_assignment(iou_matrix)
    else:
        match_rows, match_cols = linear_sum_assignment(iou_matrix, maximize=True)
    if iou_thr is not None:
        keep = iou_matrix[match_rows, match_cols] >= iou_thr
        match_rows = match_rows[keep]
        match_cols = match_cols[keep]
    output = ((labels1[match_rows], labels2[match_cols]), [labels1, labels2],
              iou_matrix[(match_rows, match_cols)])
    if return_iou:
        output = output + (iou_matrix,)
    if return_ioa:
        output = output + (ioa_matrix,)
    return output


class RLEMatcher:
    """Stateful cross-slice instance matcher on FlatInstances."""

    def __init__(
        self,
        class_id: int,
        label_divisor: int,
        merge_iou_thr: float = 0.25,
        merge_ioa_thr: float = 0.25,
        assign_new: bool = True,
    ):
        self.class_id = class_id
        self.label_divisor = label_divisor
        self.merge_iou_thr = merge_iou_thr
        self.merge_ioa_thr = merge_ioa_thr
        self.assign_new = assign_new
        self.next_label = (class_id * label_divisor) + 1
        self._target_flat = None

    def initialize_target_flat(self, flat: "FlatInstances"):
        """Make ``flat`` the target; fresh labels continue after its largest."""
        self._target_flat = flat
        if len(flat):
            self.next_label = int(flat.labels.max()) + 1

    def update_target(self, flat: "FlatInstances"):
        """Make ``flat`` the target without touching ``next_label`` (a
        resumed sweep sets that to its own watermark)."""
        self._target_flat = flat

    def reset_target(self):
        self._target_flat = None

    def has_target(self) -> bool:
        return self._target_flat is not None

    def match_flat(self, mf: "FlatInstances",
                   update_target: bool = True) -> "FlatInstances":
        """Flat-in/flat-out matching — the 3D pipeline's sequential hot
        path.  Assignment and the IoA absorb decisions run on the
        box-screened edge list (``_assign_edges``/``_col_max_arg``), or in one
        native call."""
        tf = self._target_flat
        assert tf is not None, "Initialize target rle before running!"

        n2 = len(mf)
        if len(tf) == 0 or n2 == 0:
            mr = mc = np.empty(0, np.int64)
            col_max = np.zeros(n2)
            col_arg = np.zeros(n2, np.int64)
        else:
            core = None
            if len(tf) * n2 <= _CORE_MAX_PAIRS:
                if native.available():
                    # one native call covers box screen + intersections
                    # + IoU edges + components + single-candidate
                    # assignment + IoA column stats
                    core = native.match_flat_core(tf, mf, self.merge_iou_thr)
            if core is not None:
                matched_row, col_max, col_arg, spill, spill_vals = core
                mc = np.flatnonzero(matched_row >= 0)
                mr = matched_row[mc]
                if len(spill):
                    mr2, mc2 = _solve_spill(spill, spill_vals,
                                            self.merge_iou_thr)
                    mr = np.concatenate([mr, mr2])
                    mc = np.concatenate([mc, mc2])
            else:
                box_matches = overlapping_box_pairs(tf.boxes, mf.boxes)
                if len(box_matches):
                    inters = _batch_intersections_flat(tf, mf, box_matches)
                    r1 = box_matches[:, 0]
                    r2 = box_matches[:, 1]
                    union = tf.areas[r1] + mf.areas[r2] - inters
                    iou = np.where(union > 0, inters / np.maximum(union, 1), 0.0)
                    a2 = mf.areas[r2]
                    ioa = np.where(a2 > 0, inters / np.maximum(a2, 1), 0.0)
                else:
                    r1 = r2 = np.empty(0, np.int64)
                    iou = ioa = np.empty(0)
                mr, mc = _assign_edges(len(tf), n2, r1, r2, iou,
                                       self.merge_iou_thr)
                col_max, col_arg = _col_max_arg(n2, r1, r2, ioa)

        new_labels = np.empty(n2, dtype=np.int64)
        is_matched = np.zeros(n2, dtype=bool)
        is_matched[mc] = True
        new_labels[mc] = tf.labels[mr]
        # false split: absorb unmatched instances into the most-overlapping
        # target when IoA clears the threshold
        absorb = ~is_matched & (col_max >= self.merge_ioa_thr)
        new_labels[absorb] = tf.labels[col_arg[absorb]]
        fresh = ~is_matched & ~absorb
        n_fresh = int(fresh.sum())
        if self.assign_new:
            new_labels[fresh] = self.next_label + np.arange(n_fresh)
            self.next_label += n_fresh
        else:
            new_labels[fresh] = mf.labels[fresh]

        uniq, first_idx, inverse = np.unique(
            new_labels, return_index=True, return_inverse=True
        )
        if len(uniq) == len(new_labels):
            # relabel-only (no collisions): reuse the match flat arrays
            # verbatim, skipping all merge work
            out = FlatInstances(new_labels, mf.boxes, mf.offsets,
                                mf.starts, mf.runs)
            out._areas = mf._areas
        else:
            # collision groups merged in ONE batched native union over ALL
            # groups (single-member groups pass through: their runs are
            # already canonical), with boxes reduced per group — no
            # per-group Python loop
            out = _merge_collisions(mf, new_labels, uniq, first_idx, inverse)

        if update_target:
            self._target_flat = out
        return out
