"""ctypes bindings to the port's native host library (counterpart of
``empanada_tpu/core/native.py``).

The library is ``csrc/core_kernels.cpp`` (a copy of the JAX package's host
kernels), compiled at first use with the host C++ compiler into
``empanada_tpu_torch/build/`` and named by a hash of the source.  A failed
build or load raises: nothing falls back silently.  The numpy formulations
in the calling modules run only when ``use_native`` is set to False (the
tests hold both paths to the JAX package).

Every array handed to C is a named int64 (or the stated dtype) C-contiguous
local that lives until the call returns; no pointer is taken from a
temporary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

__all__ = [
    "use_native",
    "available",
    "load",
    "connected_components_runs",
    "batch_pair_intersection",
    "fill_ranges",
    "chunk_split_ranges",
    "box_overlap_pairs",
    "extract_runs",
    "runs_build_flat",
    "packed_build_flat",
    "match_sweep",
    "match_flat_core",
    "merge_groups_flat",
    "solve_spill",
    "vote_ranges",
    "vote_sorted_sets",
    "mask_watershed",
    "gray_watershed",
]

# False routes every caller to its numpy formulation
use_native = True

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "core_kernels.cpp")
_BUILD = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

_LIB = None
_lock = threading.Lock()


def _compile() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD, f"libempanada_core-{digest}.so")
    if os.path.isfile(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++/c++) to build "
                           f"{_SRC}; set use_native = False for the numpy path")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build (once per source version) and load the library; raises on
    failure."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_compile())
        i64 = ctypes.c_int64
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.cc_runs.argtypes = [vp, vp, vp, vp, i64, ci, vp]
        lib.cc_runs.restype = None
        lib.batch_pair_intersection.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.batch_pair_intersection.restype = None
        lib.fill_ranges_i32.argtypes = [vp, vp, i64, ctypes.c_int32]
        lib.fill_ranges_i32.restype = None
        lib.fill_ranges_i64.argtypes = [vp, vp, i64, i64]
        lib.fill_ranges_i64.restype = None
        lib.fill_ranges_u32.argtypes = [vp, vp, i64, ctypes.c_uint32]
        lib.fill_ranges_u32.restype = None
        lib.box_overlap_pairs.argtypes = [vp, i64, vp, i64, i64, vp, i64]
        lib.box_overlap_pairs.restype = i64
        lib.extract_runs_i32.argtypes = [vp, i64, i64, i64, vp, vp, vp, vp]
        lib.extract_runs_i32.restype = i64
        lib.extract_runs_i64.argtypes = [vp, i64, i64, i64, vp, vp, vp, vp]
        lib.extract_runs_i64.restype = i64
        lib.runs_build_flat.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, ci, ci,
                                        vp, vp, vp, vp, vp, vp]
        lib.runs_build_flat.restype = i64
        lib.packed_build_flat.argtypes = [vp, i64, i64, i64, i64, i64, ci, ci,
                                          vp, vp, vp, vp, vp, vp]
        lib.packed_build_flat.restype = i64
        lib.match_sweep.argtypes = [vp, i64, i64, i64, i64, i64,       # packed rows
                                    i64, i64, ci, ci, ci,              # id window, flags
                                    ctypes.c_double, ctypes.c_double, i64,
                                    vp, vp, vp, vp, vp, vp]            # outputs
        lib.match_sweep.restype = i64
        lib.match_flat_core.argtypes = [vp, vp, vp, vp, vp, i64,   # target flat
                                        vp, vp, vp, vp, vp, i64,   # match flat
                                        ctypes.c_double,           # iou_thr
                                        vp, vp, vp,                # per-column stats
                                        vp, vp, i64]               # spill
        lib.match_flat_core.restype = i64
        lib.solve_spill.argtypes = [vp, vp, i64, ctypes.c_double, vp, vp]
        lib.solve_spill.restype = i64
        lib.merge_groups_flat.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp, vp, vp, vp]
        lib.merge_groups_flat.restype = i64
        lib.vote_ranges.argtypes = [vp, i64, i64, vp]
        lib.vote_ranges.restype = i64
        lib.vote_sorted_sets.argtypes = [vp, vp, i64, i64, vp]
        lib.vote_sorted_sets.restype = i64
        lib.chunk_split_ranges.argtypes = [vp, i64, i64, i64, vp, i64]
        lib.chunk_split_ranges.restype = i64
        lib.mask_watershed.argtypes = [vp, i64, vp, i64, vp, i64, vp]
        lib.mask_watershed.restype = None
        lib.gray_watershed.argtypes = [vp, vp, i64, vp, i64, vp, i64, vp]
        lib.gray_watershed.restype = None
        _LIB = lib
        return lib


def available() -> bool:
    """Whether callers take the native path: False only when ``use_native``
    is off; otherwise the library is loaded (built at first use), and a
    failure raises."""
    if not use_native:
        return False
    load()
    return True


def _i64(a) -> np.ndarray:
    """``a`` as an int64 C-contiguous array (no copy when it already is)."""
    if isinstance(a, np.ndarray) and a.dtype == np.int64 and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def connected_components_runs(values, rows, col_starts, col_ends, connectivity=8):
    lib = load()
    values, rows = _i64(values), _i64(rows)
    col_starts, col_ends = _i64(col_starts), _i64(col_ends)
    out = np.empty(len(values), dtype=np.int64)
    lib.cc_runs(_ptr(values), _ptr(rows), _ptr(col_starts), _ptr(col_ends),
                len(values), int(connectivity), _ptr(out))
    return out


def batch_pair_intersection(ranges_flat, row_offsets, pairs, max_threads: int = 0):
    """ranges_flat (R, 2); row_offsets (n_inst + 1,); pairs (k, 2) ->
    (k,) intersections.  ``max_threads`` 0 = auto."""
    lib = load()
    r = _i64(ranges_flat).reshape(-1, 2)
    ro = _i64(row_offsets)
    p = _i64(pairs).reshape(-1, 2)
    out = np.empty(len(p), dtype=np.int64)
    lib.batch_pair_intersection(_ptr(r), _ptr(ro), _ptr(p), len(p), int(max_threads),
                                _ptr(out))
    return out


def fill_ranges(flat: np.ndarray, ranges, value):
    """Paint ``value`` over the [start, end) ``ranges`` of a contiguous
    int32, uint32 or int64 ``flat`` array, in place."""
    lib = load()
    if not flat.flags.c_contiguous:
        raise ValueError("fill_ranges: the target must be C-contiguous")
    r = _i64(ranges).reshape(-1, 2)
    if flat.dtype == np.int32:
        lib.fill_ranges_i32(_ptr(flat), _ptr(r), len(r), ctypes.c_int32(int(value)))
    elif flat.dtype == np.uint32:
        lib.fill_ranges_u32(_ptr(flat), _ptr(r), len(r), ctypes.c_uint32(int(value)))
    elif flat.dtype == np.int64:
        lib.fill_ranges_i64(_ptr(flat), _ptr(r), len(r), int(value))
    else:
        raise TypeError(f"unsupported fill dtype {flat.dtype}")


def chunk_split_ranges(ranges, modulo: int, divisor: int) -> np.ndarray:
    """[start, end) ranges split wherever ``p % modulo`` crosses a multiple
    of ``divisor`` or wraps, so each piece lies in one chunk along that
    axis; (k, 2) int64."""
    lib = load()
    r = _i64(ranges).reshape(-1, 2)
    lens = r[:, 1] - r[:, 0]
    # pieces: one per range, plus one per divisor boundary and per wrap
    # crossed; the kernel returns -1 when the buffer is short
    cap = int(2 * len(r) + (lens // max(divisor, 1)).sum()
              + (lens // max(modulo, 1)).sum() + 8)
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        n = lib.chunk_split_ranges(_ptr(r), len(r), int(modulo), int(divisor), _ptr(out), cap)
        if n >= 0:
            return out[:n].copy()
        cap *= 4


def _watershed_args(mask_flat, marker_locations, neighborhood, output_flat):
    mask = np.ascontiguousarray(mask_flat, dtype=np.uint8).reshape(-1)
    ml, nb = _i64(marker_locations), _i64(neighborhood)
    if output_flat.dtype != np.int64 or not output_flat.flags.c_contiguous:
        raise ValueError("watershed output must be a C-contiguous int64 array")
    if output_flat.size != mask.size or (len(ml) and not 0 <= ml.min() <= ml.max() < mask.size):
        raise ValueError("watershed: output size or marker locations out of range")
    return mask, ml, nb


def mask_watershed(mask_flat, marker_locations, neighborhood, output_flat: np.ndarray):
    """Flood ``output_flat`` (int64, seeded with the markers' labels) over
    the nonzero ``mask_flat`` in insertion order from ``marker_locations``,
    stepping by the flat ``neighborhood`` offsets; in place.  The arrays
    are padded by the caller so that no step leaves them."""
    lib = load()
    mask, ml, nb = _watershed_args(mask_flat, marker_locations, neighborhood, output_flat)
    lib.mask_watershed(_ptr(mask), mask.size, _ptr(ml), len(ml), _ptr(nb), len(nb),
                       _ptr(output_flat))


def gray_watershed(image_flat, mask_flat, marker_locations, neighborhood,
                   output_flat: np.ndarray):
    """``mask_watershed`` in order of (``image_flat`` value, insertion age):
    the priority flood of skimage's watershed."""
    lib = load()
    mask, ml, nb = _watershed_args(mask_flat, marker_locations, neighborhood, output_flat)
    image = np.ascontiguousarray(image_flat, dtype=np.float32).reshape(-1)
    if image.size != mask.size:
        raise ValueError("watershed: image and mask sizes differ")
    lib.gray_watershed(_ptr(image), _ptr(mask), mask.size, _ptr(ml), len(ml), _ptr(nb),
                       len(nb), _ptr(output_flat))


def box_overlap_pairs(boxes1, boxes2=None) -> np.ndarray:
    """(k, 2) index pairs with positive box intersection, sorted
    lexicographically (the dense ``nonzero()`` order)."""
    lib = load()
    b1 = _i64(boxes1)
    b2 = b1 if boxes2 is None else _i64(boxes2)
    nd = b1.shape[1] // 2
    cap = max(65536, 8 * max(len(b1), len(b2)))
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        n_out = lib.box_overlap_pairs(_ptr(b1), len(b1), _ptr(b2), len(b2), nd,
                                      _ptr(out), cap)
        if n_out >= 0:
            pairs = out[:n_out]
            order = np.lexsort((pairs[:, 1], pairs[:, 0]))
            return pairs[order].copy()
        cap *= 4


def extract_runs(seg: np.ndarray):
    """Horizontal runs of a dense 2D label map: (values, rows, col_starts,
    col_ends) int64 arrays of the nonzero runs; None for a dtype other
    than int32, uint32 or int64 (the caller takes the numpy form)."""
    lib = load()
    orig = np.ascontiguousarray(seg)
    seg = orig.view(np.int32) if orig.dtype == np.uint32 else orig
    if seg.dtype == np.int32:
        fn = lib.extract_runs_i32
    elif seg.dtype == np.int64:
        fn = lib.extract_runs_i64
    else:
        return None
    h, w = seg.shape
    cap = min(h * w, max(4096, h * 32))
    while True:
        values = np.empty(cap, dtype=np.int64)
        rows = np.empty(cap, dtype=np.int64)
        cs = np.empty(cap, dtype=np.int64)
        ce = np.empty(cap, dtype=np.int64)
        n = fn(_ptr(seg), h, w, cap, _ptr(values), _ptr(rows), _ptr(cs), _ptr(ce))
        if n == -1:
            # a negative int32 (or uint32 >= 2^31): the int64 kernel takes it
            seg = orig.astype(np.int64)
            fn = lib.extract_runs_i64
            continue
        if n == -2:
            cap = h * w
            continue
        return values[:n].copy(), rows[:n].copy(), cs[:n].copy(), ce[:n].copy()


def _flat_outputs(cap_runs):
    labels = np.empty(cap_runs, dtype=np.int64)
    boxes = np.empty((cap_runs, 4), dtype=np.int64)
    offsets = np.empty(cap_runs + 1, dtype=np.int64)
    starts = np.empty(cap_runs, dtype=np.int64)
    runs = np.empty(cap_runs, dtype=np.int64)
    return labels, boxes, offsets, starts, runs


def runs_build_flat(values, rows, col_starts, col_ends, width: int, min_id: int,
                    max_id: int, force_connected: bool, connectivity: int = 8):
    """Class-window filter + optional connected components + instance
    grouping + RLE canonicalisation over pre-extracted runs.  Returns the
    FlatInstances fields (labels, boxes, offsets, starts, runs)."""
    lib = load()
    values, rows = _i64(values), _i64(rows)
    col_starts, col_ends = _i64(col_starts), _i64(col_ends)
    n = len(values)
    labels, boxes, offsets, starts, runs = _flat_outputs(max(n, 1))
    n_inst = np.zeros(1, dtype=np.int64)
    n_out = lib.runs_build_flat(
        _ptr(values), _ptr(rows), _ptr(col_starts), _ptr(col_ends), n, int(width),
        int(min_id), int(max_id), int(force_connected), int(connectivity),
        _ptr(labels), _ptr(boxes), _ptr(offsets), _ptr(starts), _ptr(runs), _ptr(n_inst))
    k = int(n_inst[0])
    return (labels[:k].copy(), boxes[:k].copy(), offsets[: k + 1].copy(),
            starts[:n_out].copy(), runs[:n_out].copy())


def packed_build_flat(row_buf: np.ndarray, width: int, min_id: int, max_id: int,
                      force_connected: bool, connectivity: int = 8):
    """``runs_build_flat`` straight off one slice of
    ``ops.postprocess.encode_runs_packed`` output ((H, 2R+1) int16 rows of
    [starts | values | count]).  Returns the FlatInstances fields, or the
    string "overflow" when a row exceeded its R-run capacity."""
    lib = load()
    buf = np.ascontiguousarray(row_buf, dtype=np.int16)
    h, twr = buf.shape
    rcap = (twr - 1) // 2
    labels, boxes, offsets, starts, runs = _flat_outputs(max(int(h * rcap), 1))
    n_inst = np.zeros(1, dtype=np.int64)
    n_out = lib.packed_build_flat(
        _ptr(buf), h, rcap, int(width), int(min_id), int(max_id), int(force_connected),
        int(connectivity), _ptr(labels), _ptr(boxes), _ptr(offsets), _ptr(starts),
        _ptr(runs), _ptr(n_inst))
    if n_out == -1:
        return "overflow"
    k = int(n_inst[0])
    return (labels[:k].copy(), boxes[:k].copy(), offsets[: k + 1].copy(),
            starts[:n_out].copy(), runs[:n_out].copy())


def match_sweep(packed_slices: np.ndarray, width: int, min_id: int, max_id: int,
                force_connected: bool, iou_thr: float, ioa_thr: float,
                next_label_start: int, match: bool = True, connectivity: int = 8):
    """One class over a whole sweep in one call: per slice the
    ``packed_build_flat`` build, then (``match``) the forward matching with
    fresh ids from ``next_label_start`` and the backward matching, equal to
    the ``stitch.patterns`` loops.  Without ``match`` the slices are only
    built, as the streamed path treats a class that is not a thing.

    ``packed_slices``: (n_slices, H, 2R+1) int16 rows of
    ``ops.postprocess.encode_runs_packed``.  Returns one FlatInstances
    field tuple (labels, boxes, offsets, starts, runs) per slice, what the
    backward pass hands the trackers, or the string "fallback" when a
    slice overflowed its run capacity or, for a connected class, its id
    window (the per-slice path then raises the proper error)."""
    lib = load()
    buf = np.ascontiguousarray(packed_slices, dtype=np.int16)
    s_n, h, twr = buf.shape
    rcap = (twr - 1) // 2
    run_cap = max(1, int(s_n * h * rcap))
    slice_off = np.empty(s_n + 1, dtype=np.int64)
    labels = np.empty(run_cap, dtype=np.int64)
    boxes = np.empty((run_cap, 4), dtype=np.int64)
    run_off = np.empty(run_cap + 1, dtype=np.int64)
    starts = np.empty(run_cap, dtype=np.int64)
    runs = np.empty(run_cap, dtype=np.int64)
    n = lib.match_sweep(
        _ptr(buf), s_n, h * twr, h, rcap, int(width), int(min_id), int(max_id),
        int(force_connected), int(connectivity), int(match), float(iou_thr),
        float(ioa_thr), int(next_label_start), _ptr(slice_off), _ptr(labels),
        _ptr(boxes), _ptr(run_off), _ptr(starts), _ptr(runs))
    if n < 0:
        return "fallback"
    out = []
    for s in range(s_n):
        k0, k1 = int(slice_off[s]), int(slice_off[s + 1])
        r0, r1 = int(run_off[k0]), int(run_off[k1])
        out.append((labels[k0:k1].copy(), boxes[k0:k1].copy(),
                    run_off[k0:k1 + 1] - r0, starts[r0:r1].copy(), runs[r0:r1].copy()))
    return out


def match_flat_core(tf, mf, iou_thr: float):
    """Matcher core for two FlatInstances: box screen, RLE intersections,
    IoU edges, components, single-candidate assignment and per-column IoA
    statistics in one call.  Returns (matched_row (n2,) with -1 for columns
    not matched here, col_max (n2,) f64, col_arg (n2,), spill (k, 3)
    [comp, row, col], spill_vals (k,)); the spilled components (both sides
    > 1 member) need the exact assignment of ``solve_spill``."""
    lib = load()
    n1, n2 = len(tf.labels), len(mf.labels)
    b1, o1, s1, r1, a1 = (_i64(tf.boxes), _i64(tf.offsets), _i64(tf.starts),
                          _i64(tf.runs), _i64(tf.areas))
    b2, o2, s2, r2, a2 = (_i64(mf.boxes), _i64(mf.offsets), _i64(mf.starts),
                          _i64(mf.runs), _i64(mf.areas))
    matched_row = np.empty(n2, dtype=np.int64)
    col_max = np.empty(n2, dtype=np.float64)
    col_arg = np.empty(n2, dtype=np.int64)
    cap = 1024
    while True:
        spill = np.empty((cap, 3), dtype=np.int64)
        spill_vals = np.empty(cap, dtype=np.float64)
        n_spill = lib.match_flat_core(
            _ptr(b1), _ptr(o1), _ptr(s1), _ptr(r1), _ptr(a1), n1,
            _ptr(b2), _ptr(o2), _ptr(s2), _ptr(r2), _ptr(a2), n2,
            float(iou_thr), _ptr(matched_row), _ptr(col_max), _ptr(col_arg),
            _ptr(spill), _ptr(spill_vals), cap)
        if n_spill >= 0:
            return matched_row, col_max, col_arg, spill[:n_spill], spill_vals[:n_spill]
        cap *= 8


def merge_groups_flat(starts, runs, offsets, boxes, member_order, member_bounds):
    """Collision-group merge: per group, gather the members' runs, union
    them and reduce the enclosing box.  Returns (starts, runs, offsets,
    boxes) of the merged groups."""
    lib = load()
    starts, runs, offsets, boxes = _i64(starts), _i64(runs), _i64(offsets), _i64(boxes)
    member_order, member_bounds = _i64(member_order), _i64(member_bounds)
    n_groups = len(member_bounds) - 1
    out_starts = np.empty(len(starts), dtype=np.int64)
    out_runs = np.empty(len(starts), dtype=np.int64)
    out_offsets = np.empty(n_groups + 1, dtype=np.int64)
    out_boxes = np.empty((n_groups, 4), dtype=np.int64)
    n = lib.merge_groups_flat(
        _ptr(starts), _ptr(runs), _ptr(offsets), _ptr(boxes), _ptr(member_order),
        _ptr(member_bounds), n_groups, _ptr(out_starts), _ptr(out_runs),
        _ptr(out_offsets), _ptr(out_boxes))
    return out_starts[:n], out_runs[:n], out_offsets, out_boxes


def solve_spill(spill: np.ndarray, spill_vals: np.ndarray, iou_thr: float):
    """Exact maximum-IoU assignment of ``match_flat_core``'s spilled
    components (shortest augmenting paths, the algorithm family of scipy's
    ``linear_sum_assignment``).  Returns (rows, cols) of the assignments
    that clear ``iou_thr``."""
    lib = load()
    if len(spill) == 0:
        e = np.empty(0, np.int64)
        return e, e
    order = np.argsort(spill[:, 0], kind="stable")
    sp = _i64(spill[order])
    sv = np.ascontiguousarray(spill_vals[order], dtype=np.float64)
    out_r = np.empty(len(sp), dtype=np.int64)
    out_c = np.empty(len(sp), dtype=np.int64)
    n = lib.solve_spill(_ptr(sp), _ptr(sv), len(sp), float(iou_thr), _ptr(out_r),
                        _ptr(out_c))
    return out_r[:n], out_c[:n]


def vote_ranges(ranges, vote_thr: int) -> np.ndarray:
    """Sorted disjoint (k, 2) ranges of the indices that at least
    ``vote_thr`` of the (n, 2) ``ranges`` cover, in any input order (the
    event sweep sorts); touching output ranges coalesce."""
    lib = load()
    r = _i64(ranges).reshape(-1, 2)
    out = np.empty((max(len(r), 1), 2), dtype=np.int64)
    n_out = lib.vote_ranges(_ptr(r), len(r), int(vote_thr), _ptr(out))
    return out[:n_out].copy()


def vote_sorted_sets(list_of_ranges, vote_thr: int) -> np.ndarray:
    """``vote_ranges`` over k range sets each sorted and disjoint (valid
    RLEs), by a k-way event merge with no sort; the caller checks that each
    set is sorted and disjoint.  ``vote_thr`` 1 is the union."""
    lib = load()
    arrs = [_i64(r).reshape(-1, 2) for r in list_of_ranges]
    if not arrs:
        return np.empty((0, 2), dtype=np.int64)
    offsets = np.zeros(len(arrs) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in arrs], out=offsets[1:])
    flat = _i64(np.concatenate(arrs))
    out = np.empty((max(int(offsets[-1]), 1), 2), dtype=np.int64)
    n_out = lib.vote_sorted_sets(_ptr(flat), _ptr(offsets), len(arrs), int(vote_thr),
                                 _ptr(out))
    return out[:n_out].copy()
