"""ctypes bindings to the port's native host library (counterpart of
``empanada_tpu/core/native.py``).

The library is ``csrc/core_kernels.cpp`` (a copy of the JAX package's host
kernels) and the decoders of ``data/imread.py``, ``data/raster.py``,
``data/plugins.py``, ``data/icons.py`` and ``data/textures.py``:
``csrc/image_codecs.cpp`` (TIFF LZW and PackBits; GIF LZW, BMP RLE8 and
RLE4, TGA RLE, Sun raster RLE; SGI RLE, PCX RLE, QOI, MSP version 2 rows,
Radiance HDR scanlines, IM's samples of 2 to 31 bits; PSD's PackBits rows,
ICNS's RGB runs), ``csrc/zstd_decode.cpp`` (ZSTD), ``csrc/jpeg_decode.cpp``
(JPEG), ``csrc/webp_decode.cpp`` (WebP's VP8L, VP8 and ALPH), ``csrc/j2k_decode.cpp`` (JPEG 2000 codestreams) and
``csrc/bcn_decode.cpp`` (the texture blocks BC1-BC7 of ``data/textures.py``) and
``csrc/ccitt_decode.cpp`` (TIFF's CCITT bilevel strips and tiles),
compiled at first use with the host C++ compiler into
``empanada_tpu_torch/build/`` and named by a hash of the sources and
flags.  No floating-point contraction is allowed (``-ffp-contract=off``),
so that the JPEG 2000 decoder's float32 wavelet and colour transforms
round as OpenJPEG's do on any host.  A failed build or load raises:
nothing falls back silently.  The numpy formulations in the calling
modules run only when ``use_native`` is set to False (the tests hold both
paths to the JAX package); the decoders have none.

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
    "lzw_decode",
    "packbits_decode",
    "zstd_decode",
    "ccitt_decode",
    "ccitt_runs",
    "CCITT_STATS",
    "gif_lzw_decode",
    "bmp_rle_decode",
    "tga_rle_decode",
    "sun_rle_decode",
    "sgi_rle_decode",
    "pcx_rle_decode",
    "qoi_decode",
    "msp_decode",
    "hdr_rle_decode",
    "packbits_rows_decode",
    "icns_rle_decode",
    "im_bit_decode",
    "jpeg_decode",
    "jpeg_info",
    "JpegRefused",
    "webp_info",
    "webp_decode",
    "webp_alpha",
    "j2k_info",
    "j2k_decode",
    "j2k_tables",
    "bcn_layout",
    "bcn_decode",
]

# False routes every caller to its numpy formulation
use_native = True

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_PKG, "csrc", name) for name in (
    "core_kernels.cpp", "image_codecs.cpp", "jpeg_decode.cpp", "webp_decode.cpp",
    "zstd_decode.cpp", "j2k_decode.cpp", "bcn_decode.cpp", "ccitt_decode.cpp")]
_BUILD = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared", "-ffp-contract=off"]

_LIB = None
_lock = threading.Lock()


def _compile() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            digest.update(f.read())
    so = os.path.join(_BUILD, f"libempanada_core-{digest.hexdigest()[:12]}.so")
    if os.path.isfile(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++/c++) to build "
                           f"{', '.join(_SRCS)}; set use_native = False for the numpy path")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_SRCS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {', '.join(_SRCS)} failed:\n{proc.stdout}{proc.stderr}")
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
        for name in ("lzw_decode", "packbits_decode", "zstd_decode", "sun_rle_decode"):
            getattr(lib, name).argtypes = [vp, i64, vp, i64]
            getattr(lib, name).restype = i64
        lib.ccitt_decode.argtypes = [vp, i64, ci, i64, i64, ci, vp, vp, vp, i64, vp]
        lib.ccitt_decode.restype = i64
        lib.gif_lzw_decode.argtypes = [vp, i64, ci, vp, i64]
        lib.gif_lzw_decode.restype = i64
        lib.bmp_rle_decode.argtypes = [vp, i64, i64, i64, ci, vp]
        lib.bmp_rle_decode.restype = i64
        lib.tga_rle_decode.argtypes = [vp, i64, ci, i64, vp, i64]
        lib.tga_rle_decode.restype = i64
        lib.sgi_rle_decode.argtypes = [vp, i64, vp, vp, i64, i64, ci, ci, vp, vp]
        lib.sgi_rle_decode.restype = i64
        lib.packbits_rows_decode.argtypes = [vp, i64, i64, i64, vp]
        lib.packbits_rows_decode.restype = i64
        lib.icns_rle_decode.argtypes = [vp, i64, i64, vp]
        lib.icns_rle_decode.restype = ci
        lib.im_bit_decode.argtypes = [vp, i64, ci, i64, i64, vp]
        lib.im_bit_decode.restype = ci
        lib.pcx_rle_decode.argtypes = [vp, i64, i64, i64, vp]
        lib.pcx_rle_decode.restype = i64
        lib.qoi_decode.argtypes = [vp, i64, i64, vp]
        lib.qoi_decode.restype = i64
        lib.msp_decode.argtypes = [vp, i64, vp, i64, i64, vp, i64]
        lib.msp_decode.restype = i64
        lib.hdr_rle_decode.argtypes = [vp, i64, i64, i64, vp, vp]
        lib.hdr_rle_decode.restype = ci
        lib.jpeg_info.argtypes = [vp, i64, vp, i64, ci, ci, vp, ctypes.c_char_p, i64]
        lib.jpeg_info.restype = ci
        lib.jpeg_decode.argtypes = [vp, i64, vp, i64, ci, ci, ci, ci, ci, vp, i64,
                                    ctypes.c_char_p, i64]
        lib.jpeg_decode.restype = ci
        for name in ("webp_vp8l_info", "webp_vp8_info"):
            getattr(lib, name).argtypes = [vp, i64, vp, ctypes.c_char_p, i64]
            getattr(lib, name).restype = ci
        for name in ("webp_vp8l_decode", "webp_vp8_decode"):
            getattr(lib, name).argtypes = [vp, i64, vp, i64, vp, ctypes.c_char_p, i64]
            getattr(lib, name).restype = ci
        lib.webp_alph_decode.argtypes = [vp, i64, i64, i64, vp, ctypes.c_char_p, i64]
        lib.webp_alph_decode.restype = ci
        lib.j2k_info.argtypes = [vp, i64, vp, ctypes.c_char_p, i64]
        lib.j2k_info.restype = ci
        lib.j2k_decode.argtypes = [vp, i64, vp, i64, vp, ctypes.c_char_p, i64]
        lib.j2k_decode.restype = ci
        lib.j2k_tables.argtypes = [vp, i64]
        lib.j2k_tables.restype = i64
        lib.bcn_layout.argtypes = [ci, vp]
        lib.bcn_layout.restype = ci
        lib.bcn_decode.argtypes = [vp, i64, ci, ci, i64, i64, vp]
        lib.bcn_decode.restype = i64
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


def _decode(name: str, data, size: int) -> tuple:
    """(bytes decoded, count or -1) of one strip by the library's
    ``name``, into a buffer of ``size`` bytes it never writes past."""
    fn = getattr(load(), name)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    return out, int(fn(_ptr(src), len(src), _ptr(out), size))


def lzw_decode(data, size: int) -> tuple:
    """TIFF LZW (compression 5) of one strip or tile: (buffer of ``size``
    bytes, bytes written, or -1 - the bytes written before a code the
    stream cannot hold)."""
    return _decode("lzw_decode", data, size)


def packbits_decode(data, size: int) -> tuple:
    """PackBits (compression 32773) of one strip or tile as libtiff's
    PackBitsDecode reads it: (buffer of ``size`` bytes, bytes written; a
    literal run cut by the data's end is not copied)."""
    return _decode("packbits_decode", data, size)


def zstd_decode(data, size: int) -> tuple:
    """ZSTD (TIFF compression 50000) of one strip or tile, as ``lzw_decode``;
    -2 for a frame that needs a dictionary."""
    return _decode("zstd_decode", data, size)


# the codes ``ccitt_decode`` counts into ``stats``, in its order
CCITT_STATS = ("pass", "horizontal", "V0", "VR1", "VR2", "VR3", "VL1", "VL2", "VL3",
               "terminating", "make-up", "extended make-up", "EOL", "bad code")


def ccitt_runs(width: int, compression: int, t4_options: int = 0) -> np.ndarray:
    """libtiff's run arrays for a page's CCITT strips or tiles of ``width``
    pixels (``ccitt_decode``'s ``runs``), zeroed as its codec sets them up."""
    n = (width + 1 + 31) // 32 * 32 * (2 if compression == 4 or t4_options & 1 else 1)
    return np.zeros(2 * n + 2, np.uint32)


def ccitt_decode(data, compression: int, width: int, rows: int, t4_options: int = 0,
                 state: np.ndarray | None = None, runs: np.ndarray | None = None,
                 stats: np.ndarray | None = None) -> tuple:
    """CCITT bilevel data of one strip or tile as libtiff's fax decoders
    read it (``csrc/ccitt_decode.cpp``): compression 2 (Modified Huffman,
    rows byte-aligned), 32771 (the same, rows on 16-bit words of the
    strip), 3 (T.4: 2D where ``t4_options`` bit 0 is set) or 4 (T.6).  (``rows`` rows of ``width`` bits, each padded to a byte, 1
    for black; the bytes written, or -1 - the bytes of the rows written
    before libtiff's decoder fails).  ``state`` (int32 [1]) and ``runs``
    (``ccitt_runs``) carry libtiff's codec state from strip to strip of a
    page; ``stats`` (int64, one count per ``CCITT_STATS``) adds the codes
    read."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    mode = state if state is not None else np.zeros(1, np.int32)
    runs = runs if runs is not None else ccitt_runs(width, compression, t4_options)
    got = int(lib.ccitt_decode(_ptr(src), len(src), int(compression), int(width), int(rows),
                               int(t4_options), _ptr(out), _ptr(mode), _ptr(runs), runs.size,
                               None if stats is None else _ptr(stats)))
    return out, got


def sun_rle_decode(data, size: int) -> tuple:
    """Sun raster's byte encoding (type 2) of one image, as ``lzw_decode``."""
    return _decode("sun_rle_decode", data, size)


def gif_lzw_decode(data, min_size: int, size: int) -> tuple:
    """GIF LZW of one frame's joined sub-blocks at LZW minimum code size
    ``min_size``: (buffer of ``size`` indices, indices written or -1 on a
    code the stream cannot hold)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    return out, int(lib.gif_lzw_decode(_ptr(src), len(src), int(min_size), _ptr(out), size))


def bmp_rle_decode(data, width: int, height: int, rle4: bool) -> tuple:
    """BMP RLE8 (or RLE4) of one bitmap: ((height, width) indices in the
    file's row order, skipped pixels 0; pixels up to the last one drawn or
    skipped, or -1 on a run or move that leaves its row)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((height, width), np.uint8)
    return out, int(lib.bmp_rle_decode(_ptr(src), len(src), int(width), int(height),
                                       int(bool(rle4)), _ptr(out)))


def tga_rle_decode(data, bpp: int, row: int, size: int) -> tuple:
    """TGA RLE of one image of ``bpp``-byte pixels and ``row``-byte rows,
    as ``lzw_decode``; -1 on a repeated pixel's packet that crosses its
    row."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    return out, int(lib.tga_rle_decode(_ptr(src), len(src), int(bpp), int(row), _ptr(out), size))


def sgi_rle_decode(data, starts, lengths, width: int, height: int, bands: int,
                   bpc: int) -> tuple:
    """SGI RLE as PIL reads it (``csrc/image_codecs.cpp``): ``data`` the
    file after its 512-byte header, ``starts`` and ``lengths`` its tables
    (row + channel * height): ((height, width * bands * bpc) bytes in the
    file's row order, rows not reached 0; the rows read, or -1 where PIL
    refuses the data)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    st = np.ascontiguousarray(starts, np.uint32)
    ln = np.ascontiguousarray(lengths, np.uint32)
    row = np.empty(width * bands * bpc, np.uint8)
    out = np.zeros((height, width * bands * bpc), np.uint8)
    return out, int(lib.sgi_rle_decode(_ptr(src), len(src), _ptr(st), _ptr(ln), int(width),
                                       int(height), int(bands), int(bpc), _ptr(row), _ptr(out)))


def pcx_rle_decode(data, row_bytes: int, rows: int) -> tuple:
    """PCX RLE into ``rows`` rows of ``row_bytes``: (buffer, bytes written or
    -1 on a run that crosses its row)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(row_bytes * rows, np.uint8)
    return out, int(lib.pcx_rle_decode(_ptr(src), len(src), int(row_bytes), int(rows),
                                       _ptr(out)))


def qoi_decode(data, pixels: int) -> tuple:
    """A QOI op stream as PIL reads it: ((pixels, 4) RGBA, pixels written;
    fewer when an op is cut short or the stream ends)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((pixels, 4), np.uint8)
    return out, int(lib.qoi_decode(_ptr(src), len(src), int(pixels), _ptr(out)))


def msp_decode(data, rowmap, stride: int, size: int) -> tuple:
    """MSP version 2 rows (``data`` the file after its row map ``rowmap``)
    as PIL joins them: (buffer of ``size`` bytes, bytes written or -1 where
    PIL refuses a row)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    rm = np.ascontiguousarray(rowmap, np.uint16)
    out = np.zeros(size, np.uint8)
    return out, int(lib.msp_decode(_ptr(src), len(src), _ptr(rm), len(rm), int(stride),
                                   _ptr(out), size))


def hdr_rle_decode(data, width: int, height: int) -> tuple:
    """Radiance HDR scanlines as cv2 reads them: ((height, width, 4) RGBE,
    0, -1 when the data ends first or -2 for a damaged scanline)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((height, width, 4), np.uint8)
    line = np.empty(4 * width, np.uint8)
    return out, int(lib.hdr_rle_decode(_ptr(src), len(src), int(width), int(height), _ptr(out),
                                       _ptr(line)))


def packbits_rows_decode(data, row: int, rows: int) -> tuple:
    """A PSD channel's PackBits as PIL's decoder reads it
    (``csrc/image_codecs.cpp``): ((rows, row) bytes, bytes read or -1 when
    the data ends first)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((rows, row), np.uint8)
    return out, int(lib.packbits_rows_decode(_ptr(src), len(src), int(row), int(rows), _ptr(out)))


def icns_rle_decode(data, size: int) -> tuple:
    """ICNS's run-length RGB planes of ``size`` samples each as PIL's
    ``read_32`` reads them: ((3, size) bytes, 0, or -1 where PIL raises)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((3, size), np.uint8)
    return out, int(lib.icns_rle_decode(_ptr(src), len(src), int(size), _ptr(out)))


def im_bit_decode(data, bits: int, width: int, height: int) -> tuple:
    """IM samples of ``bits`` bits (2-31) as PIL's bit decoder reads them:
    ((height, width) float32, 0, or -1 when the data ends first)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((height, width), np.float32)
    return out, int(lib.im_bit_decode(_ptr(src), len(src), int(bits), int(width), int(height),
                                      _ptr(out)))


# where a JPEG stream's data ends (csrc/jpeg_decode.cpp): a TIFF strip read
# strictly (every libjpeg warning raises), PIL's suspending source, cv2's
# jpeg_stdio_src (an endless fake EOI)
JPEG_SOURCES = {"strict": 0, "pil": 1, "cv2": 2}


class JpegRefused(ValueError):
    """A JPEG form libjpeg reads and the port refuses by name."""


def _jpeg_error(code: int, err) -> ValueError:
    return (JpegRefused if code == -2 else ValueError)(err.value.decode())


def jpeg_info(data, tables=b"", source: str = "strict", cmyk: bool = False) -> tuple:
    """(height, width, components) of the JPEG stream ``data`` from its
    headers alone (after the tables stream ``tables``), without decoding or
    allocating its samples, as the ``source`` (``JPEG_SOURCES``) reads
    them; ``cmyk`` reads 4 components.  A form the decoder refuses raises
    ValueError with the reason."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    tab = np.frombuffer(tables, np.uint8)
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(256)
    code = lib.jpeg_info(_ptr(tab), len(tab), _ptr(src), len(src), JPEG_SOURCES[source],
                         int(cmyk), _ptr(info), err, 256)
    if code:
        raise _jpeg_error(code, err)
    return tuple(int(v) for v in info)


def jpeg_decode(data, tables=b"", color: int = 0, sampling=(0, 0),
                source: str = "strict", cmyk: bool = False) -> np.ndarray:
    """The (H, W, C) uint8 samples of the JPEG stream ``data`` (C 1 or 3;
    4 where ``cmyk``: each plane as it is stored),
    after the tables stream ``tables`` (a TIFF's JPEGTables); ``color`` 0
    converts YCbCr to RGB by libjpeg's colour-space rule, 1 never (a TIFF
    of photometric min-is-black or RGB), 2 always (photometric YCbCr);
    ``sampling`` (h, v), when given, is the first component's sampling
    factors a TIFF requires (the others' 1 x 1), as libtiff checks them;
    ``source`` says how damaged data and the stream's end read: "strict"
    raises at any libjpeg warning, "pil" and "cv2" read as those oracles'
    libjpeg sources do (csrc/jpeg_decode.cpp).  A form the decoder refuses,
    or data it cannot read, raises ValueError with the reason (a
    ``JpegRefused`` for a form libjpeg reads and the port does not)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    tab = np.frombuffer(tables, np.uint8)
    out = np.empty(jpeg_info(data, tables, source, cmyk), np.uint8)
    err = ctypes.create_string_buffer(256)
    code = lib.jpeg_decode(_ptr(tab), len(tab), _ptr(src), len(src), JPEG_SOURCES[source],
                           int(cmyk), int(color), int(sampling[0]), int(sampling[1]), _ptr(out),
                           out.size, err, 256)
    if code:
        raise _jpeg_error(code, err)
    return out


_WEBP = {"VP8L": "webp_vp8l", "VP8 ": "webp_vp8"}


def webp_info(tag: str, data) -> tuple:
    """(width, height, alpha hint) of the payload ``data`` of a ``VP8L`` or
    ``VP8 `` chunk (the hint 0 for VP8), from its headers alone: VP8L's
    transforms and prefix codes, VP8's frame header and first partition's
    header, which must be able to hold the frame's macroblocks.  A form the
    decoder refuses raises ValueError with the reason."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(256)
    if getattr(lib, _WEBP[tag] + "_info")(_ptr(src), len(src), _ptr(info), err, 256):
        raise ValueError(err.value.decode())
    return tuple(int(v) for v in info)


def webp_decode(tag: str, data, stats: np.ndarray | None = None) -> np.ndarray:
    """The (H, W, 4) RGBA samples of a ``VP8L`` or ``VP8 `` chunk's payload
    (VP8: alpha 255), as libwebp decodes them; raises ValueError as
    ``webp_info``.  ``stats``, an int64 array of 8, receives what the
    stream used (``csrc/webp_decode.cpp``; the tests' coverage)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    w, h, _ = webp_info(tag, data)
    out = np.empty((h, w, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    if stats is not None and (stats.dtype != np.int64 or stats.size < 8
                              or not stats.flags.c_contiguous):
        raise ValueError("stats must be a C-contiguous int64 array of 8 or more")
    if getattr(lib, _WEBP[tag] + "_decode")(_ptr(src), len(src), _ptr(out), out.size,
                                            None if stats is None else _ptr(stats), err, 256):
        raise ValueError(err.value.decode())
    return out


def webp_alpha(data, width: int, height: int) -> np.ndarray:
    """The (height, width) alpha plane of an ALPH chunk's payload: raw or
    VP8L-compressed, then unfiltered; raises ValueError with the reason."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.webp_alph_decode(_ptr(src), len(src), int(width), int(height), _ptr(out), err, 256):
        raise ValueError(err.value.decode())
    return out


# what ``j2k_decode``'s stats count, in the order of csrc/j2k_decode.cpp's Stat
J2K_STATS = ("progressions", "run modes", "5/3", "9/7", "RCT", "ICT", "cut short", "multi-layer",
             "tile offset", "subsampled", "SOP", "tiles")


def j2k_info(data) -> dict:
    """The headers of the JPEG 2000 codestream ``data`` (its SIZ, and every
    main-header and tile-part marker checked, nothing decoded): ``area``
    (x0, y0, x1, y1), ``rsiz``, ``tiles`` (grid x0, y0, width, height,
    across, down) and ``comps``, a dict of each component's ``prec``,
    ``sgnd``, ``dx``, ``dy`` and ``area`` (x0, y0, width, height).  A form
    the decoder refuses raises ValueError with the reason."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(44, np.int64)
    err = ctypes.create_string_buffer(256)
    if lib.j2k_info(_ptr(src), len(src), _ptr(info), err, 256):
        raise ValueError(err.value.decode())
    v = [int(x) for x in info]
    comps = [dict(prec=v[12 + 8 * c], sgnd=v[13 + 8 * c], dx=v[14 + 8 * c], dy=v[15 + 8 * c],
                  area=tuple(v[16 + 8 * c:20 + 8 * c])) for c in range(v[4])]
    return dict(area=tuple(v[:4]), rsiz=v[5], tiles=tuple(v[6:12]), comps=comps)


def j2k_decode(data, stats: np.ndarray | None = None) -> list:
    """Each component of the JPEG 2000 codestream ``data`` as OpenJPEG
    decodes it: a (height, width) plane of its area, of the samples'
    two's-complement bits (uint8 where every precision is up to 8 bits, else
    uint16), as OpenJPEG's tile data holds them; raises ValueError as
    ``j2k_info``.  ``stats``, an int64 array of ``len(J2K_STATS)``,
    receives what the stream used (the tests' coverage)."""
    lib = load()
    head = j2k_info(data)
    wide = max(c["prec"] for c in head["comps"]) > 8
    sizes = [c["area"][2] * c["area"][3] for c in head["comps"]]
    out = np.empty(sum(sizes), np.uint16 if wide else np.uint8)
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    if stats is not None and (stats.dtype != np.int64 or stats.size < len(J2K_STATS)
                              or not stats.flags.c_contiguous):
        raise ValueError(f"stats must be a C-contiguous int64 array of {len(J2K_STATS)} or more")
    if lib.j2k_decode(_ptr(src), len(src), _ptr(out), out.nbytes,
                      None if stats is None else _ptr(stats), err, 256):
        raise ValueError(err.value.decode())
    planes, at = [], 0
    for c, n in zip(head["comps"], sizes):
        planes.append(out[at:at + n].reshape(c["area"][3], c["area"][2]))
        at += n
    return planes


def j2k_tables() -> bytes:
    """The JPEG 2000 decoder's constant tables (``csrc/j2k_decode.cpp``'s
    ``j2k_tables``), for the tests to find in the installed libopenjp2."""
    lib = load()
    out = np.zeros(8192, np.uint8)
    n = int(lib.j2k_tables(_ptr(out), out.size))
    return out[:n].tobytes()


def bcn_layout(fmt: int) -> tuple:
    """(bytes a block, channels a pixel) of BC``fmt`` (1-7), from
    ``csrc/bcn_decode.cpp``'s own table."""
    out = np.zeros(2, np.int64)
    if load().bcn_layout(int(fmt), _ptr(out)) < 0:
        raise ValueError(f"BC{fmt} is not a BCn format")
    return int(out[0]), int(out[1])


def bcn_decode(data, fmt: int, width: int, height: int, signed: bool = False,
               rule: str = "pil") -> np.ndarray:
    """The (height, width, channels) surface of BC``fmt`` blocks (1-7) in
    ``data``, decoded as PIL's C decoder does (``rule="pil"``), or BC1-BC3
    as ``BlpImagePlugin``'s Python does (``rule="blp"``: every block whole,
    (4 * block rows, 4 * blocks a row, 4)).  ``signed``: BC4, BC5 or BC6H
    of signed samples.  The data must hold every block."""
    lib = load()
    size, channels = bcn_layout(fmt)
    bw, bh = -(-width // 4), -(-height // 4)
    src = np.frombuffer(data, np.uint8)
    if len(src) < bw * bh * size:
        raise ValueError(f"BC{fmt} data of {len(src)} bytes, not {bw * bh * size}")
    shape = (4 * bh, 4 * bw, 4) if rule == "blp" else (height, width, channels)
    out = np.empty(shape, np.uint8)
    flags = int(signed) | (2 if rule == "blp" else 0)
    if lib.bcn_decode(_ptr(src), len(src), fmt, flags, width, height, _ptr(out)) < 0:
        raise ValueError(f"BC{fmt} under the {rule} rule is not a BCn form")
    return out
