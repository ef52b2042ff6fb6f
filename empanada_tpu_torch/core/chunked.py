"""Chunked on-disk volume store, zarr-v2 compatible (counterpart of
``empanada_tpu/core/chunked.py``, byte-identical to it on disk).

A store is a directory holding a ``.zarray`` JSON metadata file and one
C-order file per chunk, named ``i.j.k``.  With ``compressor: null`` it is a
zarr v2 array, so a volume written here opens in any zarr reader and in
the JAX package, and the reverse.  Chunks compressed by one of the numcodecs
codecs whose stream format the Python standard library decodes (``zlib``,
``gzip``, ``bz2``, ``lzma``) are read and written too.  Any other store
raises ``UnsupportedStoreError``: the port does not depend on ``zarr``
(where the JAX package would hand such a store to ``zarr``).

``chunked_fill_instances`` fills RLE instances chunk by chunk: the ranges
are split at chunk boundaries (``native.chunk_split_ranges``), grouped per
chunk, and each chunk is read, painted and written once, chunks in
parallel threads.
"""

from __future__ import annotations

import bz2
import gzip
import json
import lzma
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.ranges import rle_to_ranges

__all__ = ["ChunkedArray", "UnsupportedStoreError", "open_chunked", "create_chunked",
           "chunked_fill_instances"]

_DTYPE_MAP = {
    "|u1": np.uint8, "<u2": np.uint16, "<u4": np.uint32, "<u8": np.uint64,
    "|i1": np.int8, "<i2": np.int16, "<i4": np.int32, "<i8": np.int64,
    "<f4": np.float32, "<f8": np.float64,
}


def _dtype_str(dtype) -> str:
    dtype = np.dtype(dtype)
    return ("|" if dtype.itemsize == 1 else "<") + dtype.str[1:]


class UnsupportedStoreError(RuntimeError):
    """A store whose metadata the built-in zarr-v2 reader cannot handle."""


def _lzma_compress(buf: bytes, cfg: dict) -> bytes:
    # numcodecs LZMA's default: the XZ container, preset from the config
    filters = [{"id": lzma.FILTER_LZMA2, "preset": cfg.get("preset") or 1}]
    return lzma.compress(buf, format=cfg.get("format", lzma.FORMAT_XZ), filters=filters)


# numcodecs codec id -> (compress(bytes, cfg), decompress(bytes))
_CODECS = {
    "zlib": (lambda buf, cfg: zlib.compress(buf, cfg.get("level", 1)), zlib.decompress),
    # mtime=0 keeps a chunk's bytes the same on every rewrite
    "gzip": (lambda buf, cfg: gzip.compress(buf, compresslevel=cfg.get("level", 1), mtime=0),
             gzip.decompress),
    "bz2": (lambda buf, cfg: bz2.compress(buf, cfg.get("level", 1)), bz2.decompress),
    "lzma": (_lzma_compress, lzma.decompress),
}


def _normalize_compressor(compressor):
    """None, a codec id or a numcodecs config dict -> config dict or None."""
    if compressor is None:
        return None
    if isinstance(compressor, str):
        compressor = {"id": compressor}
    if compressor.get("id") not in _CODECS:
        raise UnsupportedStoreError(f"unsupported compressor {compressor!r}; built-in "
                                    f"codecs: {sorted(_CODECS)}")
    return dict(compressor)


class ChunkedArray:
    """N-d chunked array in a zarr-v2 directory: numpy-style reads and
    writes of step-1 slices and integers, each touching only the chunks it
    crosses."""

    def __init__(self, path: str, shape, chunks, dtype, fill_value=0, compressor=None):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)
        self.dtype = np.dtype(dtype)
        self.fill_value = fill_value
        self.ndim = len(self.shape)
        self.compressor = _normalize_compressor(compressor)

    @classmethod
    def open(cls, path: str) -> "ChunkedArray":
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") not in _CODECS:
            raise UnsupportedStoreError(
                f"{path}: compressed zarr store (compressor={comp!r}); the built-in "
                f"reader decodes {sorted(_CODECS)} and uncompressed v2 only, and the "
                "port does not use the zarr library")
        if meta.get("order", "C") != "C":
            raise UnsupportedStoreError(f"{path}: order={meta.get('order')!r} store; the "
                                        "built-in reader handles C order only")
        if meta.get("filters"):
            raise UnsupportedStoreError(f"{path}: store uses filters={meta['filters']!r}; "
                                        "the built-in reader decodes none")
        dtype = _DTYPE_MAP.get(meta["dtype"]) or np.dtype(meta["dtype"])
        return cls(path, meta["shape"], meta["chunks"], dtype, meta.get("fill_value", 0),
                   compressor=comp)

    @classmethod
    def create(cls, path: str, shape, chunks, dtype, fill_value=0,
               compressor=None) -> "ChunkedArray":
        os.makedirs(path, exist_ok=True)
        arr = cls(path, shape, chunks, dtype, fill_value, compressor=compressor)
        meta = {
            "zarr_format": 2,
            "shape": list(arr.shape),
            "chunks": list(arr.chunks),
            "dtype": _dtype_str(arr.dtype),
            "compressor": arr.compressor,
            "fill_value": (int(fill_value) if np.issubdtype(arr.dtype, np.integer)
                           else fill_value),
            "order": "C",
            "filters": None,
        }
        with open(os.path.join(path, ".zarray"), "w") as f:
            json.dump(meta, f)
        return arr

    @property
    def chunks_per_dim(self):
        return tuple(math.ceil(s / c) for s, c in zip(self.shape, self.chunks))

    def _chunk_path(self, idx) -> str:
        return os.path.join(self.path, ".".join(str(i) for i in idx))

    def _read_chunk(self, idx) -> np.ndarray:
        p = self._chunk_path(idx)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        if self.compressor is None:
            buf = np.fromfile(p, dtype=self.dtype)
        else:
            with open(p, "rb") as f:
                raw = _CODECS[self.compressor["id"]][1](f.read())
            buf = np.frombuffer(raw, dtype=self.dtype).copy()  # writable
        return buf.reshape(self.chunks)

    def _write_chunk(self, idx, data: np.ndarray):
        if data.shape != self.chunks:
            raise ValueError(f"chunk of shape {data.shape}, expected {self.chunks}")
        data = np.ascontiguousarray(data, dtype=self.dtype)
        if self.compressor is None:
            data.tofile(self._chunk_path(idx))
            return
        with open(self._chunk_path(idx), "wb") as f:
            f.write(_CODECS[self.compressor["id"]][0](data.tobytes(), self.compressor))

    def _normalize_sel(self, sel):
        if not isinstance(sel, tuple):
            sel = (sel,)
        sel = sel + (slice(None),) * (self.ndim - len(sel))
        out, squeeze = [], []
        for i, s in enumerate(sel):
            if isinstance(s, (int, np.integer)):
                s = int(s) + (self.shape[i] if s < 0 else 0)
                out.append(slice(s, s + 1))
                squeeze.append(i)
            elif isinstance(s, slice):
                start, stop, step = s.indices(self.shape[i])
                if step != 1:
                    raise NotImplementedError("ChunkedArray slicing takes step 1 only")
                out.append(slice(start, stop))
            else:
                raise TypeError(f"unsupported index {s!r}")
        return out, squeeze

    def _iter_chunks(self, sel):
        """(chunk index, slices in the chunk, slices in the selection) of
        every chunk the selection crosses."""
        ranges = []
        for dim, s in enumerate(sel):
            c = self.chunks[dim]
            last = (s.stop - 1) // c if s.stop > s.start else s.start // c - 1
            ranges.append(range(s.start // c, last + 1))
        for chunk_idx in np.ndindex(*(len(r) for r in ranges)):
            chunk_idx = tuple(r[i] for r, i in zip(ranges, chunk_idx))
            chunk_sl, out_sl = [], []
            for dim, (ci, s) in enumerate(zip(chunk_idx, sel)):
                c = self.chunks[dim]
                lo, hi = max(s.start, ci * c), min(s.stop, (ci + 1) * c)
                chunk_sl.append(slice(lo - ci * c, hi - ci * c))
                out_sl.append(slice(lo - s.start, hi - s.start))
            yield chunk_idx, tuple(chunk_sl), tuple(out_sl)

    def __getitem__(self, sel) -> np.ndarray:
        sel, squeeze = self._normalize_sel(sel)
        out_shape = tuple(s.stop - s.start for s in sel)
        out = np.empty(out_shape, dtype=self.dtype)
        for chunk_idx, chunk_sl, out_sl in self._iter_chunks(sel):
            out[out_sl] = self._read_chunk(chunk_idx)[chunk_sl]
        if squeeze:
            out = out.reshape([d for i, d in enumerate(out_shape) if i not in squeeze])
        return out

    def __setitem__(self, sel, value):
        sel, _ = self._normalize_sel(sel)
        out_shape = tuple(s.stop - s.start for s in sel)
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), out_shape)
        for chunk_idx, chunk_sl, out_sl in self._iter_chunks(sel):
            whole = all(c.start == 0 and c.stop == self.chunks[d]
                        for d, c in enumerate(chunk_sl))
            chunk = (np.empty(self.chunks, dtype=self.dtype) if whole
                     else self._read_chunk(chunk_idx))
            chunk[chunk_sl] = value[out_sl]
            self._write_chunk(chunk_idx, chunk)

    def __array__(self, dtype=None, copy=None):
        full = self[tuple(slice(0, s) for s in self.shape)]
        return full.astype(dtype) if dtype is not None else full


def open_chunked(path: str) -> ChunkedArray:
    """Open a zarr-v2 directory store (uncompressed or a stdlib codec);
    any other raises ``UnsupportedStoreError``."""
    return ChunkedArray.open(path)


def create_chunked(path: str, shape, chunks, dtype, fill_value=0,
                   compressor=None) -> ChunkedArray:
    return ChunkedArray.create(path, shape, chunks, dtype, fill_value, compressor=compressor)


def _split_ranges_for_chunks(ranges: np.ndarray, shape, chunks) -> np.ndarray:
    """Flat ranges split so each piece lies within one chunk: along axis i,
    position p is in chunk ``(p % prod(shape[i:])) // (chunks[i] *
    prod(shape[i + 1:]))``."""
    for i in range(len(shape)):
        ranges = native.chunk_split_ranges(ranges, math.prod(shape[i:]),
                                           chunks[i] * math.prod(shape[i + 1:]))
    return ranges


def chunked_fill_instances(array: ChunkedArray, instances: dict, processes: int = 4):
    """Paint ``{instance_id: {"starts", "runs"}}`` into ``array`` in place,
    in dict order within each chunk, chunks in ``processes`` threads."""
    shape, chunks, cpd = array.shape, array.chunks, array.chunks_per_dim
    per_chunk: dict = {}
    for instance_id, attrs in instances.items():
        rle = np.stack([np.asarray(attrs["starts"], np.int64),
                        np.asarray(attrs["runs"], np.int64)], axis=1)
        if len(rle) == 0:
            continue
        ranges = _split_ranges_for_chunks(rle_to_ranges(rle), shape, chunks)
        flat_chunk = np.zeros(len(ranges), dtype=np.int64)
        for i in range(len(shape)):
            coord = (ranges[:, 0] % math.prod(shape[i:])) // (chunks[i]
                                                                * math.prod(shape[i + 1:]))
            flat_chunk = flat_chunk * cpd[i] + coord
        order = np.argsort(flat_chunk, kind="stable")
        ranges, flat_chunk = ranges[order], flat_chunk[order]
        uniq, first = np.unique(flat_chunk, return_index=True)
        for cid, cranges in zip(uniq, np.split(ranges, first[1:])):
            per_chunk.setdefault(int(cid), {})[instance_id] = cranges

    def fill_chunk(cid):
        idx = np.unravel_index(cid, cpd)
        origin = tuple(int(i) * c for i, c in zip(idx, chunks))
        chunk = array._read_chunk(idx)
        flat = chunk.reshape(-1)
        for instance_id, cranges in per_chunk[cid].items():
            # global flat ranges -> the chunk's own flat ranges
            first = np.unravel_index(cranges[:, 0], shape)
            last = np.unravel_index(cranges[:, 1] - 1, shape)
            lstarts = np.ravel_multi_index(tuple(c - o for c, o in zip(first, origin)), chunks)
            lends = np.ravel_multi_index(tuple(c - o for c, o in zip(last, origin)), chunks) + 1
            for s, e in zip(lstarts, lends):
                flat[s:e] = instance_id
        array._write_chunk(tuple(int(i) for i in idx), chunk)

    with ThreadPoolExecutor(max_workers=max(1, min(processes, len(per_chunk) or 1))) as ex:
        list(ex.map(fill_chunk, per_chunk))
