"""The port's chunked store (``core/chunked.py``) against the JAX package's:
round trips with and without each stdlib codec, stores written by either
package read by the other with byte-identical files, the chunk-parallel
instance fill against the numpy fill, the finishes ``stack_postprocessing``
and ``tracker_consensus`` with ``store_url`` against JAX's, store against
store, and the refusal of a codec outside the stdlib set."""

import json
import os

import numpy as np
import pytest

from empanada_tpu import api as jax_api
from empanada_tpu.core import chunked as jax_chunked
from empanada_tpu.stitch import filters as jax_filters
from empanada_tpu.stitch.tracker import InstanceTracker as JaxTracker
from empanada_tpu_torch import api
from empanada_tpu_torch.core import chunked
from empanada_tpu_torch.core.rle import numpy_fill_instances
from empanada_tpu_torch.stitch import filters
from empanada_tpu_torch.stitch.patterns import fill_volume
from empanada_tpu_torch.stitch.tracker import InstanceTracker
from test_torch_ortho import assert_same_instances

CODECS = [None, "zlib", "gzip", "bz2", "lzma"]


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("compressor", CODECS)
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.uint32])
def test_round_trip(tmp_path, compressor, dtype):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 200, (13, 20, 17)).astype(dtype)
    arr = chunked.create_chunked(str(tmp_path / "a"), data.shape, (5, 8, 6), dtype,
                                 compressor=compressor)
    arr[:] = data
    arr[2:9, 3, 4:] = 7  # a partial write across chunks
    data[2:9, 3, 4:] = 7
    back = chunked.open_chunked(str(tmp_path / "a"))
    assert back.dtype == np.dtype(dtype) and back.shape == data.shape
    np.testing.assert_array_equal(np.asarray(back), data)
    np.testing.assert_array_equal(back[4], data[4])
    np.testing.assert_array_equal(back[:, -1, 3:11], data[:, -1, 3:11])
    with pytest.raises(NotImplementedError):
        back[::2]


@pytest.mark.parametrize("compressor", CODECS)
def test_stores_cross_packages(tmp_path, compressor):
    """Either package's store opens in the other with the same contents,
    and the same writes give the same bytes on disk."""
    data = np.random.default_rng(1).integers(0, 9, (9, 11, 10)).astype(np.int32)
    for name, mod in (("port", chunked), ("jax", jax_chunked)):
        arr = mod.create_chunked(str(tmp_path / name), data.shape, (4, 4, 4), np.int32,
                                 compressor=compressor)
        arr[:] = data
    np.testing.assert_array_equal(np.asarray(chunked.open_chunked(str(tmp_path / "jax"))),
                                  data)
    np.testing.assert_array_equal(
        np.asarray(jax_chunked.open_chunked(str(tmp_path / "port"))), data)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    meta = json.loads(_files(tmp_path / "port")[".zarray"])
    assert meta["order"] == "C" and meta["compressor"] == (
        None if compressor is None else {"id": compressor})


def _instances(shape, seed, n=12):
    """Seeded overlapping box instances as ``{id: {box, starts, runs}}``."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.int64)
    for k in range(n):
        lo = [int(rng.integers(0, s - 2)) for s in shape]
        hi = [int(rng.integers(a + 1, min(s, a + 8) + 1)) for a, s in zip(lo, shape)]
        vol[tuple(slice(a, b) for a, b in zip(lo, hi))] = k + 1
    return filters.regions_3d(vol)


@pytest.mark.parametrize("chunks", [(4, 4, 4), (3, 7, 5), (16, 16, 16)])
def test_chunked_fill_equals_numpy_fill(tmp_path, chunks):
    shape = (10, 14, 13)
    inst = _instances(shape, 2)
    want = numpy_fill_instances(np.zeros(shape, np.uint32), inst)
    arr = chunked.create_chunked(str(tmp_path / "f"), shape, chunks, np.uint32)
    fill_volume(arr, inst, processes=3)
    np.testing.assert_array_equal(np.asarray(arr), want)
    jarr = jax_chunked.create_chunked(str(tmp_path / "j"), shape, chunks, np.uint32)
    jax_chunked.chunked_fill_instances(jarr, inst)
    assert _files(tmp_path / "f") == _files(tmp_path / "j")


def test_regions_3d_matches_jax():
    vol = np.zeros((6, 9, 11), np.int64)
    rng = np.random.default_rng(3)
    vol[rng.random(vol.shape) < 0.3] = 5
    vol[2:5, 1:8, 3:10] = 9
    got, want = filters.regions_3d(vol), jax_filters.regions_3d(vol)
    assert_same_instances(got, want)


def _trackers(shape, seeds, port: bool):
    """``{axis: [tracker]}`` of one thing class, the axes' instances from
    seeded box volumes."""
    cls = InstanceTracker if port else JaxTracker
    out = {}
    for axis, seed in zip(("xy", "xz", "yz"), seeds):
        t = cls(1, 1000, shape, axis)
        t.instances = (filters if port else jax_filters).regions_3d(
            _label_volume(shape, seed))
        t.finished = True
        out[axis] = [t]
    return out


def _label_volume(shape, seed):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.int64)
    for k in range(8):
        c = [int(rng.integers(2, s - 2)) for s in shape]
        vol[tuple(slice(max(0, x - 3), x + 3) for x in c)] = 1001 + k
    return vol


CFG = {"class_names": {1: "mito"}, "labels": [1], "thing_list": [1]}


@pytest.mark.parametrize("finish", ["stack", "consensus"])
def test_finishes_write_stores_like_jax(tmp_path, finish):
    shape = (12, 20, 18)
    seeds = (5, 5, 6)  # two axes agree, so the consensus holds instances
    kw = dict(min_size=4, min_extent=1, chunk_size=(5, 8, 8))
    if finish == "stack":
        got = api.stack_postprocessing(_trackers(shape, seeds, True), str(tmp_path / "p"),
                                       CFG, device="cpu", **kw)
        want = jax_api.stack_postprocessing(_trackers(shape, seeds, False),
                                            str(tmp_path / "j"), CFG, **kw)
    else:
        got = api.tracker_consensus(_trackers(shape, seeds, True), str(tmp_path / "p"), CFG,
                                    device="cpu", **kw)
        want = jax_api.tracker_consensus(_trackers(shape, seeds, False),
                                         str(tmp_path / "j"), CFG, **kw)
    (gv, gn, gi), = list(got)
    (wv, wn, wi), = list(want)
    assert gn == wn == "mito" and isinstance(gv, chunked.ChunkedArray)
    assert_same_instances(gi, wi)
    assert len(gi) >= 2
    np.testing.assert_array_equal(np.asarray(gv), np.asarray(wv))
    assert _files(tmp_path / "p" / "mito") == _files(tmp_path / "j" / "mito")
    np.testing.assert_array_equal(
        np.asarray(jax_chunked.open_chunked(str(tmp_path / "p" / "mito"))), np.asarray(wv))


def test_unsupported_codec_raises(tmp_path):
    with pytest.raises(chunked.UnsupportedStoreError):
        chunked.create_chunked(str(tmp_path / "x"), (4, 4), (2, 2), np.uint8,
                               compressor="blosc")
    path = tmp_path / "blosc"
    path.mkdir()
    meta = {"zarr_format": 2, "shape": [4, 4], "chunks": [2, 2], "dtype": "|u1",
            "compressor": {"id": "blosc", "cname": "lz4"}, "fill_value": 0, "order": "C",
            "filters": None}
    (path / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(chunked.UnsupportedStoreError, match="zarr"):
        chunked.open_chunked(str(path))
    meta.update(compressor=None, order="F")
    (path / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(chunked.UnsupportedStoreError, match="order"):
        chunked.open_chunked(str(path))
