"""The port's tiling and tile merges (``stitch/tile.py``,
``stitch/rle_seg.py``, ``consensus.merge_*_from_tiles``) against the JAX
package's, on the CPU: tile geometry, the overlap RLE, translation into the
image frame, the RLE round trip, and both merges on seeded tile maps whose
objects cross tiles, plus objects that one tile alone sees inside the
overlap (dropped at IoA > 0.1) or outside it (kept).  Ids must be equal,
in the same order."""

import numpy as np
import pytest

from empanada_tpu.stitch import consensus as jax_consensus
from empanada_tpu.stitch import rle_seg as jax_rle_seg
from empanada_tpu.stitch import tile as jax_tile
from empanada_tpu_torch.core import rle as R
from empanada_tpu_torch.stitch import consensus, rle_seg, tile
from test_torch_ortho import assert_same_instances

LABELS, DIVISOR = [1, 2], 1000


@pytest.mark.parametrize("length,size,overlap", [(100, 100, 10), (150, 64, 6), (170, 64, 6),
                                                 (4096, 2048, 128), (1000, 300, 30),
                                                 (31, 64, 6)])
def test_tile_ranges_and_tiler_match_jax(length, size, overlap):
    assert tile.tile_ranges_1d(length, size, overlap) == \
        jax_tile.tile_ranges_1d(length, size, overlap)
    shape = (length, max(1, length * 2 // 3))
    got, want = tile.Tiler(shape, size, overlap), jax_tile.Tiler(shape, size, overlap)
    assert (len(got), got.yranges, got.xranges) == (len(want), want.yranges, want.xranges)
    for g, w in zip(got.overlap_rle, want.overlap_rle):
        np.testing.assert_array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
    np.testing.assert_array_equal(got.overlap_mask(), want.overlap_mask())


def test_overlap_smaller_than_tile():
    with pytest.raises(ValueError, match="overlap"):
        tile.tile_ranges_1d(100, 10, 10)


def _label_map(shape, seed, n=40):
    """Seeded panoptic map: class 1 discs (thing, ids 1001...) over class 2
    stripes (semantic, id 2000); some discs touch, so connected components
    merge them."""
    rng = np.random.default_rng(seed)
    h, w = shape
    pan = np.zeros(shape, np.int64)
    pan[(np.arange(h)[:, None] // 9 + np.arange(w)[None] // 13) % 4 == 0] = 2000
    yy, xx = np.mgrid[:h, :w]
    for k in range(n):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 12)
        pan[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1001 + k
    return pan


def _tile_segs(module_rle, module_tile, pan, size, extra):
    """Per-tile RLE segs translated into the image frame; ``extra`` adds to
    tile 0 a disc that no other tile sees, at (y, x, r)."""
    tiler = module_tile.Tiler(pan.shape, size, min(128, int(size * 0.1)))
    segs = []
    for i in range(len(tiler)):
        crop = tiler(pan, i).copy()
        if i == 0:
            for k, (cy, cx, r) in enumerate(extra):
                yy, xx = np.mgrid[:crop.shape[0], :crop.shape[1]]
                crop[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1900 + k
        seg = module_rle.pan_seg_to_rle_seg(crop, LABELS, DIVISOR, [1])
        segs.append(tiler.translate_rle_seg(seg, i))
    return tiler, segs


@pytest.mark.parametrize("seed,shape,size", [(0, (150, 170), 64), (1, (200, 130), 96),
                                             (2, (90, 260), 64)])
def test_tile_merges_match_jax(seed, shape, size):
    pan = _label_map(shape, seed)
    # two single-tile discs of tile 0 (whose origin is the image's): one in
    # the column overlap at its right edge, one in its own interior, each
    # where no other object is
    extra = [(size // 2, size - 4, 3), (8, 8, 3)]
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for cy, cx, _ in extra:
        pan[((yy - cy) ** 2 + (xx - cx) ** 2 <= 36) & (pan // DIVISOR == 1)] = 0
    tiler, got_segs = _tile_segs(rle_seg, tile, pan, size, extra)
    jtiler, want_segs = _tile_segs(jax_rle_seg, jax_tile, pan, size, extra)
    assert len(tiler) > 3
    for g, w in zip(got_segs, want_segs):
        for label in LABELS:
            assert_same_instances(g[label], w[label])
    got = {1: consensus.merge_objects_from_tiles([s[1] for s in got_segs], tiler.overlap_rle),
           2: consensus.merge_semantic_from_tiles([s[2] for s in got_segs])}
    want = {1: jax_consensus.merge_objects_from_tiles([s[1] for s in want_segs],
                                                      jtiler.overlap_rle),
            2: jax_consensus.merge_semantic_from_tiles([s[2] for s in want_segs])}
    for label in LABELS:
        assert_same_instances(got[label], want[label])
    assert len(got[1]) >= 10 and len(got[2]) == 1
    # the overlap disc is dropped, the interior one kept
    merged = rle_seg.rle_seg_to_pan_seg(got, shape)
    assert [merged[cy, cx] // DIVISOR == 1 for cy, cx, _ in extra] == [False, True]
    np.testing.assert_array_equal(merged, jax_rle_seg.rle_seg_to_pan_seg(want, shape))


def test_translate_splits_wrapping_runs():
    """A flat run that wraps a tile row lands in two rows of the image."""
    shape = (40, 50)
    got, want = tile.Tiler(shape, 20, 4), jax_tile.Tiler(shape, 20, 4)
    seg = lambda: {1: {1001: {"box": (0, 15, 2, 20),  # noqa: E731
                              "starts": np.array([15, 55]), "runs": np.array([8, 3])}}}
    g, w = got.translate_rle_seg(seg(), 4), want.translate_rle_seg(seg(), 4)
    assert_same_instances(g[1], w[1])
    assert len(g[1][1001]["starts"]) == 3


def test_rle_seg_round_trip():
    pan = _label_map((70, 90), 3)
    seg = rle_seg.pan_seg_to_rle_seg(pan, LABELS, DIVISOR, [1], force_connected=False)
    np.testing.assert_array_equal(rle_seg.rle_seg_to_pan_seg(seg, pan.shape), pan)
    want_seg = jax_rle_seg.pan_seg_to_rle_seg(pan, LABELS, DIVISOR, [1], False)
    for label in LABELS:
        got = rle_seg.unpack_rle_attrs(seg[label])
        want = jax_rle_seg.unpack_rle_attrs(want_seg[label])
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[2] + got[3], want[2] + want[3]):
            np.testing.assert_array_equal(g, w)
    strings = {7: {"box": (0, 0, 1, 5), "rle": R.rle_to_string([3, 9], [2, 1])}}
    _, _, starts, runs = rle_seg.unpack_rle_attrs(strings)
    assert starts[0].tolist() == [3, 9] and runs[0].tolist() == [2, 1]


def test_rle_helpers_match_jax():
    from empanada_tpu.core import ranges as jax_ranges
    from empanada_tpu.core import rle as jax_rle
    from empanada_tpu_torch.core import ranges

    rng = np.random.default_rng(4)
    for _ in range(50):
        a = np.sort(rng.choice(500, 40, replace=False))
        b = np.sort(rng.choice(500, 30, replace=False))
        sa, ra = R.rle_encode(a)
        sb, rb = R.rle_encode(b)
        for g, w in zip(R.merge_rles(sa, ra, sb, rb), jax_rle.merge_rles(sa, ra, sb, rb)):
            np.testing.assert_array_equal(g, w)
        assert R.rle_ioa(sa, ra, sb, rb) == jax_rle.rle_ioa(sa, ra, sb, rb)
        assert R.rle_area(ra) == jax_rle.rle_area(ra)
        rng_ranges = np.stack([sa, sa + ra], axis=1)
        np.testing.assert_array_equal(ranges.invert_ranges(rng_ranges, 600),
                                      jax_ranges.invert_ranges(rng_ranges, 600))
        np.testing.assert_array_equal(ranges.rle_to_ranges(np.stack([sa, ra], 1)),
                                      jax_ranges.rle_to_ranges(np.stack([sa, ra], 1)))
    np.testing.assert_array_equal(ranges.invert_ranges(np.empty((0, 2)), 9), [[0, 9]])


def test_label_2d_matches_jax():
    from empanada_tpu.core.labeling import label_2d as jax_label_2d
    from empanada_tpu_torch.core.labeling import label_2d

    pan = _label_map((60, 75), 5)
    for conn in (4, 8):
        np.testing.assert_array_equal(label_2d(pan, conn), jax_label_2d(pan, conn))
