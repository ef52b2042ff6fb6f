"""The raster formats the JAX package reads through PIL and cv2, read by
the port (``data/raster.py``) on the CPU at small sizes; every comparison
is exact (tolerance 0): ``imread`` against the JAX package's
``cli._load_array`` (PIL) and ``imread_gray`` against its
``datasets._imread_gray`` (cv2, then PIL), in dtype, shape and every
sample, or both raising, on the same file:

- files PIL writes (BMP and DIB, PBM/PGM/PPM and PFM, GIF single and
  animated, SPIDER, TGA raw and RLE at either origin) for every mode it
  saves them from, and files cv2 writes (BMP, PGM/PPM/PBM binary and
  plain, PFM, PAM, Sun raster, GIF);
- seeded files of ``_raster_writer`` for the forms neither writes: BMP of
  every header (core, 40, 52, 56, 64, V4, V5), palette, bit depth, 16-bit
  and 32-bit bitfields, top-down rows, RLE8 and RLE4; PNM plain and raw
  at odd maxvals, PFM in either byte order and scale, PAM of each tuple
  type; GIF interlaced, offset, transparent, with local and global
  tables, none, and animated with every disposal; SPIDER images and
  stacks in either byte order, volumes and Fourier forms; TGA of every
  type, depth, colour-map depth and origin; Sun raster of each depth,
  type and colour map, byte-encoded;
- where an oracle misreads a file (PIL: a BMP RLE delta, an RLE4 run of
  an odd count, a 4-bit grey palette, a Sun raster's byte-encoded rows of
  odd width; cv2: a Sun raster of 1 or 8 bits without a colour map, a
  PAM of maxval 1) the reader follows the file, and the test pins the
  oracle's difference;
- damaged GIF LZW, BMP RLE8 and RLE4, TGA RLE and Sun byte-encoded data
  raise naming the file (and the GIF frame); a header claiming 65535 x
  65535 on a file of a few bytes is refused before any buffer is
  allocated (and so is one of 13000 x 13000, under PIL's pixel limit, in
  each format of ``data/plugins.py``); the formats the port does not read
  raise naming themselves;
  the writer's encoders round-trip through the host library's decoders.
"""

import io
import os
import struct
import tracemalloc
import warnings
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from _jp2_writer import box, codestream_of, jp2
from _raster_writer import (
    bmp_bytes,
    bmp_rle_row,
    gif_bytes,
    gif_lzw_encode,
    pam_bytes,
    pfm_bytes,
    pnm_bytes,
    spider_bytes,
    sun_bytes,
    sun_rle,
    tga_bytes,
    tga_rle,
)
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import raster
from empanada_tpu_torch.data.imread import imread, imread_gray

H, W = 11, 13


def _outcome(fn, path):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(path)
    except Exception as exc:  # noqa: BLE001  an oracle's refusal, of any type
        return exc


def _held(path: str) -> None:
    """Both readers equal their oracles on ``path``, or raise where they
    raise (cv2's None, then PIL's error, for ``_imread_gray``)."""
    for port, jax in ((imread, jax_load), (imread_gray, jax_gray)):
        want = _outcome(jax, path)
        if want is None or isinstance(want, Exception):
            with pytest.raises(ValueError):
                port(path)
            continue
        got = port(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (port.__name__, got.dtype,
                                                                      got.shape, want.dtype,
                                                                      want.shape)
        np.testing.assert_array_equal(got, want, err_msg=port.__name__)


def _file(tmp_path, name, data) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _rng(key: str):
    return np.random.default_rng(sum(key.encode()))


# ----- files PIL and cv2 write ---------------------------------------------------


def _pil_image(mode, rng):
    g = rng.integers(0, 256, (H, W)).astype(np.uint8)
    if mode == "1":
        return Image.fromarray(g > 127)
    if mode == "P":
        im = Image.fromarray(g % 11, "P")
        im.putpalette(rng.integers(0, 256, 33).tolist())
        return im
    if mode in ("RGB", "RGBA", "LA"):
        return Image.fromarray(rng.integers(0, 256, (H, W, len(mode))).astype(np.uint8), mode)
    if mode == "I":
        return Image.fromarray(g.astype(np.int32) * 250)
    if mode == "I;16":
        return Image.fromarray(g.astype(np.uint16) * 250)
    if mode == "F":
        return Image.fromarray(rng.normal(size=(H, W)).astype(np.float32))
    return Image.fromarray(g)


PIL_SAVES = (
    [("BMP", "bmp", m, {}) for m in ("1", "L", "P", "RGB", "RGBA")]
    + [("DIB", "dib", m, {}) for m in ("1", "L", "P", "RGB", "RGBA")]
    + [("PPM", "pnm", m, {}) for m in ("1", "L", "I", "I;16", "RGB", "RGBA", "F")]
    + [("GIF", "gif", m, kw) for m in ("1", "L", "P", "RGB")
       for kw in ({}, {"interlace": False}, {"transparency": 3})]
    + [("SPIDER", "spi", m, {}) for m in ("L", "F")]
    + [("TGA", "tga", m, kw) for m in ("1", "L", "LA", "P", "RGB", "RGBA")
       for kw in ({}, {"rle": True}, {"orientation": 1}, {"rle": True, "orientation": 1})])


@pytest.mark.parametrize("fmt,ext,mode,kw", PIL_SAVES,
                         ids=[f"{f}-{m}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for f, _, m, kw in PIL_SAVES])
def test_files_pil_writes(fmt, ext, mode, kw, tmp_path):
    im = _pil_image(mode, _rng(fmt + mode + str(kw)))
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    _held(_file(tmp_path, f"x.{ext}", buf.getvalue()))


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_animated_gifs_pil_writes(mode, tmp_path):
    """An animated GIF of grey frames stacks (PIL's mode L); of colour
    frames it raises in both, as ``np.stack`` of PIL's frames does."""
    rng = _rng("anim" + mode)
    frames = [_pil_image(mode, rng) for _ in range(3)]
    if mode == "L":
        frames = [im.convert("L") for im in frames]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], disposal=2,
                   optimize=False)
    path = _file(tmp_path, "x.gif", buf.getvalue())
    _held(path)
    if Image.open(path).mode == "L":
        assert imread(path).shape == (3, H, W)


def _cv2_arrays(rng):
    return {"g": rng.integers(0, 256, (H, W)).astype(np.uint8),
            "g16": rng.integers(0, 65536, (H, W)).astype(np.uint16),
            "c3": rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
            "c4": rng.integers(0, 256, (H, W, 4)).astype(np.uint8),
            "c316": rng.integers(0, 65536, (H, W, 3)).astype(np.uint16),
            "f": rng.normal(size=(H, W)).astype(np.float32),
            "f3": rng.normal(size=(H, W, 3)).astype(np.float32)}


CV2_WRITES = ([("bmp", a, ()) for a in ("g", "c3", "c4")]
              + [(e, a, p) for e, arrs in (("pgm", ("g", "g16")), ("ppm", ("c3", "c316")),
                                           ("pbm", ("g",)))
                 for a in arrs for p in ((), (cv2.IMWRITE_PXM_BINARY, 0))]
              + [("pfm", a, ()) for a in ("f", "f3")]
              + [("pam", a, ()) for a in ("g", "g16", "c3", "c4", "c316")]
              + [(e, a, ()) for e in ("ras", "sr") for a in ("c3",)]
              + [("gif", a, ()) for a in ("c3", "c4")])


@pytest.mark.parametrize("ext,arr,params", CV2_WRITES,
                         ids=[f"{e}-{a}-{'plain' if p else 'raw'}" for e, a, p in CV2_WRITES])
def test_files_cv2_writes(ext, arr, params, tmp_path):
    """cv2's own files (its PAM of 16 bits or 4 samples, which it writes
    without a tuple type, it cannot read back: both refuse)."""
    path = str(tmp_path / f"x.{ext}")
    assert cv2.imwrite(path, _cv2_arrays(_rng(ext + arr))[arr], list(params))
    _held(path)


# ----- BMP -----------------------------------------------------------------------

BMP_PALETTES = [(bits, header, top, kind) for bits in (1, 4, 8)
                for header in (12, 40, 52, 56, 64, 108, 124)
                for top in ((False,) if header == 12 else (False, True))
                for kind in ("colour", "grey", "grey17")
                if not (bits == 4 and kind == "grey")]


@pytest.mark.parametrize("bits,header,top,kind", BMP_PALETTES,
                         ids=[f"{b}bit-h{h}-{'top' if t else 'bottom'}-{k}"
                              for b, h, t, k in BMP_PALETTES])
def test_bmp_palettes(bits, header, top, kind, tmp_path):
    """1-, 4- and 8-bit palettes: colour (PIL's indices, cv2's blue or, of
    a core header, cv2's grey), grey of every index (PIL's L or 1) and
    grey of other levels."""
    rng = _rng(f"bmp{bits}{header}{top}{kind}")
    n = 1 << bits
    idx = rng.integers(0, n, (H, W)).astype(np.uint8)
    pal = {"colour": rng.integers(0, 256, (n, 3)),
           "grey": np.repeat(np.arange(n)[:, None] * (255 if bits == 1 else 1), 3, 1),
           "grey17": np.repeat((np.arange(n)[:, None] * 17) % 256, 3, 1)}[kind]
    _held(_file(tmp_path, "x.bmp", bmp_bytes(idx, bits, palette=pal, header=header,
                                             top_down=top)))


BMP_DEEP = [(bits, header, top) for bits in (16, 24, 32) for header in (12, 40, 56, 108, 124)
            for top in ((False,) if header == 12 else (False, True))]


@pytest.mark.parametrize("bits,header,top", BMP_DEEP,
                         ids=[f"{b}bit-h{h}-{'top' if t else 'bottom'}" for b, h, t in BMP_DEEP])
def test_bmp_deep(bits, header, top, tmp_path):
    """16-bit 5-5-5 (PIL v * 255 // 31, cv2 v << 3; no core header in
    cv2), 24-bit, 32-bit BI_RGB (PIL drops the fourth byte), core headers
    (cv2's grey)."""
    rng = _rng(f"deep{bits}{header}{top}")
    px = (rng.integers(0, 65536, (H, W)).astype(np.uint16) if bits == 16
          else rng.integers(0, 256, (H, W, bits // 8)).astype(np.uint8))
    _held(_file(tmp_path, "x.bmp", bmp_bytes(px, bits, header=header, top_down=top)))
    if bits == 16 and header != 12:
        path = str(tmp_path / "x.bmp")
        b5 = (px & 31).astype(np.uint32)
        np.testing.assert_array_equal(imread(path)[..., 2], b5 * 255 // 31)
        np.testing.assert_array_equal(imread_gray(path), b5 << 3)


MASKS32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
           (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0),
           (0x3FF00000, 0xFFC00, 0x3FF, 0), (0xFF00, 0xFF, 0xFF0000, 0xFF000000)]
BITFIELDS = ([(16, h, m) for h in (40, 56, 124)
              for m in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F), (0xF00, 0xF0, 0xF))]
             + [(24, h, (0xFF0000, 0xFF00, 0xFF)) for h in (40, 124)]
             + [(32, h, m) for h in (40, 52, 56, 108, 124) for m in MASKS32])


@pytest.mark.parametrize("bits,header,masks", BITFIELDS,
                         ids=[f"{b}bit-h{h}-" + "-".join(f"{v:x}" for v in m)
                              for b, h, m in BITFIELDS])
def test_bmp_bitfields(bits, header, masks, tmp_path):
    """Bitfields: the masks PIL reads (others: PIL refuses, cv2 reads the
    32-bit ones); cv2 refuses 16-bit bitfields after a longer header and
    24-bit ones, and takes 32-bit samples through their masks after a
    header of 56 bytes or more."""
    rng = _rng(f"bf{bits}{header}{masks}")
    px = (rng.integers(0, 65536, (H, W)).astype(np.uint16) if bits == 16
          else rng.integers(0, 256, (H, W, bits // 8)).astype(np.uint8))
    _held(_file(tmp_path, "x.bmp", bmp_bytes(px, bits, header=header, compression=3,
                                             masks=masks)))


RLE = [(rle4, kind, width) for rle4 in (False, True) for kind in ("colour", "grey")
       for width in ((12, 16, 300) if rle4 else (W, 16, 300))]


@pytest.mark.parametrize("rle4,kind,width", RLE,
                         ids=[f"{'rle4' if r else 'rle8'}-{k}-w{w}" for r, k, w in RLE])
def test_bmp_rle(rle4, kind, width, tmp_path):
    """RLE8 and RLE4 of repeat and absolute runs (absolute runs of up to
    254 pixels) as the writer makes them: both oracles, except that PIL
    misreads an RLE4 absolute run of an odd count (pinned below)."""
    rng = _rng(f"rle{rle4}{kind}{width}")
    n = 16 if rle4 else 256
    idx = rng.integers(0, n, (H, width)).astype(np.uint8)
    idx[3:7, 2:width - 2] = 5
    idx[9] = 0
    if rle4:  # absolute runs of even counts only: PIL reads those
        idx[:, 1::2] = idx[:, ::2]
    pal = rng.integers(0, 256, (n, 3)) if kind == "colour" else np.repeat(
        np.arange(n)[:, None], 3, 1)
    path = _file(tmp_path, "x.bmp", bmp_bytes(idx, 4 if rle4 else 8, palette=pal,
                                              compression=2 if rle4 else 1))
    _held(path)
    np.testing.assert_array_equal(imread(path), idx)


def _rle_file(tmp_path, stream, rle4, w=4, h=3):
    rng = _rng("crafted")
    pal = rng.integers(0, 256, (16 if rle4 else 256, 3))
    pal[0] = (1, 2, 3)
    data = bmp_bytes(np.zeros((h, w), np.uint8), 4 if rle4 else 8, palette=pal,
                     compression=2 if rle4 else 1, rle_data=bytes(stream))
    return _file(tmp_path, "x.bmp", data), pal


# (name, RLE4, stream, rows top to bottom as the file defines them; the
# oracles: "both" equal the port, "pil" misreads or refuses the file while
# cv2 reads it, "both-misread" neither reads it)
CRAFTED = [
    ("rows", False, [4, 7, 0, 0, 4, 8, 0, 0, 4, 9, 0, 0, 0, 1], [[9] * 4, [8] * 4, [7] * 4],
     "both"),
    ("no end of row", False, [4, 7, 4, 8, 4, 9, 0, 1], [[9] * 4, [8] * 4, [7] * 4], "pil"),
    ("early end", False, [4, 7, 0, 0, 0, 1], [[0] * 4, [0] * 4, [7] * 4], "pil"),
    ("delta", False, [1, 7, 0, 2, 2, 1, 1, 8, 0, 0, 4, 9, 0, 1],
     [[9] * 4, [0, 0, 0, 8], [7, 0, 0, 0]], "pil"),
    ("empty row", False, [4, 7, 0, 0, 0, 0, 4, 9, 0, 1], [[9] * 4, [0] * 4, [7] * 4], "pil"),
    ("absolute", False, [0, 3, 7, 8, 9, 0, 1, 6, 0, 0, 4, 8, 0, 0, 4, 9, 0, 1],
     [[9] * 4, [8] * 4, [7, 8, 9, 6]], "both"),
    ("rle4 rows", True, [4, 0x77, 0, 0, 4, 0x88, 0, 0, 4, 0x99, 0, 0, 0, 1],
     [[9] * 4, [8] * 4, [7] * 4], "both"),
    ("rle4 odd absolute", True, [0, 3, 0x78, 0x90, 1, 0x60, 0, 0, 4, 0x88, 0, 0, 4, 0x99, 0, 1],
     [[9] * 4, [8] * 4, [7, 8, 9, 6]], "pil"),
    ("rle4 delta", True, [1, 0x77, 0, 2, 2, 1, 1, 0x88, 0, 0, 4, 0x99, 0, 1],
     [[9] * 4, [0, 0, 0, 8], [7, 0, 0, 0]], "both-misread"),
    ("rle4 empty row", True, [4, 0x77, 0, 0, 0, 0, 4, 0x99, 0, 1], [[9] * 4, [0] * 4, [7] * 4],
     "pil"),
]


@pytest.mark.parametrize("name,rle4,stream,rows,oracles", CRAFTED, ids=[c[0] for c in CRAFTED])
def test_bmp_rle_codes(name, rle4, stream, rows, oracles, tmp_path):
    """Ends of row and of bitmap, deltas and absolute runs: the port reads
    the pixels the stream defines (skipped ones index 0: PIL's index 0,
    cv2's palette[0]); PIL reads a delta's four bytes, an RLE4 absolute run
    of an odd count by half its bytes, and refuses a row that ends without
    its code or an early end of bitmap; cv2's RLE4 ignores a delta's rows.
    Where an oracle misreads, the test pins its difference."""
    path, pal = _rle_file(tmp_path, stream, rle4)
    want = np.array(rows, np.uint8)
    np.testing.assert_array_equal(imread(path), want)
    np.testing.assert_array_equal(imread_gray(path), pal[want, 2])
    pil, gray = _outcome(jax_load, path), _outcome(jax_gray, path)
    if oracles == "both":
        _held(path)
    elif oracles == "pil":  # cv2 reads the file as the port does; PIL does not
        np.testing.assert_array_equal(gray, pal[want, 2])
        assert isinstance(pil, Exception) or not np.array_equal(pil, want)
    else:  # both misread or refuse
        assert isinstance(pil, Exception) or not np.array_equal(pil, want)
        assert isinstance(gray, Exception) or not np.array_equal(gray, pal[want, 2])


def test_bmp_4bit_grey_palette_pil_misreads(tmp_path):
    """PIL reads a 4-bit BMP of a grey palette (i, i, i) as 8-bit samples
    (its raw mode L); the port gives the indices, as cv2 does."""
    rng = _rng("grey4")
    idx = rng.integers(0, 16, (H, W)).astype(np.uint8)
    path = _file(tmp_path, "x.bmp", bmp_bytes(idx, 4, palette=np.repeat(
        np.arange(16)[:, None], 3, 1)))
    np.testing.assert_array_equal(imread(path), idx)
    np.testing.assert_array_equal(imread_gray(path), jax_gray(path))
    assert not np.array_equal(jax_load(path), idx)


def test_dib_and_bmp_read_alike(tmp_path):
    rng = _rng("dib")
    idx = rng.integers(0, 256, (H, W)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3))
    bmp = _file(tmp_path, "x.bmp", bmp_bytes(idx, 8, palette=pal))
    dib = _file(tmp_path, "x.dib", bmp_bytes(idx, 8, palette=pal, dib=True))
    _held(dib)
    np.testing.assert_array_equal(imread(dib), imread(bmp))
    np.testing.assert_array_equal(imread_gray(dib), idx)  # cv2 reads no DIB: PIL's indices


# ----- PNM, PFM, PAM -------------------------------------------------------------

PNM = [(m, v) for m in ("P2", "P5", "P3", "P6") for v in (1, 7, 100, 255, 256, 1000, 4095, 65535)]


@pytest.mark.parametrize("magic,maxval", PNM, ids=[f"{m}-{v}" for m, v in PNM])
def test_pnm_maxvals(magic, maxval, tmp_path):
    """PGM and PPM, plain and raw, at any maxval, comments in the header:
    PIL rounds each sample to 8 (grey above 255: 16, int32) bits, cv2 keeps
    raw ones and scales plain 8-bit ones down."""
    rng = _rng(f"{magic}{maxval}")
    shape = (H, W, 3) if magic in ("P3", "P6") else (H, W)
    v = rng.integers(0, maxval + 1, shape)
    _held(_file(tmp_path, "x.pnm", pnm_bytes(v, magic, maxval, comment=b" from the tests")))


def test_pnm_4095_each_reader_by_its_oracle(tmp_path):
    """A P5 of maxval 4095 holding 4081: PIL scales it to 65311, cv2 keeps
    4081."""
    path = _file(tmp_path, "x.pgm", pnm_bytes(np.full((2, 3), 4081), "P5", 4095))
    assert imread(path).dtype == np.int32 and (imread(path) == 65311).all()
    assert imread_gray(path).dtype == np.uint16 and (imread_gray(path) == 4081).all()
    _held(path)


@pytest.mark.parametrize("magic", ["P2", "P5"])
def test_pnm_samples_above_maxval(magic, tmp_path):
    """Samples above maxval: PIL refuses plain ones and clips raw ones
    after scaling, cv2 clips plain ones and keeps raw ones."""
    v = _rng(magic).integers(0, 5000, (H, W))
    _held(_file(tmp_path, "x.pgm", pnm_bytes(v, magic, 4095)))


@pytest.mark.parametrize("magic", ["P1", "P4"])
def test_pbm(magic, tmp_path):
    v = _rng(magic).integers(0, 2, (H, W))
    path = _file(tmp_path, "x.pbm", pnm_bytes(v, magic, comment=b"c"))
    _held(path)
    np.testing.assert_array_equal(imread(path), v == 0)


PFM = [(c, little, scale) for c in (1, 3) for little in (True, False) for scale in (1.0, 2.5, 0.3)]


@pytest.mark.parametrize("channels,little,scale", PFM,
                         ids=[f"{'Pf' if c == 1 else 'PF'}-{'le' if lt else 'be'}-{s}"
                              for c, lt, s in PFM])
def test_pfm(channels, little, scale, tmp_path):
    """Grey ``Pf`` (PIL keeps the samples, cv2 multiplies by float32(1 /
    |scale|)) and colour ``PF`` (cv2 alone)."""
    rng = _rng(f"pfm{channels}{little}{scale}")
    px = rng.normal(size=(H, W) if channels == 1 else (H, W, 3)).astype(np.float32)
    _held(_file(tmp_path, "x.pfm", pfm_bytes(px, little, scale)))


PAM = [(mv, d, t) for mv in (1, 100, 255, 1000, 65535) for d in (1, 2, 3, 4)
       for t in ("named", "none")]


@pytest.mark.parametrize("maxval,depth,tupltype", PAM,
                         ids=[f"{m}-{d}-{t}" for m, d, t in PAM])
def test_pam(maxval, depth, tupltype, tmp_path):
    """PAM, which PIL does not open: cv2's samples in the file's order
    (without a tuple type, grey or RGB of 8 bits alone); of maxval 1 cv2
    reads packed bits, and the port the samples (pinned)."""
    rng = _rng(f"pam{maxval}{depth}{tupltype}")
    v = rng.integers(0, maxval + 1, (H, W) if depth == 1 else (H, W, depth))
    data = pam_bytes(v, maxval)
    if tupltype == "none":
        data = data.replace(data[data.index(b"TUPLTYPE"):data.index(b"ENDHDR")], b"")
    path = _file(tmp_path, "x.pam", data)
    if maxval > 1:
        _held(path)
        return
    with pytest.raises(ValueError):
        imread(path)
    if depth in (2, 4) or (tupltype == "none" and depth not in (1, 3)):
        with pytest.raises(ValueError):
            imread_gray(path)
        return
    np.testing.assert_array_equal(imread_gray(path), v if depth == 1 else v[..., 0])
    assert not np.array_equal(jax_gray(path), v if depth == 1 else v[..., 0])


# ----- GIF -----------------------------------------------------------------------


def _gif_cases():
    rng = _rng("gif")
    pal = rng.integers(0, 256, (16, 3))
    grey = np.repeat(np.arange(16)[:, None], 3, 1)
    a, b = rng.integers(0, 12, (H, W)).astype(np.uint8), rng.integers(0, 12, (7, 5)).astype(
        np.uint8)
    c = rng.integers(0, 12, (H, W)).astype(np.uint8)
    big = rng.integers(0, 256, (70, 90)).astype(np.uint8)
    big_pal = rng.integers(0, 256, (256, 3))
    cases = {
        "plain": ([a], dict(palette=pal)),
        "interlaced": ([{"pixels": a, "interlace": True}], dict(palette=pal)),
        "interlaced-transparent": ([{"pixels": a, "interlace": True, "transparency": 3}],
                                   dict(palette=pal)),
        "transparent": ([{"pixels": a, "transparency": 4}], dict(palette=pal, background=3)),
        "offset": ([{"pixels": b, "x": 3, "y": 2}], dict(palette=pal, size=(W, H), background=5)),
        "offset-transparent": ([{"pixels": b, "x": 3, "y": 2, "transparency": 4}],
                               dict(palette=pal, size=(W, H), background=5)),
        "local-table": ([{"pixels": a, "palette": pal}], {}),
        "local-table-offset": ([{"pixels": b, "x": 3, "y": 2, "palette": pal}], dict(size=(W, H))),
        "no-table": ([a], {}),
        "grey-table": ([a], dict(palette=grey)),
        "local-grey-global-colour": ([{"pixels": a, "palette": grey}], dict(palette=pal)),
        "global-and-local": ([{"pixels": a, "palette": grey[::-1]}], dict(palette=pal)),
        "background-past-table": ([{"pixels": b, "x": 3, "y": 2}],
                                  dict(palette=pal[:8], size=(W, H), background=9)),
        "index-past-table": ([a], dict(palette=pal[:4])),
        "frame-past-screen": ([{"pixels": a, "x": 2, "y": 1}], dict(palette=pal)),
        "full-table-cleared": ([big], dict(palette=big_pal)),
        "full-table-frozen": ([big], dict(palette=big_pal, clear_when_full=False)),
        "min-code-size-8": ([a % 2], dict(palette=[[0, 0, 0], [255, 255, 255]], min_size=8)),
        "animated-colour": ([a, c], dict(palette=pal)),
        "animated-colour-local": ([a, {"pixels": c, "palette": pal}], dict(palette=pal)),
        "animated-grey": ([a, c, a], dict(palette=grey)),
        "animated-no-table": ([a, c], {}),
        "animated-grey-offsets": ([a, {"pixels": b, "x": 3, "y": 2},
                                   {"pixels": b, "x": 1, "y": 4, "transparency": 3}],
                                  dict(palette=grey)),
        "animated-grey-transparent-0": ([{"pixels": a, "transparency": 2},
                                         {"pixels": b, "x": 3, "y": 2, "transparency": 5}, c],
                                        dict(palette=grey)),
        "animated-grey-past-screen": ([a, {"pixels": b, "x": 10, "y": 2}], dict(palette=grey)),
        "animated-grey-then-colour": ([a, {"pixels": b, "x": 3, "y": 2, "palette": pal}, c],
                                      dict(palette=grey)),
        "animated-grey-local-then-colour": ([{"pixels": a, "palette": grey}, c],
                                            dict(palette=pal)),
    }
    for t0 in (None, 1):
        for d0 in (0, 1, 2, 3):
            for d1 in (0, 1, 2, 3):
                f0 = {"pixels": a, "disposal": d0}
                if t0 is not None:
                    f0["transparency"] = t0
                cases[f"disposal-{d0}{d1}-t{t0}"] = (
                    [f0, {"pixels": b, "x": 3, "y": 2, "disposal": d1, "transparency": 6},
                     {"pixels": b, "x": 5, "y": 3}, {"pixels": b, "transparency": 0}],
                    dict(palette=grey, background=7))
    return cases


GIFS = _gif_cases()


@pytest.mark.parametrize("name", list(GIFS))
def test_gif(name, tmp_path):
    """Frame 0 as PIL gives it (indices) and as cv2 gives it (the table's
    blue over the background colour; PIL's where cv2 refuses); animations
    stacked as PIL composes grey frames (each disposal, PIL's last one
    kept), refused where PIL's frames are colour."""
    frames, kw = GIFS[name]
    _held(_file(tmp_path, "x.gif", gif_bytes(frames, **kw)))


# ----- SPIDER --------------------------------------------------------------------

SPIDERS = [(big, form) for big in (True, False)
           for form in ("image", "stack", "stack-of-one", "wide", "volume", "fourier")]


@pytest.mark.parametrize("big,form", SPIDERS,
                         ids=[f"{'be' if b else 'le'}-{f}" for b, f in SPIDERS])
def test_spider(big, form, tmp_path):
    """float32 images and stacks in either byte order (both readers take
    PIL's: cv2 reads no SPIDER); volumes and Fourier forms raise."""
    rng = _rng(f"spider{big}{form}")
    pages = [rng.normal(size=(H, W)).astype(np.float32) for _ in range(3)]
    data = {"image": lambda: spider_bytes(pages[0], big),
            "stack": lambda: spider_bytes(pages, big),
            "stack-of-one": lambda: spider_bytes(pages[:1], big, stack=True),
            "wide": lambda: spider_bytes(rng.normal(size=(4, 300)).astype(np.float32), big),
            "volume": lambda: spider_bytes(pages[0], big, iform=3),
            "fourier": lambda: spider_bytes(pages[0], big, iform=-11)}[form]()
    path = _file(tmp_path, "x.spi", data)
    _held(path)
    if form == "stack":
        np.testing.assert_array_equal(imread(path), np.stack(pages))
    if form in ("volume", "fourier"):
        with pytest.raises(ValueError, match="iform"):
            imread(path)


# ----- TGA -----------------------------------------------------------------------

TGAS = [(kind, rle, top, right) for kind in ("grey", "grey-alpha", "rgb", "rgba", "rgb15",
                                             "map16", "map24", "map32", "map15", "no-map", "id")
        for rle in (False, True) for top in (False, True) for right in (False, True)]


@pytest.mark.parametrize("kind,rle,top,right", TGAS,
                         ids=[f"{k}-{'rle' if r else 'raw'}-{'top' if t else 'bottom'}-"
                              f"{'right' if rt else 'left'}" for k, r, t, rt in TGAS])
def test_tga(kind, rle, top, right, tmp_path):
    """Every type, depth, colour-map depth (PIL opens no 15-bit map and
    loads no 32-bit one, nor an RLE colour-mapped image without a map) and
    origin; ``imread_gray`` is PIL's channel 0."""
    rng = _rng(f"tga{kind}{rle}{top}{right}")
    g = rng.integers(0, 256, (H, W)).astype(np.uint8)
    g[4:8] = 9
    kw = dict(top=top, right=right)
    if kind.startswith("map") or kind == "no-map":
        idx = rng.integers(0, 20, (H, W)).astype(np.uint8)
        pal = None if kind == "no-map" else rng.integers(0, 256, (20, 3))
        data = tga_bytes(idx, 9 if rle else 1, palette=pal,
                         map_depth=int(kind[3:]) if pal is not None else 24, **kw)
    elif kind in ("grey", "id"):
        data = tga_bytes(g, 11 if rle else 3, ident=b"an id" if kind == "id" else b"", **kw)
    else:
        px = {"grey-alpha": lambda: rng.integers(0, 256, (H, W, 2)),
              "rgb": lambda: rng.integers(0, 256, (H, W, 3)),
              "rgba": lambda: rng.integers(0, 256, (H, W, 4)),
              "rgb15": lambda: rng.integers(0, 65536, (H, W))}[kind]()
        px = px.astype(np.uint16 if kind == "rgb15" else np.uint8)
        px[2, :] = px[2, 0]
        data = tga_bytes(px, (11 if kind == "grey-alpha" else 10) if rle else
                         (3 if kind == "grey-alpha" else 2), **kw)
    _held(_file(tmp_path, "x.tga", data))


def test_tga_colour_map_from_an_offset(tmp_path):
    idx = _rng("first").integers(3, 20, (H, W)).astype(np.uint8)
    _held(_file(tmp_path, "x.tga", tga_bytes(idx, 1, palette=_rng("p").integers(0, 256, (17, 3)),
                                             map_first=3)))


# ----- Sun raster ----------------------------------------------------------------

SUNS = [(kind, w, rle) for kind in ("grey", "map", "grey-map", "short-map", "bits", "rgb",
                                    "rgb-order", "xbgr", "xrgb")
        for w in (12, 13) for rle in (False, True) if not (rle and kind in ("rgb-order", "xrgb"))]


@pytest.mark.parametrize("kind,width,rle", SUNS,
                         ids=[f"{k}-w{w}-{'rle' if r else 'raw'}" for k, w, r in SUNS])
def test_sun(kind, width, rle, tmp_path):
    """Depths 1, 8, 24 and 32, colour maps, types 1, 2 and 3.  cv2 reads
    types 0 and 1 alone (PIL's array for the others) and gives zeros for
    1 and 8 bits without a map, PIL's byte-encoded rows forget the padding
    of an odd width: there the port follows the file (pinned)."""
    rng = _rng(f"sun{kind}{width}{rle}")
    g = rng.integers(0, 256, (H, width)).astype(np.uint8)
    g[3:6] = 0x80
    g[7, 2:9] = 3
    pal = {"map": rng.integers(0, 256, (256, 3)), "grey-map": np.repeat(
        np.arange(256)[:, None], 3, 1), "short-map": rng.integers(0, 256, (100, 3))}.get(kind)
    if kind == "bits":
        px = rng.integers(0, 2, (H, width)).astype(np.uint8)
        data, want = sun_bytes(px, 1, rle=rle), px == 0
    elif kind in ("rgb", "rgb-order"):
        px = rng.integers(0, 256, (H, width, 3)).astype(np.uint8)
        data, want = sun_bytes(px, rle=rle, rgb_order=kind == "rgb-order"), px
    elif kind in ("xbgr", "xrgb"):
        px = rng.integers(0, 256, (H, width, 4)).astype(np.uint8)
        data = bytearray(sun_bytes(px, 32, rle=rle))
        if kind == "xrgb":
            data[20:24] = struct.pack(">I", 3)
        want = px[..., :3] if kind == "xrgb" else px[..., 2::-1]
    else:
        data, want = sun_bytes(g, palette=pal, rle=rle), g
    path = _file(tmp_path, "x.ras", bytes(data))
    np.testing.assert_array_equal(imread(path), want)
    pil_misreads = rle and (width * {"bits": 1, "rgb": 24, "xbgr": 32}.get(kind, 8) + 7) // 8 % 2
    cv2_misreads = kind in ("grey", "bits") and not rle
    if not pil_misreads and not cv2_misreads:
        _held(path)
        return
    if pil_misreads:
        assert not np.array_equal(jax_load(path), want)
    if cv2_misreads:
        assert (jax_gray(path) == 0).all()
        np.testing.assert_array_equal(imread_gray(path), want * 255 if kind == "bits" else g)


# ----- damaged and oversized files, refused formats -------------------------------


def _damaged(kind):
    rng = _rng("damaged" + kind)
    idx = rng.integers(0, 8, (H, W)).astype(np.uint8)
    if kind == "gif":
        data = bytearray(gif_bytes([idx], rng.integers(0, 256, (8, 3))))
        at = len(data) - 6  # the last codes of the frame's LZW
        data[at - 8:at] = b"\xff" * 8
        return "x.gif", bytes(data), "GIF frame 0: damaged LZW"
    if kind in ("rle8", "rle4"):
        stream = bytes([W + 2, 1, 0, 0] * H) + b"\x00\x01"  # runs past their row
        return "x.bmp", bmp_bytes(idx, 4 if kind == "rle4" else 8,
                                  palette=rng.integers(0, 256, (16, 3)),
                                  compression=2 if kind == "rle4" else 1, rle_data=stream), \
            "damaged RLE"
    if kind == "tga":
        data = bytearray(tga_bytes(idx, 11))
        data[18] = 0x80 | 127  # a repeated pixel's packet across its row
        return "x.tga", bytes(data), "damaged RLE"
    data = sun_bytes(idx, rle=True)
    return "x.ras", data[:len(data) // 2], "bytes decoded of the"


@pytest.mark.parametrize("kind", ["gif", "rle8", "rle4", "tga", "sun"])
def test_damaged_data_names_the_file(kind, tmp_path):
    name, data, match = _damaged(kind)
    path = _file(tmp_path, name, data)
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=match) as err:
            read(path)
        assert path in str(err.value)


def _oversized(fmt):
    big = 65535
    if fmt == "bmp":
        return struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 70, 0, 0, 54, 40, big, big, 1, 8, 0, 0,
                           0, 0, 0, 0) + bytes(16)
    if fmt == "bmp-rle":
        d = bytearray(_oversized("bmp"))
        struct.pack_into("<I", d, 30, 1)
        return bytes(d)
    if fmt == "pgm":
        return b"P5\n65535 65535\n255\n" + bytes(16)
    if fmt == "pgm-plain":
        return b"P2\n65535 65535\n255\n1 2 3\n"
    if fmt == "pfm":
        return b"Pf\n65535 65535\n-1.0\n" + bytes(16)
    if fmt == "pam":
        return b"P7\nWIDTH 65535\nHEIGHT 65535\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(16)
    if fmt == "gif":
        return b"GIF89a" + struct.pack("<HHBBB", big, big, 0, 0, 0) + b"\x2c" + struct.pack(
            "<HHHHB", 0, 0, big, big, 0) + b"\x08\x02\x00\x01\x00;"
    if fmt == "spider":
        hdr = np.zeros(27, ">f4")
        for i, v in {1: 1, 2: big, 5: 1, 12: big, 13: 1, 22: 108, 23: 108}.items():
            hdr[i - 1] = v
        return hdr.tobytes() + bytes(16)
    if fmt == "tga":
        return struct.pack("<BBBHHBHHHHBB", 0, 0, 3, 0, 0, 0, 0, 0, big, big, 8, 0) + bytes(16)
    if fmt == "tga-rle":
        return struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, big, big, 8, 0) + bytes(16)
    if fmt.startswith("sun"):
        return struct.pack(">8I", 0x59A66A95, big, big, 8, 0, 2 if fmt == "sun-rle" else 1, 0,
                           0) + bytes(16)
    if fmt == "png":  # every CRC right, a few bytes of image data
        chunks = (b"IHDR" + struct.pack(">IIBBBBB", big, big, 8, 0, 0, 0, 0),
                  b"IDAT" + zlib.compress(bytes(16)), b"IEND")
        return b"\x89PNG\r\n\x1a\n" + b"".join(
            struct.pack(">I", len(c) - 4) + c + struct.pack(">I", zlib.crc32(c)) for c in chunks)
    # data/plugins.py's formats: 13000 x 13000, under PIL's pixel limit
    side = 13000
    if fmt in ("sgi", "sgi-rle"):
        return struct.pack(">hBBHHHH", 474, fmt == "sgi-rle", 1, 2, side, side, 1) + bytes(600)
    if fmt in ("pcx", "dcx"):
        pcx = struct.pack("<BBBBHHHH", 10, 5, 1, 8, 0, 0, side - 1, side - 1) + bytes(53) \
            + struct.pack("<BH", 1, side) + bytes(60) + bytes(672)
        return pcx if fmt == "pcx" else struct.pack("<II", 0x3ADE68B1, 4104) + bytes(4096) + pcx
    if fmt == "qoi":
        return b"qoif" + struct.pack(">IIBB", side, side, 3, 0) + bytes(16)
    if fmt == "im":
        return b"Image type: Greyscale image\r\nImage size (x*y): 13000*13000\r\n\0\x1a" \
            + bytes(16)
    if fmt == "xbm":
        return b"#define a_width 13000\n#define a_height 13000\nstatic char a_bits[] = {0x00};"
    if fmt in ("msp", "msp-v2"):
        words = list(struct.unpack("<HH", b"DanM" if fmt == "msp" else b"LinS")) + [
            side, side] + [0] * 12
        for v in words[:12]:
            words[12] ^= v
        return struct.pack("<16H", *words) + bytes(16)
    if fmt == "hdr":
        return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 13000 +X 13000\n" + bytes(16)
    # data/icons.py's formats and IM's samples of 12 bits: 13000 x 13000 too
    if fmt == "im-bits":
        return b"Image type: L*12 image\r\nImage size (x*y): 13000*13000\r\n\0\x1a" \
            + bytes(16)
    if fmt == "xpm":
        return b'/* XPM */\n"13000 13000 1 1",\n"a c #000000",\n"aaaa"\n'
    if fmt in ("ico", "cur"):  # a DIB member of 13000 x 26000 (halved: 13000)
        dib = struct.pack("<IiiHHIIiiII", 40, side, 2 * side, 1, 8, 0, 0, 0, 0, 1, 0)
        return struct.pack("<HHHBBBBHHII", 0, 2 if fmt == "cur" else 1, 1, 0, 0, 1, 0, 1, 8,
                           len(dib) + 20, 22) + dib + bytes(20)
    psd = b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, side, side, 8, 1) + bytes(12)
    if fmt == "psd":
        return psd + struct.pack(">H", 0) + bytes(16)
    return psd + struct.pack(">H", 1) + struct.pack(">H", 2) * side + b"\xc1\x00" * 8


OVERSIZED = ["png", "bmp", "bmp-rle", "pgm", "pgm-plain", "pfm", "pam", "gif", "spider", "tga",
             "tga-rle", "sun", "sun-rle", "sgi", "sgi-rle", "pcx", "dcx", "qoi", "im", "xbm",
             "msp", "msp-v2", "hdr", "im-bits", "xpm", "ico", "cur", "psd", "psd-rle"]


@pytest.mark.parametrize("fmt", OVERSIZED)
def test_oversized_header_is_refused_before_allocating(fmt, tmp_path):
    """A header claiming 65535 x 65535 (13000 x 13000 in the formats of
    data/plugins.py and data/icons.py) on a file of a few dozen bytes
    raises before any buffer of its size is allocated (the peak traced
    allocation stays under 1 MiB)."""
    path = _file(tmp_path, "x.img", _oversized(fmt))
    for read in (imread, imread_gray):
        tracemalloc.start()
        try:
            with pytest.raises(ValueError, match=path):
                read(path)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 1 << 20, peak


def _other_format(kind):
    arr = np.zeros((8, 8), np.uint8)
    if kind == "jpeg2000":  # the port reads JPEG 2000: a form of it that it refuses, a palette
        buf = io.BytesIO()
        Image.fromarray(np.dstack([arr] * 3)).save(buf, "JPEG2000")
        palette = (box(b"pclr", struct.pack(">HB", 2, 3) + bytes([7, 7, 7]) + bytes(6))
                   + box(b"cmap", struct.pack(">HBB", 0, 1, 0) * 3))
        return jp2(codestream_of(buf.getvalue()), 8, 8, 3, 7, 16, header_extra=palette)
    # the others by their first bytes: McIdas's, PIXAR's, XVThumb's and
    # MPEG's magic, a FITS primary header
    return {"mcidas": b"\0\0\0\0\0\0\0\4" + bytes(1024),
            "pixar": b"\x80\xe8\0\0" + bytes(508),
            "xvthumb": b"P7 332\n#END_OF_COMMENTS\n8 8 255\n" + bytes(64),
            "mpeg": b"\0\0\1\xb3" + bytes(20),
            "fits": b"SIMPLE  =                    T" + b" " * 50}[kind]


# what a refusal names where it is not the format: the form of a format the
# port reads
_REFUSED_FORM = {"JPEG2000": r"a palette \(pclr and cmap boxes\), which the port does not read"}


@pytest.mark.parametrize("kind,name", [("mcidas", "MCIDAS"), ("jpeg2000", "JPEG2000"),
                                       ("pixar", "PIXAR"), ("xvthumb", "XVTHUMB"),
                                       ("mpeg", "MPEG"), ("fits", "FITS")])
def test_formats_still_refused_name_themselves(kind, name, tmp_path):
    path = _file(tmp_path, f"x.{kind}", _other_format(kind))
    assert raster.identify(open(path, "rb").read()) == name
    match = _REFUSED_FORM.get(name, f"a {name} file, which the port does not read")
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=match):
            read(path)


def test_identify_follows_pils_order(tmp_path):
    """TGA and SPIDER have no magic number: a true-colour TGA begins as a
    CUR of no cursors (PIL goes on) and reads as TGA; a SPIDER header in
    either byte order is SPIDER; a file of none raises naming the port's
    formats."""
    tga = tga_bytes(np.zeros((4, 5, 3), np.uint8), 2)
    assert tga[:4] == b"\0\0\2\0" and raster.identify(tga) == "TGA"
    for big in (True, False):
        assert raster.identify(spider_bytes(np.zeros((4, 5), np.float32), big)) == "SPIDER"
    assert raster.identify(pnm_bytes(np.zeros((2, 2)), "P5")) == "PNM"
    assert raster.identify(pam_bytes(np.zeros((2, 2)))) == "PNM"
    path = _file(tmp_path, "x.bin", b"\x05\x07" + bytes(30))
    with pytest.raises(ValueError, match="not a file of a format the port reads.*SPIDER, TGA"):
        imread(path)


# ----- the writer's encoders -----------------------------------------------------


def test_encoders_round_trip():
    """Each encoder of ``_raster_writer`` decodes back through the host
    library (GIF LZW with and without a clear when the table fills, at
    minimum code sizes 2 to 8; BMP RLE8 and RLE4 rows; TGA RLE of 1- to
    4-byte pixels; Sun's byte encoding with 0x80 bytes)."""
    rng = np.random.default_rng(9)
    for size in (2, 3, 5, 8):
        data = rng.integers(0, 1 << size, 20000).astype(np.uint8)
        data[5000:9000] = 1
        for clear in (True, False):
            out, got = native.gif_lzw_decode(gif_lzw_encode(data.tobytes(), size, clear), size,
                                             len(data))
            assert got == len(data) and np.array_equal(out, data)
    for rle4 in (False, True):
        rows = rng.integers(0, 16 if rle4 else 256, (9, 301)).astype(np.uint8)
        rows[2:5, 10:200] = 3
        if rle4:
            rows[:, 1::2] = rows[:, ::2][:, :150]
        stream = b"".join(bmp_rle_row(r, rle4) for r in rows) + b"\x00\x01"
        out, got = native.bmp_rle_decode(stream, 301, 9, rle4)
        assert got == 301 * 9 and np.array_equal(out, rows)
    for bpp in (1, 2, 3, 4):
        raw = rng.integers(0, 4, (7, 150, bpp)).astype(np.uint8)
        raw[:, 20:90] = 2
        out, got = native.tga_rle_decode(tga_rle(raw), bpp, 150 * bpp, raw.size)
        assert got == raw.size and np.array_equal(out, raw.ravel())
    data = rng.integers(0x7E, 0x82, 5000).astype(np.uint8)
    data[100:900] = 0x80
    out, got = native.sun_rle_decode(sun_rle(data.tobytes()), len(data))
    assert got == len(data) and np.array_equal(out, data)


def test_datasets_read_bmp_images_and_tga_masks(tmp_path):
    """A training folder of BMP images and TGA masks reads as the JAX
    package reads it (``_imread_gray``), and as the same slices in PNG."""
    from empanada_tpu_torch.data.datasets import SingleClassInstanceDataset

    rng = _rng("dataset")
    for ext in ("bmp", "png"):
        for sub in ("images", "masks"):
            os.makedirs(tmp_path / ext / "src" / sub)
    for i in range(3):
        img = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        mask = np.zeros((32, 32), np.uint8)
        mask[4:14, 5:15], mask[18:30, 16:28] = 1, 2
        (tmp_path / "bmp" / "src" / "images" / f"{i}.bmp").write_bytes(bmp_bytes(
            img, 8, palette=np.repeat(np.arange(256)[:, None], 3, 1)))
        (tmp_path / "bmp" / "src" / "masks" / f"{i}.tga").write_bytes(tga_bytes(mask, 11))
        Image.fromarray(img).save(tmp_path / "png" / "src" / "images" / f"{i}.png")
        Image.fromarray(mask).save(tmp_path / "png" / "src" / "masks" / f"{i}.png")
        for p in ("images", "masks"):
            path = str(next((tmp_path / "bmp" / "src" / p).glob(f"{i}.*")))
            np.testing.assert_array_equal(imread_gray(path), jax_gray(path))
    got = SingleClassInstanceDataset(str(tmp_path / "bmp"))
    want = SingleClassInstanceDataset(str(tmp_path / "png"))
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
