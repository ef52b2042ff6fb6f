"""The last of PIL's raster plugins and cv2's Radiance HDR, read by the port
(``data/plugins.py``), and multi-picture JPEG (MPO), on the CPU at small
sizes; every comparison is exact (tolerance 0): ``imread`` against the JAX
package's ``cli._load_array`` (PIL) and ``imread_gray`` against its
``datasets._imread_gray`` (cv2, then PIL), in dtype, shape and every
sample, or both raising, on the same file:

- an MPO's pictures stack as PIL's frames do (the port read the first
  alone before this module's slice), grey and colour, little- and
  big-endian indexes, three pictures, pictures of different shapes (both
  raise), Ultra HDR (one JPEG), and damaged indexes PIL reads as one JPEG
  or refuses;
- files PIL writes for every mode it saves SGI (both sample sizes), PCX,
  QOI, IM (its 15 modes), XBM and MSP from, and HDR as cv2 writes it;
- seeded files of ``_raster_writer`` for the forms neither writes: SGI RLE
  at 8 and 16 bits of 1, 3 and 4 channels and one row, crafted rows (short,
  cut, past their row, ending the image); PCX of 2 and 4 bit planes, odd
  and padded strides, a palette or none, runs into the palette; DCX; QOI
  of every op, its table's quirks; IM of every type and Lut, frames where
  PIL finds them, header variants; XBM's hex quirks; MSP version 2 (blank
  rows, long runs, cut literals); HDR flat, in the new and the old RLE, at
  widths under 8, with cv2's header rules;
- damaged data raises naming the file (and the page or picture); the
  writer's encoders round-trip through the host library; PIL's plugin
  order decides a file's format; a training folder of SGI images and PCX
  masks reads as its PNG twin.
"""

import io
import os
import struct
import warnings

import cv2
import numpy as np
import pytest
from PIL import Image

from _jpeg_writer import jpeg_bytes
from _raster_writer import (
    dcx_bytes,
    hdr_bytes,
    hdr_scanline,
    im_bytes,
    mpo_bytes,
    msp_bytes,
    msp_rle_row,
    pcx_bytes,
    pcx_rle,
    qoi_bytes,
    qoi_ops,
    rgbe_of,
    sgi_bytes,
    sgi_rle_row,
    xbm_bytes,
)
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import raster
from empanada_tpu_torch.data.imread import imread, imread_gray
from test_torch_raster import H, W, _file, _held, _rng


def _pil(mode, rng, h=H, w=W):
    """A seeded PIL image of ``mode``."""
    g = rng.integers(0, 256, (h, w)).astype(np.uint8)
    g[2:5, 3:9] = 7  # runs for the encoders
    if mode == "1":
        return Image.fromarray(g > 127)
    if mode in ("P", "PA"):
        im = Image.fromarray(g % 11, "P")
        im.putpalette(rng.integers(0, 256, 33).tolist())
        return im if mode == "P" else im.convert("PA")
    if mode in ("I;16", "I;16L", "I;16B"):
        v = g.astype(np.uint16) * 250 + 3
        return Image.frombytes(mode, (w, h), v.astype(">u2" if mode == "I;16B" else "<u2")
                               .tobytes())
    if mode == "I":
        return Image.fromarray(g.astype(np.int32) * -70000)
    if mode == "F":
        return Image.fromarray(rng.normal(size=(h, w)).astype(np.float32))
    if mode == "L":
        return Image.fromarray(g)
    c = rng.integers(0, 256, (h, w, len(mode) if mode != "YCbCr" else 3)).astype(np.uint8)
    c[2:5, 3:9] = 9
    return Image.frombytes(mode, (w, h), c.tobytes())


def _saved(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ----- MPO -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_mpo_reads_every_picture(mode, tmp_path):
    """A multi-picture JPEG as PIL writes it reads as the stack of its
    pictures, as the JAX package's ``_load_array`` gives it (before this
    slice the port read the first picture alone); ``imread_gray`` stays
    cv2's first picture."""
    rng = _rng("mpo" + mode)
    frames = [_pil(mode, rng, 37, 53) for _ in range(2)]
    path = _file(tmp_path, "x.mpo", _saved(frames[0], "MPO", save_all=True,
                                           append_images=frames[1:]))
    assert imread(path).shape == (2, 37, 53) + ((3,) if mode == "RGB" else ())
    _held(path)


def _jpegs(kind, rng, n=2):
    shape = (H, W, 3) if kind == "colour" else (H, W)
    return [jpeg_bytes(rng.integers(0, 256, shape).astype(np.uint8), 90) for _ in range(n)]


MPO_FORMS = ["grey", "colour", "big-endian", "three", "shapes", "grey-and-colour", "ultra-hdr",
             "not-jpeg-format", "count-1", "count-0", "entries-short", "no-tiff-header",
             "offset-past-file", "offset-not-jpeg"]


@pytest.mark.parametrize("form", MPO_FORMS)
def test_mpo_forms(form, tmp_path):
    """MPOs of ``mpo_bytes`` over the tests' JPEG writer: pictures that
    differ in shape raise in both (``np.stack``), and so do a grey and a
    colour one in the port (PIL 12.1 frees its heap twice when a later
    frame's mode differs, so it is not asked), an Ultra HDR
    file and an index PIL cannot read (a picture not of JPEG format, one
    picture, no TIFF header) are one JPEG, entries shorter than the count
    raise (PIL opens nothing), and so do offsets past the file or not at a
    JPEG."""
    rng = _rng("mpo" + form)
    jpegs = _jpegs("colour" if form == "colour" else "grey", rng, 3 if form == "three" else 2)
    if form == "shapes":
        jpegs[1] = jpeg_bytes(rng.integers(0, 256, (H + 2, W)).astype(np.uint8), 90)
    if form == "grey-and-colour":
        jpegs[1] = _jpegs("colour", rng, 1)[0]
    kw = {"big-endian": {"big": True}, "ultra-hdr": {"ultra_hdr": True},
          "not-jpeg-format": {"formats": [0, 1]}, "count-1": {"count": 1},
          "count-0": {"count": 0}, "entries-short": {"count": 3},
          "offset-past-file": {"offsets": [0, 10 ** 6]},
          "offset-not-jpeg": {"offsets": [0, 40]}}.get(form, {})
    data = mpo_bytes(jpegs, **kw)
    if form == "no-tiff-header":
        at = data.index(b"MPF\0") + 4
        data = data[:at] + b"XX" + data[at + 2:]
    path = _file(tmp_path, "x.jpg", data)
    if form == "grey-and-colour":  # PIL 12.1 frees its heap twice on this file: not asked
        with pytest.raises(ValueError, match="pages differ in shape"):
            imread(path)
        np.testing.assert_array_equal(imread_gray(path), jax_gray(path))
        return
    _held(path)
    if form in ("grey", "colour", "big-endian", "three"):
        assert imread(path).shape[0] == len(jpegs)
    if form in ("ultra-hdr", "not-jpeg-format", "count-1", "no-tiff-header"):
        assert imread(path).shape == (H, W)


# ----- files PIL and cv2 write ---------------------------------------------------

PIL_SAVES = ([("SGI", "sgi", m, {"bpc": b}) for m in ("L", "RGB", "RGBA") for b in (1, 2)]
             + [("PCX", "pcx", m, {}) for m in ("1", "L", "P", "RGB")]
             + [("QOI", "qoi", m, {}) for m in ("RGB", "RGBA")]
             + [("IM", "im", m, {}) for m in ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16L",
                                               "I;16B", "F", "RGB", "RGBA", "RGBX", "CMYK",
                                               "YCbCr")]
             + [("XBM", "xbm", "1", kw) for kw in ({}, {"hotspot": (3, 4)})]
             + [("MSP", "msp", "1", {})])


@pytest.mark.parametrize("size", [(H, W), (40, 37)], ids=["11x13", "40x37"])
@pytest.mark.parametrize("fmt,ext,mode,kw", PIL_SAVES,
                         ids=[f"{f}-{m}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for f, _, m, kw in PIL_SAVES])
def test_files_pil_writes(fmt, ext, mode, kw, size, tmp_path):
    im = _pil(mode, _rng(fmt + mode + str(kw) + str(size)), *size)
    _held(_file(tmp_path, f"x.{ext}", _saved(im, fmt, **kw)))


HDR_WRITES = [(h, w, rle) for h, w in ((H, W), (11, 5), (3, 300)) for rle in (True, False)]


@pytest.mark.parametrize("h,w,rle", HDR_WRITES,
                         ids=[f"{h}x{w}-{'rle' if r else 'flat'}" for h, w, r in HDR_WRITES])
def test_hdr_cv2_writes(h, w, rle, tmp_path):
    """cv2's own Radiance files: ``imread`` raises (PIL opens none),
    ``imread_gray`` is cv2's float32 blue."""
    rng = _rng(f"hdr{h}{w}{rle}")
    img = (rng.random((h, w, 3)) * 4).astype(np.float32)
    img[0, :3] = 0
    img[1, 1] = 1e-30
    path = str(tmp_path / "x.hdr")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_HDR_COMPRESSION,
                                   cv2.IMWRITE_HDR_COMPRESSION_RLE if rle
                                   else cv2.IMWRITE_HDR_COMPRESSION_NONE])
    _held(path)
    assert imread_gray(path).dtype == np.float32


# ----- SGI -----------------------------------------------------------------------

SGI_FORMS = [(c, bpc, rle, h) for c in (1, 3, 4) for bpc in (1, 2) for rle in (False, True)
             for h in ((H, 1) if c == 1 else (H,))]


@pytest.mark.parametrize("channels,bpc,rle,height", SGI_FORMS,
                         ids=[f"c{c}-bpc{b}-{'rle' if r else 'raw'}-h{h}"
                              for c, b, r, h in SGI_FORMS])
def test_sgi(channels, bpc, rle, height, tmp_path):
    rng = _rng(f"sgi{channels}{bpc}{rle}{height}")
    shape = (height, W) + ((channels,) if channels > 1 else ())
    px = rng.integers(0, 256 ** bpc, shape).astype(np.uint16 if bpc == 2 else np.uint8)
    px[:, 2:9] = px[:, 2:3]  # runs
    path = _file(tmp_path, "x.sgi", sgi_bytes(px, bpc, rle))
    _held(path)
    np.testing.assert_array_equal(imread(path), (px >> 8) if bpc == 2 else px)


# crafted rows of file row 1 in a 3 x 6 grey RLE image
SGI_ROWS = {"short": bytes([0x83, 1, 2, 3, 0]), "ends-image": bytes([0x06, 7]),
            "run-then-zero": bytes([0x06, 7, 0, 0, 0]),
            "past-its-row": bytes([0x83, 1, 2, 3, 0x83, 4, 5, 6, 0x81, 9, 0]),
            "no-end": bytes([0x83, 1, 2, 3]), "copy-to-last-byte": bytes([0x86, 1, 2, 3, 4, 5, 6])}


# crafted table entries of file row 1: (its start from the file's length,
# its length), None as written
SGI_TABLES = {"table-outside": (lambda n: n + 10, None),
              "table-before-data": (lambda n: 500, None),
              "start-at-last-byte": (lambda n: n - 1, None), "length-huge": (None, 10 ** 6),
              "length-0": (None, 0), "length-1": (None, 1), "length-2": (None, 2),
              "length-negative": (None, 2 ** 31 + 15)}


@pytest.mark.parametrize("form", list(SGI_ROWS) + list(SGI_TABLES))
def test_sgi_crafted_rows(form, tmp_path):
    """PIL's reading of RLE rows, as the port's: a short row keeps the
    last row's samples, a last packet that is not 0 ends the image (rows
    not reached 0), a run past its row, a read past the last byte and a
    row starting in the header raise; a row's length counts its packets
    and bounds nothing else (a huge one reads, 0 keeps the last row, as
    does one of 2^31 or more, negative to PIL's int; 1 ends the image at a
    packet that is not 0)."""
    rng = _rng("sgirow" + form)
    g = rng.integers(0, 256, (3, 6)).astype(np.uint8)
    data = bytearray(sgi_bytes(g, rle=True,
                               rows={(1, 0): SGI_ROWS[form]} if form in SGI_ROWS else None))
    start, length = SGI_TABLES.get(form, (None, None))
    if start is not None:
        struct.pack_into(">I", data, 512 + 4, start(len(data)))
    if length is not None:
        struct.pack_into(">I", data, 512 + 3 * 4 + 4, length)
    path = _file(tmp_path, "x.sgi", bytes(data))
    _held(path)
    if form in ("short", "ends-image", "run-then-zero"):
        got = imread(path)
        assert got.shape == (3, 6)


# ----- PCX and DCX ---------------------------------------------------------------

PCX_FORMS = [(kind, w, stride) for kind in ("bits", "planes2", "planes4", "grey", "grey-pal",
                                            "colour-pal", "rgb")
             for w in (12, 13, 8) for stride in ("even", "exact", "wide")]


def _pcx_image(kind, w, rng):
    g = rng.integers(0, 256, (H, w)).astype(np.uint8)
    g[3:6] = 200
    if kind == "bits":
        return g > 127, {}
    if kind in ("planes2", "planes4"):
        n = int(kind[-1])
        return g % (1 << n), {"planes": n, "palette": rng.integers(0, 256, (16, 3))}
    if kind == "rgb":
        c = rng.integers(0, 256, (H, w, 3)).astype(np.uint8)
        c[:, 2:7] = 0xC5
        return c, {}
    pal = {"grey-pal": np.repeat(np.arange(256)[:, None], 3, 1),
           "colour-pal": rng.integers(0, 256, (256, 3))}.get(kind)
    return g, {"palette": pal}


@pytest.mark.parametrize("kind,width,stride", PCX_FORMS,
                         ids=[f"{k}-w{w}-{s}" for k, w, s in PCX_FORMS])
def test_pcx(kind, width, stride, tmp_path):
    """Every mode PIL reads, at widths whose rows pad to even or not, with
    the header's stride the even one, the exact one or a wider one (PIL
    computes its own; a wider one misreads or raises in both); an 8-bit
    file without a palette is shorter than 769 bytes here (both raise)."""
    rng = _rng(f"pcx{kind}{width}{stride}")
    px, kw = _pcx_image(kind, width, rng)
    bits = 1 if kind in ("bits", "planes2", "planes4") else 8
    exact = (width * bits + 7) // 8
    kw["stride"] = {"even": exact + exact % 2, "exact": exact, "wide": exact + 4}[stride]
    path = _file(tmp_path, "x.pcx", pcx_bytes(px, **kw))
    _held(path)
    if stride != "wide" and kind != "grey":
        np.testing.assert_array_equal(imread(path), px)


@pytest.mark.parametrize("form", ["run-across-rows", "run-into-palette", "short", "version-2",
                                  "bits-2", "box-empty"])
def test_pcx_crafted(form, tmp_path):
    """A run across a scanline raises in both; data run on into the
    palette after the image (PIL's decoder does not stop at it); forms PIL
    does not read raise."""
    g = np.zeros((2, 4), np.uint8)
    pal = np.repeat(np.arange(256)[:, None], 3, 1)
    body = {"run-across-rows": bytes([0xC8, 7]), "run-into-palette": bytes([0xC3, 7]),
            "short": bytes([0xC3, 7])}.get(form)
    data = bytearray(pcx_bytes(g, palette=None if form == "short" else pal, body=body))
    if form == "version-2":
        data[1] = 2
    if form == "bits-2":
        data[3] = 2
    if form == "box-empty":
        struct.pack_into("<H", data, 8, 0xFFFF)
    _held(_file(tmp_path, "x.pcx", bytes(data)))


@pytest.mark.parametrize("form", ["one", "three", "shapes", "rgb", "no-pages"])
def test_dcx(form, tmp_path):
    """DCX pages stack as PIL's frames; pages of different shapes raise in
    both; a table of no pages raises."""
    rng = _rng("dcx" + form)
    pal = np.repeat(np.arange(256)[:, None], 3, 1)
    n = {"one": 1, "no-pages": 0}.get(form, 3)
    pages = []
    for k in range(n):
        if form == "rgb":
            px = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        else:
            px = rng.integers(0, 256, (H + (k if form == "shapes" else 0), W)).astype(np.uint8)
        pages.append(pcx_bytes(px, palette=None if form == "rgb" else pal))
    path = _file(tmp_path, "x.dcx", dcx_bytes(pages))
    _held(path)
    if form in ("three", "rgb"):
        assert imread(path).shape[0] == 3


# ----- QOI -----------------------------------------------------------------------


QOI_FORMS = ["rgb", "rgba", "runs", "long-runs", "index", "diffs", "alpha-steps",
             "index-never-filled", "run-fills-no-slot", "channels-7", "run-past-end", "cut-op",
             "cut-stream"]


def _qoi_ops_image(form, rng):
    if form in ("rgb", "rgba"):
        return rng.integers(0, 256, (H, W, 3 if form == "rgb" else 4)).astype(np.uint8)
    if form == "runs":
        px = np.zeros((H, W, 3), np.uint8)
        px[4:] = 90
        return px
    if form == "long-runs":
        px = np.full((20, 37, 4), 200, np.uint8)
        px[5, 5] = 1
        return px
    if form == "index":  # a few colours again and again
        pal = rng.integers(0, 256, (5, 4)).astype(np.uint8)
        return pal[rng.integers(0, 5, (H, W))]
    if form == "diffs":  # small and medium steps: DIFF and LUMA
        steps = rng.integers(-20, 21, (H * W, 3))
        steps[::3] = rng.integers(-2, 2, (len(steps[::3]), 3))
        return (np.cumsum(steps, 0) % 256).astype(np.uint8).reshape(H, W, 3)
    px = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    px[..., 3] = rng.integers(0, 3, (H, W)) * 100
    return px


@pytest.mark.parametrize("form", QOI_FORMS)
def test_qoi(form, tmp_path):
    """Every op of the writer's streams, and crafted ones: an INDEX of a
    slot never filled is (0, 0, 0, 0), a RUN fills no slot (so the first
    pixel's slot stays empty after a leading run), any channel count but 3
    is RGBA, a run past the image is cut; a stream cut short raises."""
    rng = _rng("qoi" + form)
    crafted = {"index-never-filled": (bytes([0xFE, 9, 8, 7, 17, 0xC2, 17]), (6, 1), 4),
               "run-fills-no-slot": (bytes([0xC1, 0xFE, 10, 20, 30, 53, 0]), (5, 1), 4),
               "channels-7": (bytes([0xFF, 1, 2, 3, 4, 0xC3]), (5, 1), 7),
               "run-past-end": (bytes([0xFD] * 3), (100, 1), 3),
               "cut-op": (bytes([0xFE, 1, 2, 3, 0xFF, 1, 2]), (3, 1), 4),
               "cut-stream": (bytes([0xFE, 1, 2, 3, 0xC1]), (9, 1), 3)}
    if form in crafted:
        ops, size, channels = crafted[form]
        data = qoi_bytes(ops=ops, size=size, channels=channels)[:-8 if "cut" in form else None]
    else:
        px = _qoi_ops_image(form, rng)
        data = qoi_bytes(px)
    path = _file(tmp_path, "x.qoi", data)
    _held(path)
    if form not in crafted:
        np.testing.assert_array_equal(imread(path), px)


# ----- IM ------------------------------------------------------------------------

# image type -> (the array's dtype or kind, the writer's raw mode)
IM_TYPES = {"0 1": ("bool", "1"), "L 1": ("bool", "1"), "B1": ("bool", "1"),
            "B2": ("idx2", "P;2"), "B4": ("idx4", "P;4"), "Greyscale": ("u1", "L"),
            "Grayscale": ("u1", "L"), "RGB": ("rgb", "RGB;L"), "X 24": ("rgb", "RGB"),
            "LA": ("la", "LA;L"), "RGBA": ("rgba", "RGBA;L"), "RGBX": ("rgbx", "RGBA;L"),
            "CMYK": ("rgba", "CMYK;L"), "YCC": ("rgb", "YCbCr;L"), "L 16": ("<u2", "I;16"),
            "L 16L": ("<u2", "I;16L"), "L 16B": (">u2", "I;16B"), "L*16L": ("<u2", "I;16L"),
            "L 32S": ("<i4", "I;32S"), "L 32 S": ("<i4", "I;32S"), "L*32S": ("<i4", "I;32S"),
            "L 8": ("u1", "F;8"), "L 8S": ("i1", "F;8S"), "L*8": ("u1", "F;8"),
            "L 16S": ("<i2", "F;16S"), "L*16": ("<u2", "F;16"), "L 32": ("<u4", "F;32"),
            "L 32 F": ("<u4", "F;32"), "L 32F": ("<f4", "F;32F"), "L*32F": ("<f4", "F;32F"),
            "RGB3": ("planes", None), "RYB3": ("planes", None), "L*12": ("bits", None),
            "RLB": ("rgb", "RGB")}


def _im_array(kind, rng, h=H, w=W):
    if kind == "bool":
        return rng.random((h, w)) > 0.5
    if kind.startswith("idx"):
        return rng.integers(0, 1 << int(kind[3]), (h, w)).astype(np.uint8)
    n = {"rgb": 3, "la": 2, "rgba": 4, "rgbx": 4}.get(kind)
    if n:
        return rng.integers(0, 256, (h, w, n)).astype(np.uint8)
    dt = np.dtype(kind)
    if dt.kind == "f":
        return rng.normal(size=(h, w)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, (h, w)).astype(dt)


@pytest.mark.parametrize("image_type", list(IM_TYPES))
def test_im_types(image_type, tmp_path):
    """Every image type of ``ImImagePlugin.OPEN`` the writer packs (RLB,
    for which PIL has no raw mode, raises in both); the L*n types of n bits
    other than 8, 16 and 32 read as PIL's bit decoder reads them
    (``tests/test_torch_icons.py`` holds more of them)."""
    rng = _rng("im" + image_type)
    kind, rawmode = IM_TYPES[image_type]
    if kind in ("planes", "bits"):
        frame = rng.integers(0, 256, 3 * H * W).astype(np.uint8).tobytes()
        data = im_bytes([frame], image_type, size=(W, H))
    else:
        data = im_bytes(_im_array(kind, rng), image_type, rawmode=rawmode)
    path = _file(tmp_path, "x.im", data)
    if kind == "bits":
        assert jax_load(path).shape == (H, W)
    _held(path)


IM_LUTS = [(t, lut) for t in ("Greyscale", "LA", "PA", "B2", "B4", "RGB", "0 1")
           for lut in ("linear", "grey", "colour")]


@pytest.mark.parametrize("image_type,lut", IM_LUTS, ids=[f"{t}-{lut}" for t, lut in IM_LUTS])
def test_im_luts(image_type, lut, tmp_path):
    """A Lut not grey turns L into P and LA into PA, and B2 and B4 into
    8-bit samples (the file's packed ones then misread, or run past its
    end: both raise); PA without one raises in both."""
    rng = _rng(f"imlut{image_type}{lut}")
    table = {"linear": np.repeat(np.arange(256)[:, None], 3, 1),
             "grey": np.repeat((255 - np.arange(256))[:, None], 3, 1),
             "colour": rng.integers(0, 256, (256, 3))}[lut]
    kind, rawmode = IM_TYPES.get(image_type, ("la", "LA;L"))
    data = im_bytes(_im_array(kind, rng), image_type, lut=table, rawmode=rawmode)
    _held(_file(tmp_path, "x.im", data))


IM_FRAMES = [("Greyscale", 3), ("Greyscale", 1), ("0 1", 3), ("L 16", 4), ("L 32F", 3),
             ("B4", 3), ("RGB", 3), ("YCC", 2), ("LA", 3), ("L 32S", 5), ("RGB3", 2)]


@pytest.mark.parametrize("image_type,n", IM_FRAMES, ids=[f"{t}-x{n}" for t, n in IM_FRAMES])
def test_im_frames(image_type, n, tmp_path):
    """Frames where PIL finds them, k times the frame size it computes from
    the mode's name: L, 1 and RGB read; the others misread (F) or run past
    the file (I;16, B4, YCbCr: both raise), as PIL's frames do."""
    rng = _rng(f"imframes{image_type}{n}")
    kind, rawmode = IM_TYPES[image_type]
    if kind == "planes":
        frames = [rng.integers(0, 256, 3 * H * W).astype(np.uint8).tobytes()
                  for _ in range(n)]
        data = im_bytes(frames, image_type, size=(W, H))
    else:
        data = im_bytes([_im_array(kind, rng) for _ in range(n)], image_type, rawmode=rawmode)
    path = _file(tmp_path, "x.im", data)
    _held(path)
    if image_type in ("Greyscale", "0 1", "RGB") and n > 1:
        assert imread(path).shape[0] == n


IM_HEADERS = {
    "lf-lines": b"Image type: Greyscale image\nImage size (x*y): 13*11\n",
    "cr-first": b"\rImage type: Greyscale image\r\n\rImage size (x*y): 13*11\r\n",
    "comma-size": b"Image type: Greyscale image\nImage size (x*y): 13,11\n",
    "unknown-key": b"Foo: bar\nImage size (x*y): 13*11\n",
    "comments": b"Comment: a\nComment: b\nImage size (x*y): 13*11\n",
    "blank-line": b"Image type: Greyscale image\n\nImage size (x*y): 13*11\n",
    "no-known-key": b"Foo: bar\n",
    "float-size": b"Image type: Greyscale image\nImage size (x*y): 13.0*11\n",
    "text-size": b"Image type: Greyscale image\nImage size (x*y): a*b\n",
    "spaces-in-type": b"Image type:  Greyscale image  \nImage size (x*y): 13*11\n",
    "unknown-type": b"Image type: Foo image\nImage size (x*y): 13*11\n",
    "frames-0": b"Image size (x*y): 13*11\nFile size (no of images): 0\n",
    "frames-pair": b"Image size (x*y): 13*11\nFile size (no of images): 2,2\n",
    "frames-float": b"Image size (x*y): 13*11\nFile size (no of images): 1.0\n",
    "long-line": b"Name: " + b"n" * 120 + b"\nImage size (x*y): 13*11\n",
    "no-size": b"Image type: Greyscale image\n",
    "no-newline": b"Image type: Greyscale image",
    "zero-size": b"Image size (x*y): 0*11\n",
}


@pytest.mark.parametrize("form", list(IM_HEADERS))
def test_im_headers(form, tmp_path):
    """PIL's reading of the text header: LF or CRLF lines, a CR before a
    line skipped, sizes by "*" or ","; a blank line, a line over 100 bytes,
    no known key and no newline in the first 100 bytes are not IM (both
    raise); a size or type PIL cannot use raises; the default size is 512
    x 512."""
    rng = _rng("imhead" + form)
    g = rng.integers(0, 256, (512, 512)).astype(np.uint8)
    head = IM_HEADERS[form]
    body = g[::-1].tobytes() if form == "no-size" else g[-11:, :13][::-1].tobytes()
    data = head + (b"" if form == "no-newline" else b"\0" * 5 + b"\x1a") + body
    _held(_file(tmp_path, "x.im", data))


# ----- XBM and MSP ---------------------------------------------------------------

XBM_FORMS = ["plain", "hotspot", "upper", "one-a-line", "odd-width", "junk-x", "short-hex",
             "indented", "indented-too-far", "cut"]


@pytest.mark.parametrize("form", XBM_FORMS)
def test_xbm(form, tmp_path):
    """Each ``x`` and the two characters after it are a byte (0-9, a-f,
    A-F, else 0; an x inside a byte is a digit), least significant bit
    first; PIL's check sees 16 bytes (leading whitespace past that is not
    XBM); a file cut short raises."""
    rng = _rng("xbm" + form)
    bits = rng.random((H, 21 if form == "odd-width" else W)) > 0.5
    data = xbm_bytes(bits, hotspot=(2, 5) if form == "hotspot" else None,
                     upper=form == "upper", per_line=1 if form == "one-a-line" else 12)
    if form == "junk-x":
        data = data.replace(b"0x", b"0xx", 3).replace(b", 0x", b", x1 0x", 2)
    if form == "short-hex":
        data = data.replace(b"0x0", b"0x", 4)
    if form == "indented":
        data = b"  \t " + data
    if form == "indented-too-far":
        data = b" " * 14 + data
    if form == "cut":
        data = data[:len(data) // 2]
    path = _file(tmp_path, "x.xbm", data)
    _held(path)
    if form in ("plain", "hotspot", "upper", "one-a-line", "odd-width", "indented"):
        np.testing.assert_array_equal(imread(path), bits)


MSP_FORMS = [(v, w) for v in (1, 2) for w in (13, 16, 24)] + [
    (2, "blank-rows"), (2, "long-run"), (2, "literal-cut"), (2, "run-cut"), (2, "bad-checksum"),
    (2, "row-past-file"), (1, "short")]


@pytest.mark.parametrize("version,form", MSP_FORMS, ids=[f"v{v}-{f}" for v, f in MSP_FORMS])
def test_msp(version, form, tmp_path):
    """Versions 1 and 2; blank rows (length 0); a run longer than its row
    and a literal cut at its row's end shift the rows after them (PIL joins
    the rows' bytes), a run cut within its row, a row past the file, a
    short file and a bad checksum raise."""
    rng = _rng(f"msp{version}{form}")
    w = form if isinstance(form, int) else 16
    bits = rng.random((H, w)) > 0.5
    bits[3:6] = True
    rows = {"long-run": {1: bytes([0, 5, 0xF0])}, "literal-cut": {1: bytes([3, 0xAA])},
            "run-cut": {1: bytes([0, 2])}}.get(form)
    data = bytearray(msp_bytes(bits, version, rows=rows))
    if form == "blank-rows":
        assert b"\0\0" in data[32:32 + 2 * H]
    if form == "bad-checksum":
        data[24] ^= 1
    if form == "row-past-file":
        data = data[:-3]
    if form == "short":
        data = data[:-5]
    path = _file(tmp_path, "x.msp", bytes(data))
    _held(path)
    if isinstance(form, int) or form == "blank-rows":
        np.testing.assert_array_equal(imread(path), bits)


# ----- Radiance HDR --------------------------------------------------------------

HDR_HEADERS = {
    "rgbe": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n",
    "comments": b"#?RADIANCE\n# made by a test\nSOFTWARE=x\nFORMAT=32-bit_rle_rgbe\n\n",
    "exposure": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=4.0\nGAMMA=2.2\n\n",
    "format-twice": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\nFORMAT=32-bit_rle_rgbe\n\n",
    "sig-tail": b"#?RADIANCEX\nFORMAT=32-bit_rle_rgbe\n\n",
    "long-line": b"#?RADIANCE\n# " + b"c" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n",
    "no-format": b"#?RADIANCE\n\n",
    "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n",
    "format-space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n",
    "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n",
    "no-blank": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
    "nul-line": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\0x\n",
}
HDR_SIZES = {"+Y": b"+Y %d +X %d\n", "-X": b"-Y %d -X %d\n", "spaced": b"-Y  %d  +X  %d  \n",
             "tight": b"-Y%d+X%d\n", "zero": b"-Y 0 +X %d\n"}


@pytest.mark.parametrize("form", [f"rle-{r}-w{w}" for r in ("new", "flat", "old")
                                  for w in (5, 13, 200)]
                         + [f"header-{k}" for k in HDR_HEADERS]
                         + [f"size-{k}" for k in HDR_SIZES]
                         + ["new-then-flat", "exponents", "wrong-width", "count-0", "cut"])
def test_hdr(form, tmp_path):
    """Scanlines flat, in the new RLE (flat under a width of 8), the old
    RLE (cv2 does not expand it: with runs the data ends early, and both
    raise), a flat rest after new-RLE rows, exponents 0, 1 and 255; cv2's
    header rules (FORMAT exactly, a blank line, ``-Y h +X w``); a damaged
    scanline raises."""
    rng = _rng("hdr" + form)
    w = int(form.rsplit("-w", 1)[1]) if form.startswith("rle-") else W
    rgbe = rng.integers(0, 256, (H, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (H, w))
    rgbe[2:5, 1:w - 1] = rgbe[2, 1]  # runs
    kw = {}
    if form.startswith("rle-"):
        kw["rle"] = form.split("-")[1]
    if form.startswith("header-"):
        kw["header"] = HDR_HEADERS[form[7:]]
    if form.startswith("size-"):
        line = HDR_SIZES[form[5:]]
        kw["resolution"] = line % ((H, w) if line.count(b"%d") == 2 else (w,))
    if form == "exponents":
        rgbe[0, :3, 3] = (0, 1, 255)
    data = hdr_bytes(rgbe, **kw)
    if form == "new-then-flat":
        data = hdr_bytes(rgbe[:3]) + rgbe[3:].tobytes()
        data = data.replace(b"-Y 3 ", b"-Y %d " % H)
    if form == "wrong-width":
        data = data.replace(bytes((2, 2, 0, w)), bytes((2, 2, 0, w + 1)), 1)
    if form == "count-0":
        at = data.index(bytes((2, 2, 0, w))) + 4
        data = data[:at] + b"\0" + data[at + 1:]
    if form == "cut":
        data = data[:-20]
    path = _file(tmp_path, "x.hdr", data)
    _held(path)


# ----- damaged data, encoders, identification, datasets -----------------------------


def _damaged(fmt):
    rng = _rng("damaged" + fmt)
    g = rng.integers(0, 256, (H, W)).astype(np.uint8)
    if fmt == "sgi":
        return "x.sgi", sgi_bytes(g, rle=True, rows={(1, 0): bytes([0x8F]) + bytes(15)}), \
            "damaged RLE"
    if fmt == "pcx":
        return "x.pcx", pcx_bytes(g, palette=np.zeros((256, 3)),
                                  body=bytes([0xFF, 1]) * H), "damaged RLE"
    if fmt == "dcx":
        good = pcx_bytes(g, palette=np.zeros((256, 3)))
        return "x.dcx", dcx_bytes([good, good[:300]]), "DCX page 1: .* bytes decoded of the"
    if fmt == "qoi":
        return "x.qoi", qoi_bytes(np.dstack([g] * 3))[:40], "the op stream ends at pixel"
    if fmt == "msp":
        return "x.msp", msp_bytes(g > 127, 2, rows={2: bytes([0, 9])}), "damaged RLE"
    if fmt == "hdr":
        data = hdr_bytes(rgbe_of(np.dstack([g] * 3) / 255.0))
        return "x.hdr", data.replace(bytes((2, 2, 0, W)), bytes((2, 2, 0, W + 1))), \
            "damaged RLE"
    jpegs = [jpeg_bytes(g, 90), jpeg_bytes(g, 90)[:200]]
    return "x.jpg", mpo_bytes(jpegs), "MPO picture 1"


@pytest.mark.parametrize("fmt", ["sgi", "pcx", "dcx", "qoi", "msp", "hdr", "mpo"])
def test_damaged_data_names_the_file(fmt, tmp_path):
    name, data, match = _damaged(fmt)
    path = _file(tmp_path, name, data)
    reads = (imread,) if fmt in ("dcx", "mpo") else (imread, imread_gray)  # page 0 is whole
    for read in reads:
        with pytest.raises(ValueError, match=match) as err:
            read(path)
        assert path in str(err.value)
    if fmt == "hdr":
        assert _outcome_is_error(jax_gray, path)


def _outcome_is_error(fn, path) -> bool:
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(path) is None
    except Exception:  # noqa: BLE001  an oracle's refusal, of any type
        return True


def test_encoders_round_trip():
    """Each encoder of ``_raster_writer`` decodes back through the host
    library: SGI RLE at 8 and 16 bits (long runs and literals past 127),
    PCX RLE (bytes of the top two bits set, runs past 63), QOI's op stream
    (every op), MSP version 2 rows (runs past 255), HDR's new RLE (runs
    past 127, literals past 128)."""
    rng = np.random.default_rng(20)
    for bpc in (1, 2):
        row = rng.integers(0, 256 ** bpc, 700).astype(np.uint16 if bpc == 2 else np.uint8)
        row[100:400] = 5
        enc = sgi_rle_row(row, bpc)
        out, got = native.sgi_rle_decode(enc + b"\0\0", [512], [len(enc)], 700, 1, 1, bpc)
        assert got == 1
        np.testing.assert_array_equal(out.reshape(700, bpc)[:, 0],
                                      (row >> 8) if bpc == 2 else row)
    line = rng.integers(0xBE, 0xC4, 900).astype(np.uint8)
    line[10:300] = 0xC9
    out, got = native.pcx_rle_decode(pcx_rle(line.tobytes()), 900, 1)
    assert got == 900 and np.array_equal(out, line)
    px = rng.integers(0, 4, (30, 40, 4)).astype(np.uint8) * 60
    px[5:9] = 7
    px[12, :, :3] += rng.integers(0, 3, (40, 3)).astype(np.uint8)
    out, got = native.qoi_decode(qoi_ops(px), 1200)
    assert got == 1200 and np.array_equal(out.reshape(30, 40, 4), px)
    row = rng.integers(0, 256, 2000).astype(np.uint8)
    row[50:1500] = 3
    enc = msp_rle_row(row.tobytes())
    out, got = native.msp_decode(enc, [len(enc)], 2000, 2000)
    assert got == 2000 and np.array_equal(out, row)
    rgbe = rng.integers(0, 256, (3, 1000, 4)).astype(np.uint8)
    rgbe[:, 100:600] = 9
    data = b"".join(hdr_scanline(r) for r in rgbe)
    out, status = native.hdr_rle_decode(data, 1000, 3)
    assert status == 0 and np.array_equal(out, rgbe)


def test_identify_follows_pils_order(tmp_path):
    """PIL's order decides: an IM header (no check of its own, tried
    after ICO) before MSP, QOI, SGI and XBM; PCX's weak check (10, then a
    version byte) before DCX and the rest; a Radiance HDR is cv2's
    alone."""
    g = np.zeros((4, 5), np.uint8)
    assert raster.identify(im_bytes(g, "Greyscale", rawmode="L")) == "IM"
    assert raster.identify(sgi_bytes(g)) == "SGI"
    assert raster.identify(b"\x0a\x05" + bytes(200)) == "PCX"
    assert raster.identify(dcx_bytes([pcx_bytes(g)])) == "DCX"
    assert raster.identify(qoi_bytes(np.zeros((4, 5, 3), np.uint8))) == "QOI"
    assert raster.identify(msp_bytes(g > 0)) == "MSP"
    assert raster.identify(xbm_bytes(g > 0)) == "XBM"
    assert raster.identify(b" " * 14 + xbm_bytes(g > 0)) is None
    assert raster.identify(hdr_bytes(np.zeros((4, 9, 4), np.uint8))) == "HDR"
    # an IM-like header that names a known key, written before a QOI magic
    qoi = b"Name: x\n\x1a" + qoi_bytes(np.zeros((4, 5, 3), np.uint8))
    assert raster.identify(qoi) == "IM"
    path = _file(tmp_path, "x.im", qoi)
    _held(path)


def test_datasets_read_sgi_images_and_pcx_masks(tmp_path):
    """A training folder of SGI images and PCX masks reads as the JAX
    package reads it (``_imread_gray``), and as the same slices in PNG."""
    from empanada_tpu_torch.data.datasets import SingleClassInstanceDataset

    rng = _rng("dataset")
    for ext in ("sgi", "png"):
        for sub in ("images", "masks"):
            os.makedirs(tmp_path / ext / "src" / sub)
    for i in range(3):
        img = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        mask = np.zeros((32, 32), np.uint8)
        mask[4:14, 5:15], mask[18:30, 16:28] = 1, 2
        (tmp_path / "sgi" / "src" / "images" / f"{i}.sgi").write_bytes(sgi_bytes(img, rle=True))
        (tmp_path / "sgi" / "src" / "masks" / f"{i}.pcx").write_bytes(pcx_bytes(
            mask, palette=np.repeat(np.arange(256)[:, None], 3, 1)))
        Image.fromarray(img).save(tmp_path / "png" / "src" / "images" / f"{i}.png")
        Image.fromarray(mask).save(tmp_path / "png" / "src" / "masks" / f"{i}.png")
        for p in ("images", "masks"):
            path = str(next((tmp_path / "sgi" / "src" / p).glob(f"{i}.*")))
            np.testing.assert_array_equal(imread_gray(path), jax_gray(path))
    got = SingleClassInstanceDataset(str(tmp_path / "sgi"))
    want = SingleClassInstanceDataset(str(tmp_path / "png"))
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
