"""XPM, ICO and CUR, PSD, ICNS (``data/icons.py``) and IM's ``L*n`` images
of 2 to 31 bits (``data/plugins.py``), read by the port on the CPU at
small sizes; every comparison is exact (tolerance 0): ``imread`` against
the JAX package's ``cli._load_array`` (PIL) and ``imread_gray`` against
its ``datasets._imread_gray`` (cv2, which reads none of them, then PIL),
in dtype, shape and every sample, or both raising, on the same file:

- files PIL writes (ICO of PNG and BMP members, ICNS) and seeded files of
  ``_raster_writer`` for every form PIL reads: XPM of 1 and 2 characters a
  pixel, palettes and RGB, ``None``, symbolic pairs, short and long hex;
  ICO of PNG members and DIB members of 1, 4, 8, 24 and 32 bits (palettes,
  grey palettes, short palettes, AND masks, 32-bit alpha, top-down rows,
  a directory that says 32 bits over a 24-bit DIB), PIL's choice among
  entries; CUR's choice and its 32-bit quirk (BGRA at byte 22); PSD in
  every colour mode PIL reads, raw and PackBits (odd packets, a fifth
  channel), resources, one layer, two layers (``imread`` raises as
  ``_load_array`` does, ``imread_gray`` reads the composite); ICNS of RLE
  RGB with masks, raw RGB, PNG and JPEG 2000 members, PIL's largest size;
  IM ``L*n`` at widths that pad rows;
- forms PIL refuses, and damaged files, raise naming the file; the
  port's own refusals name their reason (an ICNS RGB of runs without a
  mask, whose array PIL fills from memory it never set).
"""

import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from _raster_writer import (
    icns_bytes,
    icns_rle,
    ico_bytes,
    ico_dib,
    im_bits,
    im_bytes,
    psd_bytes,
    xpm_bytes,
)
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import raster
from empanada_tpu_torch.data.imread import imread, imread_gray
from empanada_tpu_torch.data.imwrite import png_bytes


def _oracle(read, path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return read(path)
        except Exception:  # PIL's ValueError, OSError, EOFError, KeyError...
            return None


def _check(tmp_path, name, data, refused=None):
    """Both readers on ``data`` written to ``name``: the JAX readers' array
    or both raising (naming the file); ``refused`` names the port's own
    refusal where the JAX readers read.  Returns what ``imread`` read."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    out = []
    for read, oracle in ((imread, jax_load), (imread_gray, jax_gray)):
        want = _oracle(oracle, path)
        if want is None or refused:
            with pytest.raises(ValueError, match=refused or name):
                read(path)
            out.append(None)
            continue
        got = read(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                      want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)
        out.append(got)
    return out[0]


def _png(array, mode=None):
    buf = io.BytesIO()
    Image.fromarray(array, mode).save(buf, "PNG")
    return buf.getvalue()


# ----- XPM ---------------------------------------------------------------------

def _hex(rng, n):
    return [f"#{v:06x}" for v in rng.integers(0, 1 << 24, n)]


XPM = {
    "palette": lambda r: xpm_bytes(r.integers(0, 5, (7, 9)), _hex(r, 5)),
    "two-chars": lambda r: xpm_bytes(r.integers(0, 40, (6, 5)), _hex(r, 40), cpp=2),
    "rgb": lambda r: xpm_bytes(r.integers(0, 300, (5, 6)), _hex(r, 300), cpp=2),
    "256-colours": lambda r: xpm_bytes(r.integers(0, 256, (4, 9)), _hex(r, 256), cpp=2),
    "none-unused": lambda r: xpm_bytes(r.integers(1, 4, (5, 5)), ["None"] + _hex(r, 3)),
    "none-used": lambda r: xpm_bytes(r.integers(0, 4, (5, 5)), ["None"] + _hex(r, 3)),
    "symbolic": lambda r: xpm_bytes(r.integers(0, 3, (4, 6)),
                                    ["s a c #ff0000", "m white c #00ff00", "g4 #777 c #123"]),
    "hex-lengths": lambda r: xpm_bytes(r.integers(0, 4, (4, 5)),
                                       ["#fff", "#1234", "#123456789abc", "#0"]),
    "named-colour": lambda r: xpm_bytes(r.integers(0, 2, (3, 3)), ["red", "#00ff00"]),
    "no-c-key": lambda r: xpm_bytes(r.integers(0, 2, (3, 3)), ["m #ffffff", "#00ff00"]),
    "bad-hex": lambda r: xpm_bytes(r.integers(0, 2, (3, 3)), ["#xyz", "#00ff00"]),
    "no-comments": lambda r: xpm_bytes(r.integers(0, 3, (4, 4)), _hex(r, 3), comments=False),
    "no-values": lambda r: b"/* XPM */\nstatic char *x[] = {\n};\n",
    "empty-value": lambda r: xpm_bytes(r.integers(0, 2, (3, 3)), _hex(r, 2),
                                       header=b'" 3 2 1",'),
    "zero-width": lambda r: xpm_bytes(r.integers(0, 2, (3, 3)), _hex(r, 2),
                                      header=b'"0 3 2 1",'),
    "cut-pixels": lambda r: xpm_bytes(r.integers(0, 2, (6, 4)), _hex(r, 2))[:-40],
    "rows-run-on": lambda r: xpm_bytes(r.integers(0, 2, (4, 6)), _hex(r, 2),
                                       header=b'"4 6 2 1",'),
    "short-last-key": lambda r: xpm_bytes(r.integers(0, 9, (3, 3)), _hex(r, 9), cpp=2)
    .replace(b'",\n"', b'x",\n"', 1),
}


@pytest.mark.parametrize("form", list(XPM))
def test_xpm(form, tmp_path):
    _check(tmp_path, "x.xpm", XPM[form](np.random.default_rng(len(form))))


def test_xpm_comment_with_quotes_is_read_as_pixels(tmp_path):
    """PIL takes every line's text between quotes for pixels, a comment's
    too: the rows shift."""
    rng = np.random.default_rng(2)
    data = xpm_bytes(rng.integers(0, 2, (4, 4)), ["#000000", "#ffffff"])
    data = data.replace(b"/* pixels */", b'/* pixels */\n/* "##" */')
    got = _check(tmp_path, "q.xpm", data)
    assert got.shape == (4, 4)


# ----- ICO and CUR ---------------------------------------------------------------

def _pal(rng, n):
    return rng.integers(0, 256, (n, 3))


def _ico_forms():
    r = np.random.default_rng(5)
    rgba = r.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    grey_pal = np.repeat(np.arange(256)[:, None], 3, 1)
    mask = r.integers(0, 2, (16, 16))
    return {
        "png-rgba": ico_bytes([(16, 16, 0, 32, _png(rgba))]),
        "png-grey": ico_bytes([(32, 32, 0, 8, png_bytes(r.integers(0, 256, (32, 32),
                                                                  dtype=np.uint8)))]),
        "png-other-size": ico_bytes([(16, 16, 0, 32, _png(rgba[:8]))]),
        "dib1": ico_bytes([(16, 16, 2, 1, ico_dib(r.integers(0, 2, (16, 16)), 1,
                                                  [[0, 0, 0], [255, 255, 255]], mask))]),
        "dib1-colour": ico_bytes([(16, 16, 2, 1, ico_dib(r.integers(0, 2, (16, 16)), 1,
                                                         _pal(r, 2), mask))]),
        "dib4": ico_bytes([(16, 16, 16, 4, ico_dib(r.integers(0, 16, (16, 16)), 4, _pal(r, 16),
                                                   mask))]),
        "dib8": ico_bytes([(16, 16, 0, 8, ico_dib(r.integers(0, 256, (16, 16)), 8,
                                                  _pal(r, 256), mask))]),
        "dib8-grey": ico_bytes([(16, 16, 0, 8, ico_dib(r.integers(0, 256, (16, 16)), 8,
                                                       grey_pal))]),
        "dib8-short-palette": ico_bytes([(16, 16, 4, 8, ico_dib(r.integers(0, 256, (16, 16)), 8,
                                                                _pal(r, 4)))]),
        "dib24": ico_bytes([(16, 16, 0, 24, ico_dib(r.integers(0, 256, (16, 16, 3),
                                                            dtype=np.uint8), 24, None, mask))]),
        "dib24-odd-width": ico_bytes([(13, 7, 0, 24, ico_dib(r.integers(0, 256, (7, 13, 3),
                                                                     dtype=np.uint8), 24))]),
        "dib24-top-down": ico_bytes([(8, 8, 0, 24, ico_dib(r.integers(0, 256, (8, 8, 3),
                                                                   dtype=np.uint8), 24,
                                                           top_down=True))]),
        "dib32": ico_bytes([(16, 16, 0, 32, ico_dib(rgba, 32))]),
        "dir32-dib24": ico_bytes([(8, 8, 0, 32, ico_dib(r.integers(0, 256, (8, 8, 3),
                                                                dtype=np.uint8), 24))]),
        "choice": ico_bytes([
            (8, 8, 0, 24, ico_dib(r.integers(0, 256, (8, 8, 3), dtype=np.uint8), 24)),
            (16, 16, 0, 32, _png(rgba)),
            (16, 16, 16, 4, ico_dib(r.integers(0, 16, (16, 16)), 4, _pal(r, 16))),
            (16, 16, 0, 0, ico_dib(r.integers(0, 256, (16, 16)), 8, _pal(r, 256)))]),
        "depth-from-colours": ico_bytes([
            (8, 8, 0, 0, ico_dib(r.integers(0, 256, (8, 8)), 8, _pal(r, 256))),
            (8, 8, 16, 0, ico_dib(r.integers(0, 16, (8, 8)), 4, _pal(r, 16)))]),
        "no-entries": struct.pack("<HHH", 0, 1, 0),
        "cut-directory": ico_bytes([(16, 16, 0, 32, _png(rgba))])[:14],
        "cut-member": ico_bytes([(16, 16, 0, 24, ico_dib(rgba[..., :3], 24))])[:200],
        # the AND mask's last row without its padding (PIL reads it), then
        # one byte short of that row (PIL raises)
        "mask-padding-cut": ico_bytes([(16, 16, 16, 4, ico_dib(
            r.integers(0, 16, (16, 16)), 4, _pal(r, 16), mask))])[:-2],
        "mask-row-cut": ico_bytes([(16, 16, 16, 4, ico_dib(
            r.integers(0, 16, (16, 16)), 4, _pal(r, 16), mask))])[:-3],
    }


ICO = _ico_forms()


@pytest.mark.parametrize("form", list(ICO))
def test_ico(form, tmp_path):
    _check(tmp_path, "x.ico", ICO[form])


@pytest.mark.parametrize("bitmap", [False, True], ids=["png", "bmp"])
def test_pil_written_ico(bitmap, tmp_path):
    """PIL's own ICO of an RGBA, RGB, grey or palette image, at several
    sizes: the largest entry, read as PIL reads it."""
    rng = np.random.default_rng(bitmap)
    for mode, shape in (("RGBA", (48, 48, 4)), ("RGB", (40, 40, 3)), ("L", (32, 32)),
                        ("P", (24, 24))):
        im = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                             None if mode != "P" else "L").convert(mode)
        buf = io.BytesIO()
        kw = {"bitmap_format": "bmp"} if bitmap else {}
        im.save(buf, "ICO", sizes=[(16, 16), (24, 24), shape[:2]], **kw)
        _check(tmp_path, f"{mode}.ico", buf.getvalue())


def _cur_forms():
    r = np.random.default_rng(6)
    dib8 = ico_dib(r.integers(0, 256, (8, 8)), 8, _pal(r, 256))
    return {
        "dib8": ico_bytes([(8, 8, 0, 8, dib8)], cursor=True, hotspots=[(3, 4)]),
        "dib1": ico_bytes([(8, 8, 2, 1, ico_dib(r.integers(0, 2, (8, 8)), 1,
                                                [[0, 0, 0], [255, 255, 255]]))], cursor=True),
        "dib32-at-22": ico_bytes([(8, 8, 0, 32, ico_dib(r.integers(0, 256, (8, 8, 4),
                                                                dtype=np.uint8), 32))],
                                 cursor=True),
        "dib32-later": ico_bytes([(4, 4, 0, 8, ico_dib(r.integers(0, 256, (4, 4)), 8,
                                                       _pal(r, 256))),
                                  (8, 8, 0, 32, ico_dib(r.integers(0, 256, (8, 8, 4),
                                                                dtype=np.uint8), 32))],
                                 cursor=True, hotspots=[(1, 1), (2, 2)]),
        "not-wider": ico_bytes([(8, 4, 0, 8, dib8), (16, 4, 0, 8, dib8)], cursor=True),
        "png": ico_bytes([(8, 8, 0, 32, _png(r.integers(0, 256, (8, 8, 4), dtype=np.uint8)))],
                         cursor=True),
        "cut": ico_bytes([(8, 8, 0, 8, dib8)], cursor=True)[:60],
    }


CUR = _cur_forms()


@pytest.mark.parametrize("form", list(CUR))
def test_cur(form, tmp_path):
    _check(tmp_path, "x.cur", CUR[form])


# ----- PSD ---------------------------------------------------------------------

def _psd_forms():
    r = np.random.default_rng(7)

    def planes(c, h=9, w=11):
        return r.integers(0, 256, (c, h, w), dtype=np.uint8)
    rgb = planes(3)
    odd = bytearray(psd_bytes(planes(1, 5, 6), mode=1))
    rows = [bytes([0x80, 0xFB, 7, 0x80]), bytes([0x07]) + bytes(range(8)),
            bytes([0xFE, 1, 0xFE, 2]), bytes([0x05]) + bytes(range(6)),
            bytes([0x02, 9, 9, 9, 0xFD, 4])]
    odd = bytes(odd[:-32]) + struct.pack(">H5H", 1, *map(len, rows)) + b"".join(rows)
    return {
        "grey": psd_bytes(planes(1), mode=1), "grey-rle": psd_bytes(planes(1), mode=1, rle=True),
        "rgb": psd_bytes(rgb), "rgb-rle": psd_bytes(rgb, rle=True),
        "rgba": psd_bytes(planes(4)), "rgba-rle": psd_bytes(planes(4), rle=True),
        "rgb-5-channels-rle": psd_bytes(planes(5), rle=True),
        "cmyk": psd_bytes(planes(4), mode=4), "cmyk-rle": psd_bytes(planes(4), mode=4, rle=True),
        "lab": psd_bytes(rgb, mode=9), "multichannel": psd_bytes(planes(2), mode=7),
        "duotone": psd_bytes(planes(1), mode=8), "bitmap-8": psd_bytes(planes(1), mode=0),
        "bitmap": psd_bytes(planes(1, 9, 2), mode=0, bits=1),
        "bitmap-rle": psd_bytes(planes(1, 9, 2), mode=0, bits=1, rle=True),
        "indexed": psd_bytes(planes(1), mode=2, palette=r.integers(0, 256, (256, 3))),
        "resources": psd_bytes(rgb, resources=[(1005, bytes(16)), (1039, b"abc")]),
        "one-layer": psd_bytes(rgb, layers=[(0, 0, rgb[:, :4, :5])]),
        "rle-odd-packets": odd,
        "16-bit": psd_bytes(planes(1), mode=1, bits=16),
        "mode-5": psd_bytes(planes(1), mode=5),
        "too-few-channels": psd_bytes(planes(1), channels=1, mode=3),
        "zip": psd_bytes(planes(1), mode=1)[:-(9 * 11) - 2] + b"\0\2" + bytes(9 * 11),
        "cut": psd_bytes(rgb)[:-50], "cut-rle": psd_bytes(rgb, rle=True)[:-30],
        "cut-table": psd_bytes(rgb, rle=True)[:160],
    }


PSD = _psd_forms()


@pytest.mark.parametrize("form", list(PSD))
def test_psd(form, tmp_path):
    _check(tmp_path, "x.psd", PSD[form])


@pytest.mark.parametrize("layers", [2, 3])
def test_psd_of_several_layers(layers, tmp_path):
    """PIL numbers PSD layers from 1: ``_load_array``'s seek(0) raises, and
    ``imread`` raises naming that reason; ``imread_gray`` reads the
    composite, as ``np.asarray(Image.open(...))`` does."""
    rgb = np.random.default_rng(layers).integers(0, 256, (3, 9, 11), dtype=np.uint8)
    data = psd_bytes(rgb, layers=[(k, k, rgb[:, :4, :5]) for k in range(layers)])
    path = str(tmp_path / "l.psd")
    open(path, "wb").write(data)
    with pytest.raises(EOFError, match="outside sequence"):
        jax_load(path)
    with pytest.raises(ValueError, match="PIL numbers PSD layers from 1"):
        imread(path)
    got, want = imread_gray(path), jax_gray(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgb[0])


def test_psd_layer_records_over_four_channels_do_not_count(tmp_path):
    """A layer record of more than 4 channels is skipped by PIL's count:
    two records of which one has 5 channels are one layer, read."""
    rgb = np.random.default_rng(9).integers(0, 256, (3, 9, 11), dtype=np.uint8)
    data = bytearray(psd_bytes(rgb, layers=[(0, 0, rgb[:, :2, :2]), (1, 1, rgb[:, :2, :2])]))
    at = data.index(b"\0\0\0\0\0\0\0\0\0\0\0\2\0\0\0\2\0\3", 0)  # the first record's box
    struct.pack_into(">H", data, at + 16, 5)
    _check(tmp_path, "five.psd", bytes(data))


# ----- ICNS --------------------------------------------------------------------

def _rle(rgb):
    return b"".join(icns_rle(rgb[..., k]) for k in range(3))


def _jp2(array):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "JPEG2000", irreversible=False)
    return buf.getvalue()


def _icns_forms():
    r = np.random.default_rng(8)

    def img(side, c=3):
        return r.integers(0, 256, (side, side, c), dtype=np.uint8)

    def mask(side):
        return r.integers(0, 256, (side, side), dtype=np.uint8).tobytes()
    smooth = np.repeat(np.repeat(img(16), 8, 0), 8, 1)  # runs of 8
    return {
        "it32-mask": icns_bytes([(b"it32", _rle(smooth)), (b"t8mk", mask(128))]),
        "is32-mask": icns_bytes([(b"is32", _rle(img(16))), (b"s8mk", mask(16))]),
        "il32-ih32-mask": icns_bytes([(b"il32", _rle(img(32))), (b"l8mk", mask(32)),
                                      (b"ih32", _rle(img(48))), (b"h8mk", mask(48))]),
        "is32-raw": icns_bytes([(b"is32", img(16).tobytes())]),
        "is32-raw-mask": icns_bytes([(b"is32", img(16).tobytes()), (b"s8mk", mask(16))]),
        "ic07-png-rgba": icns_bytes([(b"ic07", _png(img(128, 4)))]),
        "ic07-png-rgb": icns_bytes([(b"ic07", _png(img(128)))]),
        "ic07-png-grey": icns_bytes([(b"ic07", png_bytes(img(128)[..., 0]))]),
        "ic07-over-it32": icns_bytes([(b"it32", _rle(smooth)), (b"t8mk", mask(128)),
                                      (b"ic07", _png(img(128, 4)))]),
        "ic12-under-ih32": icns_bytes([(b"ic12", _png(img(64, 4))), (b"ih32", _rle(img(48))),
                                       (b"h8mk", mask(48))]),
        "ic11": icns_bytes([(b"ic11", _png(img(32, 4)))]),
        "ic08-jp2-rgba": icns_bytes([(b"ic08", _jp2(img(256, 4)))]),
        "ic08-jp2-rgb": icns_bytes([(b"ic08", _jp2(img(256)))]),
        "png-of-another-size": icns_bytes([(b"ic07", _png(img(100, 4)))]),
        "mask-alone": icns_bytes([(b"s8mk", mask(16))]),
        "runs-overshoot": icns_bytes([(b"is32", bytes([0xFF, 1]) * 9), (b"s8mk", mask(16))]),
        "runs-cut": icns_bytes([(b"is32", _rle(img(16))[:-20]), (b"s8mk", mask(16))])[:-256],
        "it32-no-zeros": icns_bytes([(b"it32", _rle(smooth)), (b"t8mk", mask(128))])
        .replace(b"it32\0\0", b"it32\0\1", 1).replace(b"\0\0\0\0", b"\0\0\0\1", 1),
        "bad-block": b"icns" + struct.pack(">I", 24) + b"is32" + struct.pack(">I", 0),
        "no-icon": icns_bytes([(b"info", b"abc")]),
    }


ICNS = _icns_forms()


@pytest.mark.parametrize("form", list(ICNS))
def test_icns(form, tmp_path):
    _check(tmp_path, "x.icns", ICNS[form])


def test_icns_runs_without_mask_are_refused(tmp_path):
    """PIL builds the RGB of runs in ``Image.new("RGB", size, None)`` and
    ``np.asarray`` sees its fourth bytes, which it never set: the port
    refuses the file, naming why."""
    rgb = np.random.default_rng(1).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    _check(tmp_path, "r.icns", icns_bytes([(b"is32", _rle(rgb))]),
           refused="Image.new never set")


def test_pil_written_icns(tmp_path):
    """PIL writes every size up to 1024 x 1024 (ic10, a PNG member), and
    reads that one (blocks of colour: a PNG the port unfilters quickly)."""
    rgba = np.zeros((64, 64, 4), np.uint8)
    rgba[:32], rgba[32:, :20] = (200, 10, 30, 255), (1, 2, 3, 128)
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "ICNS")
    assert _check(tmp_path, "p.icns", buf.getvalue()).shape == (1024, 1024, 4)


# ----- IM L*n ------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 3, 5, 7, 12, 24, 31])
def test_im_bits(bits, tmp_path):
    """PIL's bit decoder: least significant bit first, rows padded, its
    buffer not cleared at a row's end (widths 1, 7 and 13 pad each row
    differently); two frames raise in ``imread`` (PIL reads frame 1 raw,
    in a raw mode it has not) and read frame 0 in ``imread_gray``; a cut
    file raises."""
    rng = np.random.default_rng(bits)
    for w, h in ((1, 3), (7, 5), (13, 4)):
        v = rng.integers(0, 1 << bits, (h, w), dtype=np.uint64)
        _check(tmp_path, f"b{w}.im", im_bytes(im_bits(v, bits), f"L*{bits}", size=(w, h)))
    _check(tmp_path, "two.im", im_bytes([im_bits(v, bits)] * 2, f"L*{bits}", size=(w, h)))
    _check(tmp_path, "cut.im", im_bytes(im_bits(v, bits)[:-3], f"L*{bits}", size=(w, h)))


def test_im_bits_decoder_keeps_its_buffer():
    """The decoder's quirk on its own: 3-bit samples, 2 a row; each row's
    6 bits leave 2 in the buffer, which the next row's first byte is ORed
    over (the values PIL gives, worked by hand)."""
    data = bytes([0b10110101, 0b00000011])
    px, code = native.im_bit_decode(data, 3, 2, 2)
    assert code == 0
    # bottom row first: 0b101, 0b110; the buffer holds 0b10 and 0 bits
    # counted; 0b00000011 ORed at bit 0 gives 0b11: 0b011, then 0b000
    np.testing.assert_array_equal(px, [[3, 0], [5, 6]])


# ----- identification ------------------------------------------------------------

@pytest.mark.parametrize("kind,fmt", [("xpm", "XPM"), ("ico", "ICO"), ("cur", "CUR"),
                                      ("psd", "PSD"), ("icns", "ICNS")])
def test_identified_by_pils_order(kind, fmt):
    data = {"xpm": XPM["palette"](np.random.default_rng(0)), "ico": ICO["dib8"],
            "cur": CUR["dib8"], "psd": PSD["grey"], "icns": ICNS["is32-mask"]}[kind]
    assert raster.identify(data) == fmt
