"""Image reading without cv2 or PIL: the PNG, TIFF and JPEG files that
training folders, curation and the command line hold, decoded with numpy,
zlib, lzma and the port's host library (``csrc/image_codecs.cpp``: LZW and
PackBits; ``csrc/zstd_decode.cpp``: ZSTD; ``csrc/jpeg_decode.cpp``: JPEG);
and, by ``data/raster.py`` (its docstring gives each oracle's rules), BMP
and DIB, PBM/PGM/PPM, PFM, PAM, GIF, SPIDER, TGA and Sun raster (their
RLE and LZW by ``csrc/image_codecs.cpp`` too), by ``data/webp.py``
WebP: lossless, lossy, lossy with alpha and animated (its VP8L, VP8 and
ALPH by ``csrc/webp_decode.cpp``; ``imread`` PIL's RGB or RGBA, frames
stacked, ``imread_gray`` cv2's blue of frame 0), and by
``data/jpeg2000.py`` JPEG 2000: JP2 files and ``.j2k`` codestreams,
reversible and irreversible, tiled, layered, in any progression order
(the codestream by ``csrc/j2k_decode.cpp``, as OpenJPEG decodes it;
``imread`` PIL's L, I;16, LA, RGB or RGBA, ``imread_gray`` cv2's grey or
blue, PIL's where cv2 reads nothing), by ``data/plugins.py`` SGI, PCX
and DCX, QOI, IM, XBM, MSP (PIL's arrays for both readers: cv2 reads none
of them) and Radiance HDR (cv2's alone: ``imread`` raises, as PIL opens
none; the RLE and op streams by ``csrc/image_codecs.cpp``), and by
``data/icons.py`` XPM, ICO and CUR, PSD and ICNS (PIL's arrays for both:
cv2 reads none of them; ``imread`` of a PSD of several layers raises, as
the JAX package's reader does), and by ``data/textures.py`` DDS, BLP,
FTEX and GBR (PIL's arrays for both; their BC1-BC7 blocks by
``csrc/bcn_decode.cpp``).

``imread(path)`` returns the whole file as PIL's ``Image.open`` gives it,
pages stacked: a multipage TIFF (the IFD chain), an animated PNG or a
multi-picture JPEG (MPO) is (Z, H, W) or (Z, H, W, C).
``imread_gray(path)`` returns what the JAX package's ``_imread_gray``
returns (``cv2.imread(path, IMREAD_UNCHANGED)``, then
channel 0 of a colour image; PIL's array where cv2 reads nothing: an LZMA
or ZSTD TIFF, whose channel 0 is then red).  cv2 orders colour channels
BGR, so its channel 0 is blue: the last colour channel of the file's RGB.

PNG: grey at 1, 2, 4, 8 and 16 bits, grey + alpha, RGB and RGBA at 8 and
16 bits, palette at 1, 2, 4 and 8 bits; any of the five row filters;
Adam7-interlaced or not; animated PNG frames (offsets, dispose ops, blend
OVER only without alpha, where it equals SOURCE; a default image that is
not an animation frame is frame 0, as PIL gives it), of which
``imread_gray`` reads the default image alone, as cv2 does.  A damaged
file reads as each oracle reads it: ``imread`` as PIL (``_PngStream``:
the CRC of every chunk before the first IDAT checked, none after; image
data inflated in pieces of 65536 bytes only until its last row, a stream
that ends at a row's end leaving the rows after it 0; the chunks after it
each whole up to IEND or the file's end, which may come anywhere after
them), ``imread_gray`` as cv2's libpng (``_png_cv2``: nothing read where
a critical chunk fails its CRC, a chunk is cut short or IEND is missing,
or the image data, in pieces of 8192 bytes, breaks off, fails inflate's
checks or ends before the last row; an ancillary chunk failing its CRC
dropped), then as PIL where cv2 reads nothing.  A size of 0, or one over
the oracle's limit (PIL's decompression-bomb limit; libpng's 1000000 a
side and cv2's 2^30 pixels), is refused from the header, before anything
of its size is allocated.  Both scale 2- and 4-bit grey to 8 bits; PIL gives 1-bit grey as bool, palette images as indices,
16-bit colour as the high byte of each sample and 16-bit grey + alpha as
RGBA; cv2 scales 1-bit grey to 8 bits too, looks palette indices up and
keeps 16 bits.

TIFF: classic and BigTIFF, either byte order; strips or tiles (cut at the
image's edge); uncompressed, LZW (5), Deflate (8, 32946), PackBits
(32773), LZMA (34925), ZSTD (50000), JPEG (7) or CCITT (2: Modified
Huffman, 32771: the same, rows on 16-bit words, 3: Group 3 1D or 2D, 4:
Group 4, by ``csrc/ccitt_decode.cpp`` as libtiff's fax codec decodes
them); FillOrder 1 or 2 (each stored byte's
bits reversed, as libtiff reverses them); horizontal differencing
(predictor 2) and floating-point differencing (predictor 3: each row's
bytes as planes, most significant first in either byte order) with LZW,
Deflate, LZMA and ZSTD, as libtiff applies them; samples together or
planes apart (planar configuration 2: the strips or tiles of each plane in
turn); 1-, 2- and 4-bit grey (levels; PIL gives 1 bit as bool and scales
2 and 4 bits to 8, inverted for min-is-white; cv2 scales 1 bit to 0/255
and reads no 2- or 4-bit page), uint8, int8 (PIL: its bits as uint8),
uint16, int16, uint32 (PIL: its bits as int32, little-endian only), int32,
float32 or float64 samples: one a pixel (min-is-black; min-is-white, which
both readers invert at 1 to 8 bits only; a palette: PIL gives the indices,
cv2 the colormap's blue scaled to 8 bits), grey + alpha (PIL: 8-bit
min-is-black of ExtraSamples 2 alone, as (H, W, 2); cv2: the grey, its
high byte at 16 bits, of any ExtraSamples), grey of three samples (cv2's
first; PIL opens none), RGB or RGBA, CMYK (PIL gives the 4 samples, 8
bits of 16; cv2 libtiff's RGBA of 8-bit ones, b = (255 - K)(255 - Y) /
255, and nothing of 16-bit ones), 8-bit YCbCr (data units of any
subsampling libtiff reads, converted by its ``TIFFYCbCrToRGB`` tables
from the YCbCrCoefficients and ReferenceBlackWhite tags, as cv2 gives
them; PIL misreads the units, and ``imread`` gives the RGB too) or 8-bit
CIELab (PIL: the stored bytes; cv2: the blue of libtiff's
``TIFFCIELabToXYZ``/``TIFFXYZToRGB`` against the WhitePoint tag).  A JPEG
page (grey, RGB, or YCbCr converted to RGB as libtiff's JPEGCOLORMODE_RGB
does) decodes each strip or tile after the JPEGTables tag's tables, its
first component's sampling factors those of the YCbCrSubsampling tag (1 x
1 for grey and RGB), as libtiff checks them, data that ends early read on
through libtiff's fake EOI markers.  ``imread`` opens what PIL 12's
``OPEN_INFO`` opens (``_PIL_TIFF_MODES``: no float64 page, no int16 or
int32 min-is-white one, no colour of other samples than uint8 and uint16;
then it raises) and gives PIL's arrays (int16 grey as int32, its mode I;
the high byte of 16-bit colour; of a fourth sample one of ExtraSamples 0
dropped, one of 1 divided out); cv2 keeps every sample as the file holds
it, except that it premultiplies an 8-bit RGBA TIFF of unassociated alpha
(ExtraSamples 2) by its alpha (libtiff's ``(v a + 127) / 255``) and that
libtiff's grey RGBA routines read a right-edge tile of grey of several
samples with its rows stepped by the clipped pixels alone.
``imread_gray`` reads the first page alone, as cv2 does.  Where PIL 12
misreads a file (a big-endian BigTIFF, which it does not open; big-endian
compressed 16- and 32-bit signed or float samples, whose bytes it does not
swap; YCbCr data units) ``imread`` gives the values the file holds, as cv2
does; where cv2 misreads one (16-bit and float planes apart, plane 0
taken for the whole pixel; the last unit of an odd-length row of 4 x 4
YCbCr units, which libtiff's scanline size leaves unread) ``imread_gray``
gives the values the file holds.

A damaged or minimal TIFF (C17) reads as each oracle reads it.
``imread`` walks the IFDs as PIL does: a value past the file's end ends
the IFD (the tags before it kept) and the chain; an IFD met again ends
the chain; a missing Photometric tag is min-is-white, a missing
BitsPerSample 1 bit; BitsPerSample is fitted to SamplesPerPixel or the
page refused; uncompressed rows are read from each offset whatever the
byte counts say.  A compressed page goes through libtiff's directory and
strip rules for both readers: an IFD cut short, strip tags past the file's
end, a 0 byte count or a strip past the file's end read nothing; missing
byte counts are refused for a page of several strips and estimated for
one (``EstimateStripByteCounts``), as are a single strip's bad count and
an uncompressed page's first two counts that differ.  ``imread_gray``
reads as cv2's libtiff: a page without Photometric, or whose
BitsPerSample holds neither one value nor SamplesPerPixel equal ones,
reads nothing (PIL's array then); 8-bit and 1-bit pages go through
libtiff's RGBA interface, which leaves a strip it cannot decode 0 after
what it decoded (LZW, Deflate and PackBits as far as their data and any
damage allow; a short uncompressed strip wholly 0), other pages read
nothing on such a strip; an uncompressed tile short of its bytes, or of
FillOrder 2 in the RGBA interface, reads nothing.  CCITT data reads as
libtiff 4.7's fax codec: a code no table holds ends its row (its runs
cleaned up to the row's width) and decoding goes on; data that ends
fills the row being read and fails the strip, except that Group 3 data
whose EOL is cut is read again from the strip's start without EOLs, and a
Group 4 strip that ends after its first row reads without error (cv2's
later rows 0; PIL's rows it never set: ``imread`` refuses them).

JPEG (``.jpg``, and the strips and tiles of a compression-7 TIFF):
baseline, extended and progressive Huffman at 8 bits, 1 or 3 components,
any integral sampling factors, restart intervals; decoded as
libjpeg-turbo decodes it for both readers (the islow IDCT, fancy
upsampling, its YCbCr tables and colour-space rule): grey (H, W), colour
RGB for ``imread`` and blue for ``imread_gray``.  Neither reader applies
an EXIF orientation, and neither does the port.  A multi-picture JPEG
(MPO: an APP2 ``MPF`` index of more than one picture) is each picture
stacked for ``imread``, found where PIL's ``jpeg_factory`` and
``MpoImagePlugin`` find them (``_mpo_offsets``), and the first alone for
``imread_gray``, as cv2 reads it; pictures of different shapes raise, as
``np.stack`` of PIL's frames does.

Anything else raises and names the form: other formats (McIdas, PIXAR,
FITS and the other PIL plugins, named by ``data/raster.py``; the WebP forms
``data/webp.py`` names and the JPEG 2000 forms ``data/jpeg2000.py``
names: palettes, sYCC and ICC colour, code-block styles other than the
default, RGN, POC, PPM and PPT markers, HTJ2K and Part 2, precisions other
than 8 and 16 bits);
arithmetic-coded, lossless, hierarchical, 12-bit, 2- and 4-component
(CMYK, YCCK) and DNL JPEG, and progressive JPEG whose scans leave
coefficients unfinished (libjpeg smooths those); old-style JPEG TIFF
(compression 6) and old-style LZW; predictor 3 of integer samples,
predictor 2 of 1 to 4 bits; other photometric interpretations and sample
counts (RGB of one sample, CMYK with an extra sample, 16-bit YCbCr or
CIELab, transparency masks, float16 samples, 5 samples, 2- and 4-bit
palettes); an APNG frame blended OVER with alpha; a
TIFF's JPEG stream wider or taller than its strip or tile (as libtiff
refuses it, read from the stream's headers before any sample is
allocated; libtiff's one exception, a last strip of the page's width
that is too tall, reads) or smaller than it (libtiff reads that with a
warning, PIL and cv2 then differ).  A TIFF refused, or a damaged strip
where the oracle raises, raises ValueError naming the file, the page and
the reason (the strip or tile too); a damaged JPEG file names the file.
"""


from __future__ import annotations

import bisect
import lzma
import os
import re
import struct
import zlib

import numpy as np

from empanada_tpu_torch.core import native

__all__ = ["imread", "imread_gray", "png_frames", "read_png", "read_tiff", "tiff_pages"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# TIFF magic -> (byte order, BigTIFF)
_TIFF_MAGIC = {b"II*\x00": ("<", False), b"MM\x00*": (">", False),
               b"II+\x00": ("<", True), b"MM\x00+": (">", True)}
# PIL's decompression-bomb limit (Image.MAX_IMAGE_PIXELS, twice)
_PIL_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
_READS = ("the port reads PNG, TIFF (bilevel and CCITT too), JPEG and MPO, BMP, PNM, PFM, "
          "PAM, GIF, SPIDER, TGA, Sun raster, WebP, JPEG 2000, SGI, PCX, DCX, QOI, IM, XBM, "
          "MSP, Radiance HDR, XPM, ICO, CUR, PSD, ICNS, DDS, BLP, FTEX and GBR (module "
          "docstrings of data/imread.py, data/raster.py, data/webp.py, data/jpeg2000.py, "
          "data/plugins.py, data/icons.py and data/textures.py)")


def _bound(name: str, what: str, size: int, avail: int) -> None:
    """Refuse, before allocating, ``what`` of ``size`` bytes (or pixels)
    where the file can hold no more than ``avail``."""
    if size > avail:
        raise ValueError(f"{name}: {what} needs {size}, and the file can hold {avail}; "
                         f"the file is cut or its header damaged")


class _Raw:
    """One decoded image as the file holds it: ``pixels`` (H, W) or (H, W,
    C) samples (1-, 2- and 4-bit ones unpacked to their levels; 8-bit
    min-is-white inverted and YCbCr converted to RGB, as both readers do),
    ``kind`` grey, grey_alpha, rgb, rgba, cmyk, palette or lab, the sample
    ``depth`` in bits, the ``palette`` (N, 3) of a palette image, the
    ExtraSamples value of a TIFF's fourth sample (``extra``; None without
    the tag), whether cv2 decodes the file (``cv2_reads``: where it does
    not, the JAX package's ``_imread_gray`` takes PIL's array) and PIL
    opens it (``pil_opens``), and ``where`` it was read, for errors.  A
    format whose readers' arrays follow no rule here passes them as
    functions of no arguments (``pil``, ``gray``: ``data/raster.py``, a
    TIFF's PIL array and its grey of several samples)."""

    def __init__(self, pixels, kind, depth, where, palette=None, extra=None, cv2_reads=True,
                 pil_opens=True, pil=None, gray=None):
        self.pixels, self.kind, self.depth, self.where = pixels, kind, depth, where
        self.palette, self.extra = palette, extra
        self.cv2_reads, self.pil_opens = cv2_reads, pil_opens
        self.pil, self.gray = pil, gray

    def as_pil(self) -> np.ndarray:
        px = self.pixels
        if self.pil is not None and self.pil_opens:
            return self.pil()
        if not self.pil_opens:
            raise ValueError(f"{self.where}: {self.kind} of {px.dtype} samples, which PIL "
                             f"does not open; {_READS}")
        if self.kind == "grey" and self.depth < 8:
            return px.astype(bool) if self.depth == 1 else self._grey8()
        if self.kind in ("grey", "palette"):
            return px.astype(np.int32) if px.dtype == np.int16 else px  # PIL's mode I
        if px.dtype not in (np.uint8, np.uint16):
            raise ValueError(f"{self.where}: {self.kind.upper()} of {px.dtype} samples, "
                             f"which PIL does not open; {_READS}")
        if self.depth == 16:
            px = (px >> 8).astype(np.uint8)  # PIL keeps 8 bits of colour
            if self.kind == "grey_alpha":  # as RGBA
                return px[..., [0, 0, 0, 1]]
        return px

    def _grey8(self) -> np.ndarray:
        """1-, 2- or 4-bit grey levels scaled to 8 bits."""
        return (self.pixels * (255 // ((1 << self.depth) - 1))).astype(np.uint8)

    def as_cv2_gray(self) -> np.ndarray:
        px = self.pixels
        if self.gray is not None and self.cv2_reads:
            return self.gray()
        if not self.cv2_reads:  # PIL's array, channel 0: red where cv2's is blue
            pil = self.as_pil()
            return pil[..., 0] if pil.ndim == 3 else pil
        if self.kind == "palette":
            pal = self.palette
            if pal.dtype == np.uint16:  # a TIFF colormap: 16 bits, or 8 if it fits
                pal = (pal >> 8 if pal.max() > 255 else pal).astype(np.uint8)
            return pal[px, 2]
        if self.kind == "grey":
            return self._grey8() if self.depth < 8 else px
        if self.kind == "grey_alpha":
            return px[..., 0]
        if self.kind == "rgba" and self.extra == 2 and px.dtype == np.uint8:  # premultiplied
            return ((px[..., 2].astype(np.uint32) * px[..., 3] + 127) // 255).astype(np.uint8)
        if self.kind == "cmyk":  # libtiff's RGBA path: b = (255 - K) (255 - Y) / 255
            return ((255 - px[..., 3].astype(np.uint32)) * (255 - px[..., 2]) // 255).astype(
                np.uint8)
        return px[..., 2]


def _read_file(path: str, first_only: bool = False):
    """The images in the file at ``path`` as ``_Raw``: every page or frame,
    or the first (a PNG's default image) alone."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        if not first_only:
            return _png_raw(data, path)
        raw = _png_cv2(data, path)
        if raw is None:  # cv2 reads nothing: PIL's default image
            raw = _png_raw(data, path, first_only=True)[0]
            raw.cv2_reads = False
        return [raw]
    if data[:4] in _TIFF_MAGIC:
        return _tiff_raw(data, path, first_only)
    if data[:2] == b"\xff\xd8":
        return _jpeg_raw(data, path, first_only)
    from empanada_tpu_torch.data import raster

    return raster.read(data, path, first_only)


def _jpeg_raw(data: bytes, name: str, first_only: bool = False) -> list:
    """The pictures of a JPEG as ``_Raw``: its one image, or each picture
    of a multi-picture file (MPO) as PIL finds them (``_mpo_offsets``).
    ``first_only`` reads the file as the JAX package's ``_imread_gray``
    does: cv2's decoding (its libjpeg source; cv2 takes a file for JPEG by
    FF D8 FF), and PIL's where cv2 reads nothing; else as PIL's ``Image.open`` (``_pil_jpeg_open``) and its
    libjpeg source read it (``native.jpeg_decode``'s ``source``)."""
    if first_only and data[:3] == b"\xff\xd8\xff":  # cv2's JPEG signature
        try:
            return [_jpeg_picture(data, name, "cv2")]
        except native.JpegRefused:
            raise
        except ValueError:
            pass  # cv2.imread gives None: PIL's array
    _pil_jpeg_open(data, name)
    offsets = None if first_only else _mpo_offsets(data, name)
    out = []
    for k, at in enumerate(offsets or [0]):
        where = f"{name}: MPO picture {k}" if offsets else name
        if data[at:at + 3] != b"\xff\xd8\xff":
            raise ValueError(f"{where}: no JPEG at byte {at}")
        out.append(_jpeg_picture(data[at:] if at else data, where, "pil"))
    return out


def _jpeg_picture(data: bytes, where: str, source: str) -> _Raw:
    try:
        px = native.jpeg_decode(data, source=source)
    except ValueError as exc:
        raise type(exc)(f"{where}: {exc}; {_READS}") from None
    return _Raw(px[..., 0] if px.shape[2] == 1 else px, "grey" if px.shape[2] == 1 else "rgb", 8,
                where)


# the markers PIL's JpegImagePlugin knows (MARKER) and the segments its
# handlers read: SOF (which sets the size and mode), Skip, APP, COM, DQT
_PIL_SOF = {*range(0xC0, 0xC4), *range(0xC5, 0xC8), *range(0xC9, 0xCC), *range(0xCD, 0xD0), 0xDE}
_PIL_SEGMENTS = _PIL_SOF | {0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xDF, 0xFE, *range(0xE0, 0xF0)}


def _pil_jpeg_open(data: bytes, name: str) -> None:
    """Raise where PIL's ``Image.open`` of a JPEG raises before any sample
    is decoded: its ``JpegImagePlugin._open`` walk of the markers up to the
    first SOS (junk bytes skipped, FF fill and FF 00 skipped, a marker it
    does not know refused), each segment its handler reads (past the file's
    end: truncated), an SOF of other than 8 bits or 1, 3 or 4 components,
    or too short for its fields, a DQT of a table cut short, a JFIF or
    Adobe APP segment too short for its version, a Photoshop resource cut
    before its name's length, an ICC profile fragment under 14 bytes; no
    SOF, a size of 0, or more pixels than its decompression-bomb limit."""
    def refuse(why):
        raise ValueError(f"{name}: {why}, which PIL does not open; {_READS}")

    pos, mark, layers, size, icc = 3, 0xFF, 0, (0, 0), []
    while True:
        if mark is None:
            refuse("a JPEG that ends before its first scan")
        if mark != 0xFF:  # junk: PIL reads on
            mark, pos = (data[pos] if pos < len(data) else None), pos + 1
            continue
        if pos >= len(data):
            refuse("a JPEG that ends inside a marker")
        code, pos = data[pos], pos + 1
        if code == 0xFF:
            continue
        if code == 0x00:
            mark, pos = (data[pos] if pos < len(data) else None), pos + 1
            continue
        if code < 0xC0:
            refuse(f"a JPEG marker PIL does not know (0xFF{code:02X})")
        if code in _PIL_SEGMENTS:
            if pos + 2 > len(data):
                refuse("a JPEG segment whose length is cut")
            n = struct.unpack_from(">H", data, pos)[0] - 2
            pos += 2
            seg = data[pos:pos + max(n, 0)]
            if len(seg) < n:
                refuse("a JPEG segment that runs past the file's end")
            pos += max(n, 0)
            if code in _PIL_SOF:
                if len(seg) < 6:
                    refuse("a JPEG frame header too short for its fields")
                size = (struct.unpack_from(">H", seg, 3)[0], struct.unpack_from(">H", seg, 1)[0])
                if seg[0] != 8:
                    refuse(f"{seg[0]}-bit JPEG")
                if seg[5] not in (1, 3, 4):
                    refuse(f"{seg[5]}-component JPEG")
                layers = seg[5]
                if icc:
                    icc.sort()
                    if len(icc[0]) < 14:
                        refuse("a JPEG ICC profile fragment under 14 bytes")
                    icc = []
            elif code == 0xDB:
                while seg:
                    length = 1 + 64 * (1 if seg[0] < 16 else 2)
                    if len(seg) < length:
                        refuse("a JPEG quantisation table cut short")
                    seg = seg[length:]
            elif code in (0xE0, 0xEE) and seg.startswith(b"JFIF" if code == 0xE0 else b"Adobe"):
                if len(seg) < 7:
                    refuse("a JFIF or Adobe segment too short for its version")
            elif code == 0xE2 and seg.startswith(b"ICC_PROFILE\0"):
                icc.append(seg)
            elif code == 0xED and seg.startswith(b"Photoshop 3.0\x00"):
                _pil_photoshop(seg, refuse)
            if code == 0xDA:
                break
        mark, pos = (data[pos] if pos < len(data) else None), pos + 1
    if not layers:
        refuse("a JPEG whose first scan comes before its frame header")
    if size[1] == 0:
        refuse("a JPEG whose height a DNL marker gives (DNL is not read)")
    if size[0] == 0:
        refuse("a JPEG of width 0")
    if size[0] * size[1] > _PIL_PIXELS:
        refuse(f"a {size[0]} x {size[1]} JPEG, over its decompression-bomb limit")


def _pil_photoshop(seg: bytes, refuse) -> None:
    """PIL's walk of a JPEG's Photoshop resources: a cut field ends it
    quietly, but a resource cut before its name's length raises."""
    at = 14
    while seg[at:at + 4] == b"8BIM":
        at += 4
        if at + 2 > len(seg):
            return
        code = struct.unpack_from(">H", seg, at)[0]
        at += 2
        if at >= len(seg):
            refuse("a JPEG Photoshop resource cut before its name")
        at += 1 + seg[at]
        at += at & 1
        if at + 4 > len(seg):
            return
        n = struct.unpack_from(">I", seg, at)[0]
        at += 4
        if code == 0x03ED and len(seg[at:at + n]) < 14:  # its resolution fields cut
            return
        at += n
        at += at & 1


# the TIFF headers PIL takes (TiffImagePlugin.PREFIXES) and the types of a
# whole number (BYTE, SHORT, LONG, SBYTE, SSHORT, SLONG, LONG8, SLONG8)
# with their sizes
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                  b"II\x2b\x00")
_IFD_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
              16: 8, 17: 8, 18: 8}
_IFD_INTS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q"}


def _mpo_offsets(data: bytes, name: str):
    """The byte offsets of a multi-picture JPEG's pictures as PIL's
    ``jpeg_factory`` and ``MpoImagePlugin`` find them, or None for a plain
    JPEG: the last APP2 ``MPF\\0`` segment before the first scan holds a
    TIFF header and an IFD whose NumberOfImages (0xB001) is over 1 and whose
    MPEntry (0xB002) gives each picture's DataOffset, counted from the byte
    after ``MPF\\0`` (0 for the first: the file).  A file with an APP1
    holding ``hdrgm:Version="`` (Ultra HDR), or an index PIL cannot read
    (it warns and reads a plain JPEG), is one JPEG; an MPEntry shorter than
    its pictures raises, as PIL then opens nothing."""
    pos, mp, at, ultra = 2, None, 0, False
    while pos + 4 <= len(data):  # the segments before the first scan
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF or marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 1 if marker == 0xFF else 2
            continue
        if marker in (0xDA, 0xD9):
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE2 and body[:4] == b"MPF\0":
            mp, at = body[4:], pos + 8
        ultra |= marker == 0xE1 and b' hdrgm:Version="' in body
        pos += 2 + length
    if mp is None or mp[:4] not in _TIFF_PREFIXES or mp[2] == 0x2B or len(mp) < 8:
        return None
    ifd_end = ">" if mp[:2] == b"MM" else "<"
    entry_end = ">" if mp[:4] == b"MM\x00\x2a" else "<"
    tags = {}
    (ifd,) = struct.unpack_from(ifd_end + "I", mp, 4)
    if ifd + 2 <= len(mp):
        (count,) = struct.unpack_from(ifd_end + "H", mp, ifd)
        for i in range(count):
            e = ifd + 2 + 12 * i
            if e + 12 > len(mp):
                break  # PIL stops at a cut directory, keeping the tags read
            tag, typ, n = struct.unpack_from(ifd_end + "HHI", mp, e)
            size = n * _IFD_SIZES.get(typ, 0)
            if not size:
                continue
            value = e + 8
            if size > 4:
                (value,) = struct.unpack_from(ifd_end + "I", mp, e + 8)
                if value + size > len(mp):
                    break
            tags[tag] = (typ, mp[value:value + size])
    number, entries = tags.get(0xB001), tags.get(0xB002)
    if number is None or number[0] not in _IFD_INTS or entries is None or entries[0] != 7:
        return None
    (count,) = struct.unpack_from(ifd_end + _IFD_INTS[number[0]], number[1])
    offsets = [0]
    for k in range(count):
        if 16 * k + 16 > len(entries[1]):
            raise ValueError(f"{name}: an MPO index of {count} pictures with entries for "
                             f"{k}, which PIL does not open; {_READS}")
        attr, _, offset, _, _ = struct.unpack_from(entry_end + "IIIHH", entries[1], 16 * k)
        if (attr >> 24) & 7:  # not a JPEG picture: PIL reads the file as one
            return None
        offsets.append(offset + at)
    return None if count <= 1 or ultra else offsets[:1] + offsets[2:]


def imread_gray(path: str) -> np.ndarray:
    """The (H, W) image at ``path`` as cv2 reads it, channel 0 (module
    docstring)."""
    return np.require(_read_file(path, first_only=True)[0].as_cv2_gray(), requirements="W")


def imread(path: str) -> np.ndarray:
    """The whole image file at ``path`` as PIL's ``Image.open`` gives it:
    (H, W) or (H, W, C) for one image, and the pages (frames) stacked as
    (Z, H, W) for a multipage TIFF or an animated PNG."""
    pages = [raw.as_pil() for raw in _read_file(path)]
    if len(pages) == 1:
        return np.require(pages[0], requirements="W")  # a raw raster is a view of the file
    if len({p.shape for p in pages}) != 1:
        raise ValueError(f"{path}: its {len(pages)} pages differ in shape")
    return np.stack(pages)  # pages of other dtypes promote, as numpy stacks PIL's


# ----- PNG -------------------------------------------------------------------

# (x0, y0, dx, dy) of the seven Adam7 passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_KINDS = {0: ("grey", 1), 2: ("rgb", 3), 3: ("palette", 1), 4: ("grey_alpha", 2),
              6: ("rgba", 4)}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _unfilter_slow(kind: int, cur: bytearray, prior: bytes, bpp: int) -> None:
    """PNG filters 3 (average) and 4 (Paeth), in place: each byte depends
    on the one decoded before it."""
    n = len(cur)
    if kind == 3:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF
        return
    for i in range(n):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


# PIL's is_cid: a chunk type is four ASCII letters, digits or underscores
_PNG_CID = re.compile(rb"\w{4}")
# the bytes of image data handed to inflate at a time: PIL's
# decodermaxblock, and libpng's IDAT read size (cv2)
_PIL_PIECE, _CV2_PIECE = 65536, 8192
# libpng's default user limit of a width or height (PNG_USER_WIDTH_MAX),
# and cv2's of the pixels (CV_IO_MAX_IMAGE_PIXELS)
_LIBPNG_SIDE, _CV2_PIXELS = 1000000, 1 << 30


def _png_chunk_at(data: bytes, at: int):
    """(length, type, offset of the data) of the chunk at ``at``; None
    where fewer than 8 bytes remain or the type is not a chunk type."""
    if at + 8 > len(data):
        return None
    length, cid = struct.unpack_from(">I4s", data, at)
    return (length, cid, at + 8) if _PNG_CID.fullmatch(cid) else None


def _png_crc_ok(data: bytes, cid: bytes, pos: int, length: int) -> bool:
    """Whether the chunk's CRC is in the file and matches its type and data."""
    end = pos + length
    return end + 4 <= len(data) and struct.unpack_from(">I", data, end)[0] == zlib.crc32(
        memoryview(data)[pos:end], zlib.crc32(cid))


def _png_rows(raw: bytes, pos: int, w: int, h: int, depth: int, channels: int, name: str,
              avail: int):
    """The (h, w, channels) samples of one filtered image (or Adam7 pass)
    starting at ``raw[pos]``, of which the first ``avail`` rows were
    inflated (the others 0, as PIL leaves them), and the position after
    them."""
    bpp = max(1, channels * depth // 8)
    stride = (w * channels * depth + 7) // 8
    end = pos + avail * (stride + 1)
    rows = np.frombuffer(raw, np.uint8, avail * (stride + 1), pos).reshape(avail, stride + 1)
    filters = rows[:, 0]
    if avail == h:
        out = rows[:, 1:].copy()
    else:
        out = np.zeros((h, stride), np.uint8)
        out[:avail] = rows[:, 1:]
    prior = np.zeros(stride, np.uint8)
    for r in range(avail):
        kind = int(filters[r])
        cur = out[r]
        if kind == 1:
            cur[:] = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur += prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            _unfilter_slow(kind, buf, prior.tobytes(), bpp)
            cur[:] = np.frombuffer(buf, np.uint8)
        elif kind != 0:
            raise ValueError(f"{name}: PNG row filter {kind}")
        prior = cur
    if depth == 16:
        samples = out.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = out
    else:  # 1, 2 or 4 bits a sample, most significant first
        bits = np.unpackbits(out, axis=1).reshape(h, -1, depth)
        samples = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)[:, :w * channels]
    return samples.reshape(h, w, channels), end


class _RowSizes:
    """The bytes of each filtered row of a PNG, every pass in turn, kept as
    runs of (rows, bytes a row), so that a tall header costs nothing before
    its data is read."""

    def __init__(self, runs):
        self.runs = [(n, size) for n, size in runs if n]
        self.rows = sum(n for n, _ in self.runs)

    def __len__(self) -> int:
        return self.rows

    def __getitem__(self, r: int) -> int:
        for n, size in self.runs:
            if r < n:
                return size
            r -= n
        raise IndexError(r)

    def end(self, r: int) -> int:
        """The bytes of rows 0 to ``r``."""
        total = 0
        for n, size in self.runs:
            if r < n:
                return total + (r + 1) * size
            total, r = total + n * size, r - n
        return total


def _png_inflate(chunks: list, piece: int, runs: list, name: str) -> tuple:
    """The filtered rows (``runs`` of (rows, bytes a row), every pass in
    turn) of the zlib stream in ``chunks`` (each IDAT's data), as PIL's ZipDecode and
    libpng inflate it: each chunk handed over in pieces of ``piece``
    bytes, never an empty one, a row at a time; inflate stops at the last
    row (what the same piece holds after it is still read, so a bad
    Adler-32 there raises), and a stream that ends at a row's end, in the
    call that gave that row, ends the image.  Returns (the rows' bytes, how
    many rows, the index of the chunk that held the last)."""
    sizes = _RowSizes(runs)
    bounds, owner, at = [], [], 0  # each piece's end in the joined stream, and its chunk
    for k, chunk in enumerate(chunks):
        for e in [*range(piece, len(chunk), piece), len(chunk)] if len(chunk) else []:
            bounds.append(at + e)
            owner.append(k)
        at += len(chunk)
    stream = chunks[0] if len(chunks) == 1 else b"".join(chunks)
    # the rows before the last few in one call, where the input read for
    # them ends inside a piece (so that the piece the oracle was reading
    # is known); the rest row by row, piece by piece, as the oracle
    d, head, r, p, i = zlib.decompressobj(), b"", 0, 0, 0
    try:
        for k in range(len(sizes) - 1, max(0, len(sizes) - 5), -1):
            fast = zlib.decompressobj()
            want = sizes.end(k - 1)
            got = fast.decompress(stream, want)
            if len(got) < want or fast.eof:
                break
            q = len(stream) - len(fast.unconsumed_tail)
            j = bisect.bisect_right(bounds, q)
            if j < len(bounds) and (j == 0 or bounds[j - 1] < q):
                d, head, r, p, i = fast, got, k, q, j
                break
        parts, row = [head], bytearray()
        for j in range(i, len(bounds)):
            data = stream[p if j == i else bounds[j - 1]:bounds[j]]
            while data:
                row += d.decompress(data, sizes[r] - len(row))
                data = d.unconsumed_tail
                if len(row) < sizes[r]:
                    break  # the piece is used up, or the stream ended within the row
                parts.append(bytes(row))
                row, r = bytearray(), r + 1
                if r == len(sizes) or d.eof:
                    return b"".join(parts), r, owner[j]
    except zlib.error as exc:
        raise ValueError(f"{name}: damaged PNG image data ({exc})") from None
    raise ValueError(f"{name}: PNG image data that ends before its last row "
                     f"({r} of {len(sizes)} rows)")


def _png_image(chunks: list, piece: int, w: int, h: int, depth: int, channels: int,
               interlace: int, name: str, whole: bool = False) -> tuple:
    """The (h, w, channels) samples of the zlib stream in ``chunks``
    (``_png_inflate``), the rows after an early end of the stream 0 (PIL)
    or refused if ``whole`` (libpng); and the index of the chunk that held
    the last row."""
    passes = [(x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy))
              for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    runs = [(ph, (pw * channels * depth + 7) // 8 + 1) for *_, pw, ph in passes]
    raw, left, last = _png_inflate(chunks, piece, runs, name)
    rows = sum(ph for *_, ph in passes)
    if whole and left < rows:
        raise ValueError(f"{name}: PNG image data that ends after {left} of {rows} rows")
    if not interlace:
        return _png_rows(raw, 0, w, h, depth, channels, name, left)[0], last
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        out[y0::dy, x0::dx], pos = _png_rows(raw, pos, pw, ph, depth, channels, name,
                                             min(ph, left))
        left -= min(ph, left)
    return out, last


def _png_header(header, palette, name: str):
    """(w, h, depth, colour kind, channels, interlace) of an IHDR; a size
    of 0 refused, as PIL and libpng refuse it."""
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR before its image data")
    w, h, depth, color, _, _, interlace = header
    if not w or not h:
        raise ValueError(f"{name}: a PNG of {w} x {h} pixels, which PIL does not open")
    if color not in _PNG_KINDS or depth not in _PNG_DEPTHS[color] or interlace > 1 \
            or (color == 3 and palette is None):
        raise ValueError(f"{name}: PNG colour type {color}, bit depth {depth}, interlace "
                         f"{interlace} is not a PNG form; {_READS}")
    return (w, h, depth, *_PNG_KINDS[color], interlace)


def _png_cv2(data: bytes, name: str):
    """The default image as cv2 (libpng) reads it, as ``_Raw``; None where
    cv2 reads nothing: a chunk cut short or IEND missing, a critical chunk
    (IHDR, PLTE, IDAT; not IEND) failing its CRC, IHDR not first, a
    side over libpng's limit of 1000000 or pixels over cv2's 2^30, an
    unknown critical chunk, IDAT chunks apart, image data that breaks off,
    fails inflate's checks before the last row or ends early.  An
    ancillary chunk failing its CRC is dropped."""
    at, header, palette, idat, ended = 8, None, None, [], False
    while True:
        c = _png_chunk_at(data, at)
        if c is None or c[2] + c[0] + 4 > len(data):
            return None
        length, cid, pos = c
        at = pos + length + 4
        if cid == b"IEND":
            break
        if (cid == b"IHDR") != (header is None):
            return None
        critical = not cid[0] & 0x20
        if not _png_crc_ok(data, cid, pos, length):
            if critical:
                return None
            continue
        ended = ended or (bool(idat) and cid != b"IDAT")
        if cid == b"IHDR":
            header = struct.unpack_from(">IIBBBBB", data, pos)
            if length != 13 or header[4] or header[5]:  # compression, filter method
                return None
        elif cid == b"PLTE":
            palette = np.frombuffer(data, np.uint8, length - length % 3, pos).reshape(-1, 3)
        elif cid == b"IDAT":
            if ended:
                return None
            idat.append((pos, length))
        elif critical:
            return None
    if header is None or not idat or max(header[:2]) > _LIBPNG_SIDE \
            or header[0] * header[1] > _CV2_PIXELS:
        return None
    w, h, depth, kind, channels, interlace = _png_header(header, palette, name)
    view = memoryview(data)
    try:
        px, _ = _png_image([view[p:p + n] for p, n in idat], _CV2_PIECE, w, h, depth, channels,
                           interlace, name, whole=True)
    except ValueError:
        return None
    return _Raw(px if channels > 1 else px[..., 0], kind, depth, name, palette)


class _PngStream:
    """A PNG's chunks walked as PIL's ``PngImagePlugin`` walks them: the
    CRC of every chunk before the first IDAT checked, none after; a frame's
    image data the run of IDAT (or fdAT) chunks from its first, read only
    until its last row; the chunks after it read up to IEND, the file's end
    or (animated) the next frame's fcTL, each one's data in the file."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        self.header = self.palette = self.frames = self.seq = self.fctl = self.kind = None
        self.alpha = False

    def refuse(self, why: str):
        raise ValueError(f"{self.name}: a PNG {why}, which PIL does not read")

    def body(self, cid: bytes, pos: int, length: int) -> bytes:
        if pos + length > len(self.data):
            self.refuse(f"whose {cid.decode()} chunk is cut short")
        return self.data[pos:pos + length]

    def handle(self, cid: bytes, pos: int, length: int) -> None:
        """PIL's chunk handlers: what they keep, and their refusals."""
        if cid == b"fdAT":  # the sequence number: the rest is image data
            if length < 4:
                self.refuse("with an fdAT chunk of fewer than 4 bytes")
            self.sequence(struct.unpack(">I", self.body(cid, pos, 4))[0])
            self.body(cid, pos, length)
            return
        body = self.body(cid, pos, length)
        if cid == b"IHDR":
            if length < 13 or body[11]:
                self.refuse("with a short IHDR or an unknown filter method")
            self.header = struct.unpack_from(">IIBBBBB", body)
        elif cid == b"PLTE":
            self.palette = np.frombuffer(body, np.uint8, length - length % 3).reshape(-1, 3)
        elif cid == b"tRNS":
            self.alpha = True
        elif cid == b"acTL":
            if length < 8:
                self.refuse("with an acTL chunk of fewer than 8 bytes")
            n = struct.unpack_from(">I", body)[0]
            # a second acTL, or a count of 0 or over 2^31: the default image alone
            self.frames = None if self.frames is not None or not 0 < n <= 1 << 31 else n
        elif cid == b"fcTL":
            if length < 26:
                self.refuse("with an fcTL chunk of fewer than 26 bytes")
            seq, fw, fh, x0, y0, _, _, dispose, blend = struct.unpack_from(">IIIIIHHBB", body)
            self.sequence(seq, first=True)
            w, h = (self.header or (0, 0))[:2]
            if x0 + fw > w or y0 + fh > h:
                self.refuse("whose APNG frame lies outside the image")
            self.fctl = (fw, fh, x0, y0, dispose, blend)

    def sequence(self, seq: int, first: bool = False) -> None:
        if (self.seq is None and not (first and seq == 0)) or \
                (self.seq is not None and self.seq != seq - 1):
            self.refuse("with APNG frame sequence errors")
        self.seq = seq

    def open(self) -> int:
        """PIL's ``_open``: the chunks before the first IDAT, each CRC
        checked; the offset of that IDAT.  Sets ``kind``, the IHDR's
        (w, h, depth, colour kind, channels, interlace)."""
        at = 8
        while True:
            c = _png_chunk_at(self.data, at)
            if c is None:
                self.refuse("whose chunks break off before its image data")
            length, cid, pos = c
            if cid == b"IDAT":
                self.kind = _png_header(self.header, self.palette, self.name)
                w, h = self.kind[:2]
                if w * h > _PIL_PIXELS:
                    self.refuse(f"of {w} x {h} pixels, over its decompression-bomb limit")
                return at
            if cid in (b"IEND", b"fdAT"):
                self.refuse(f"with {cid.decode()} before IDAT")
            self.handle(cid, pos, length)
            if not _png_crc_ok(self.data, cid, pos, length):
                self.refuse(f"whose {cid.decode()} chunk fails its CRC")
            at = pos + length + 4

    def image(self, at: int, w: int, h: int):
        """The (h, w, channels) samples whose data starts with the chunk
        at ``at``, and the offset of the chunk after the one that held
        their last row."""
        chunks, after, view = [], [], memoryview(self.data)
        while (c := _png_chunk_at(self.data, at)) is not None and c[1] in (b"IDAT", b"fdAT"):
            length, cid, pos = c
            if cid == b"fdAT":
                if chunks:  # the first one's sequence number is checked already
                    self.handle(cid, pos, min(length, 4))
                pos, length = pos + 4, length - 4
            chunks.append(view[pos:pos + length])
            at = pos + length + 4
            after.append(at)
        if not w or not h:  # PIL: the tile cannot extend outside the image, or truncated
            self.refuse(f"whose APNG frame is {w} x {h} pixels")
        _, _, depth, _, channels, interlace = self.kind
        px, last = _png_image(chunks, _PIL_PIECE, w, h, depth, channels, interlace, self.name)
        return px, after[last]

    def after(self, at: int, animated: bool):
        """PIL's ``load_end``: the chunks from ``at`` on; the offset of the
        next frame's fcTL, or None."""
        while True:
            c = _png_chunk_at(self.data, at)
            if c is None or c[1] == b"IEND":
                return None
            length, cid, pos = c
            if cid == b"fcTL" and animated:
                return at
            self.handle(cid, pos, length)
            at = pos + length + 4

    def next_frame(self, at) -> int:
        """PIL's ``_seek`` to the frame whose fcTL is at ``at`` (None: the
        file ended): the offset of its first fdAT."""
        started = False
        while at is not None:
            c = _png_chunk_at(self.data, at)
            if c is None or c[1] == b"IEND":
                break
            length, cid, pos = c
            if cid == b"fcTL":
                if started:
                    self.refuse("with an APNG frame without data")
                started = True
            self.handle(cid, pos, length)
            if cid == b"fdAT" and started:
                return at
            at = pos + length + 4
        self.refuse(f"whose acTL counts {self.frames} frames, more than it holds")


def _png_raw(data: bytes, name: str, first_only: bool = False) -> list:
    """The images of a PNG as PIL reads them (its one image, or each
    composed APNG frame; the default image alone if ``first_only``) as
    ``_Raw``."""
    png = _PngStream(data, name)
    at = png.open()
    w, h, depth, kind, channels, _ = png.kind
    default = png.fctl is None  # the default image is not a frame of the animation
    frames = (png.frames or 1) + (default and png.frames is not None)

    def raw(pixels):
        return _Raw(pixels if channels > 1 else pixels[..., 0], kind, depth, name, png.palette)
    fw, fh, x0, y0, dispose, _ = png.fctl or (w, h, 0, 0, 0, 0)
    img, at = png.image(at, fw, fh)
    canvas = img
    if img.shape[:2] != (h, w):  # a first frame smaller than the image
        canvas = np.zeros((h, w, channels), img.dtype)
        canvas[y0:y0 + fh, x0:x0 + fw] = img
    at = png.after(at, frames > 1)
    if first_only or frames == 1:
        return [raw(canvas)]
    out = [raw(canvas.copy())]
    alpha = png.alpha or kind in ("grey_alpha", "rgba")
    # the default image disposes of nothing; a first frame's OP_PREVIOUS is
    # OP_BACKGROUND
    dispose, before = (0 if default else dispose), None
    dispose = 1 if dispose == 2 else dispose
    for _ in range(frames - 1):
        if dispose == 1:
            canvas[y0:y0 + fh, x0:x0 + fw] = 0
        elif dispose == 2:
            canvas[y0:y0 + fh, x0:x0 + fw] = before
        at = png.next_frame(at)
        fw, fh, x0, y0, dispose, blend = png.fctl
        if blend == 1 and alpha:
            raise ValueError(f"{name}: APNG frame blended OVER with alpha is not read")
        before = canvas[y0:y0 + fh, x0:x0 + fw].copy()
        canvas[y0:y0 + fh, x0:x0 + fw], at = png.image(at, fw, fh)
        out.append(raw(canvas.copy()))
        at = png.after(at, True)
    return out


def png_frames(data: bytes, name: str = "<png>") -> list:
    """The images of a PNG as PIL gives them: its one image, or each frame
    of an animated PNG composed onto the canvas as its ``fcTL`` says."""
    return [r.as_pil() for r in _png_raw(data, name)]


def read_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """The first image of a PNG, as PIL gives it."""
    return png_frames(data, name)[0]


# ----- TIFF ------------------------------------------------------------------

# tag type -> struct code (the numeric types; others are skipped); RATIONAL
# (5) is read as (numerator, denominator) pairs
_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q",
               17: "q"}
# (bits, SampleFormat) -> the samples' dtype (1, 2 and 4 bits: their levels)
_TIFF_DTYPES = {(1, 1): "u1", (2, 1): "u1", (4, 1): "u1", (8, 1): "u1", (8, 2): "i1",
                (16, 1): "u2", (16, 2): "i2", (32, 1): "u4", (32, 2): "i4", (32, 3): "f4",
                (64, 3): "f8"}
# (photometric, samples a pixel) read: min-is-white or min-is-black grey,
# grey + alpha, grey of three samples (cv2 reads the first), RGB(A), a
# palette, CMYK, YCbCr, CIELab
_TIFF_FORMS = {(0, 1), (1, 1), (0, 2), (1, 2), (1, 3), (2, 3), (2, 4), (3, 1), (5, 4), (6, 3),
               (8, 3)}
# the YCbCr subsamplings (h, v) libtiff reads
_SUBSAMPLINGS = {(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)}
_TIFF_CODECS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                7: "JPEG", 8: "Deflate", 32946: "Deflate", 32771: "CCITT RLEW",
                32773: "PackBits", 34925: "LZMA", 50000: "ZSTD"}
# the compressions libtiff applies a predictor with, and those cv2 5 cannot
# decode (its libtiff is built without them)
_PREDICTED = (5, 8, 32946, 34925, 50000)
_NOT_IN_CV2 = (34925, 50000)
_CCITT = (2, 3, 4, 32771)
# the tags of strip and tile offsets and byte counts
_STRIP_TAGS = (273, 279, 324, 325)


def _pil_tiff_modes() -> dict:
    """PIL 12's ``TiffImagePlugin.OPEN_INFO`` over the forms the port
    reads: (byte order, photometric, SampleFormat, FillOrder,
    BitsPerSample, ExtraSamples) -> PIL's mode.  PIL opens no page whose
    key is missing (``tests/test_torch_tiff_forms.py`` holds the table to
    PIL's)."""
    modes = {}
    for o in "<>":
        for fill in (1, 2):
            for bits in (1, 2, 4, 8):
                for photometric in (0, 1):
                    modes[o, photometric, (1,), fill, (bits,), ()] = "1" if bits == 1 else "L"
                modes[o, 3, (1,), fill, (bits,), ()] = "P"
            modes[o, 2, (1,), fill, (8, 8, 8), ()] = "RGB"
        modes[o, 1, (2,), 1, (8,), ()] = "L"
        modes[o, 1, (2,), 1, (16,), ()] = modes[o, 1, (2,), 1, (32,), ()] = "I"
        modes[o, 0, (3,), 1, (32,), ()] = modes[o, 1, (3,), 1, (32,), ()] = "F"
        modes[o, 1, (1,), 1, (8, 8), (2,)] = "LA"
        for extra, mode in (((), "RGBA"), ((0,), "RGB"), ((1,), "RGBA"), ((2,), "RGBA")):
            modes[o, 2, (1,), 1, (8,) * 4, extra] = modes[o, 2, (1,), 1, (16,) * 4, extra] = mode
        modes[o, 2, (1,), 1, (8,) * 4, (999,)] = "RGBA"
        modes[o, 2, (1,), 1, (16,) * 3, ()] = "RGB"
        modes[o, 5, (1,), 1, (8,) * 4, ()] = modes[o, 5, (1,), 1, (16,) * 4, ()] = "CMYK"
        modes[o, 6, (1,), 1, (8,) * 3, ()] = "RGB"
        modes[o, 8, (1,), 1, (8,) * 3, ()] = "LAB"
    # 16- and 32-bit forms PIL keys by one byte order alone
    modes["<", 0, (1,), 1, (16,), ()] = modes["<", 1, (1,), 1, (16,), ()] = "I;16"
    modes["<", 1, (1,), 2, (16,), ()] = "I;16"
    modes[">", 1, (1,), 1, (16,), ()] = "I;16B"
    modes["<", 1, (1,), 1, (32,), ()] = "I"
    return modes


_PIL_TIFF_MODES = _pil_tiff_modes()


class _Cv2ReadsNothing(Exception):
    """``cv2.imread`` gives None for the file: the JAX package's
    ``_imread_gray`` then takes PIL's array."""


class _Ifd:
    """One IFD as PIL and libtiff read it: ``tags`` (tag -> values; the
    BYTE and UNDEFINED ones as bytes), the tags whose values lie past the
    file's end (``lost``: libtiff skips them, or fails on the strip and
    tile tags; PIL stops reading the IFD at the first, keeping the tags
    before it: ``pil_tags``), each entry's libtiff type width and count
    (``sizes``, for its estimate of missing byte counts), the offset of
    the next IFD (None where the file ends first) and whether the entries
    themselves run past the file's end (``cut``: PIL keeps the tags
    before, libtiff reads nothing).  PIL's chain of IFDs ends at an IFD it
    stops reading early (``pil_cut``)."""

    def __init__(self, data: bytes, end: str, big: bool, ifd: int, name: str):
        count_code, entry, value_size = ("Q", 20, 8) if big else ("H", 12, 4)
        head = struct.calcsize(count_code)
        if ifd + head > len(data):
            raise ValueError(f"{name}: a TIFF IFD at byte {ifd}, past the file's end")
        (n,) = struct.unpack_from(end + count_code, data, ifd)
        base = ifd + head
        self.tags, self.lost, self.sizes, self.cut, self.next = {}, set(), [], False, None
        self.pil_tags, self.pil_cut = None, False
        for i in range(n):
            at = base + entry * i
            if at + entry > len(data):
                self.cut = self.pil_cut = True
                break
            tag, typ, count = struct.unpack_from(end + ("HHQ" if big else "HHI"), data, at)
            self.sizes.append((_IFD_SIZES.get(typ, 0), count))  # libtiff's TIFFDataWidth
            size = _IFD_SIZES.get(typ, 0) * count
            if not size:  # a type neither reader knows, or no values
                continue
            value = at + entry - value_size
            if size > value_size:
                (value,) = struct.unpack_from(end + ("Q" if big else "I"), data, value)
            if value + size > len(data):
                self.lost.add(tag)
                if self.pil_tags is None:
                    self.pil_tags, self.pil_cut = dict(self.tags), True
                continue
            code = _TIFF_TYPES.get(typ)
            if code is None:
                continue
            count *= 2 if typ == 5 else 1
            if typ in (1, 7):
                self.tags[tag] = bytes(data[value:value + count])
                continue
            vals = struct.unpack_from(end + code * count, data, value)
            if typ == 5:  # as libtiff keeps a RATIONAL: a float
                vals = tuple(np.float32(vals[k] / vals[k + 1]) if vals[k + 1] else np.float32(0)
                             for k in range(0, count, 2))
            self.tags[tag] = vals
        if self.pil_tags is None:
            self.pil_tags = self.tags
        at = base + entry * n
        if not self.cut and at + value_size <= len(data):
            (self.next,) = struct.unpack_from(end + ("Q" if big else "I"), data, at)

    def view(self, rule: str) -> dict:
        """The tags as PIL (``rule`` "pil") or libtiff reads them."""
        return self.pil_tags if rule == "pil" else self.tags


_POOL = None


def _pool():
    """The threads that decode a page's strips or tiles."""
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                                   thread_name_prefix="imread")
    return _POOL


def _reverse_bits(src: bytes) -> bytes:
    """Each byte's bits in reverse order (FillOrder 2)."""
    return np.packbits(np.unpackbits(np.frombuffer(src, np.uint8)), bitorder="little").tobytes()


def _inflate(src: bytes, size: int) -> tuple:
    """(up to ``size`` bytes inflated from ``src``, whether the stream
    broke off with an error): what libtiff's ZIPDecode leaves in its
    buffer, the bytes inflated before the damage."""
    try:
        return zlib.decompressobj().decompress(src, size), False
    except zlib.error:
        pass
    d, out = zlib.decompressobj(), bytearray()
    for k in range(len(src)):  # again a byte at a time, as far as the damage
        try:
            out += d.decompress(src[k:k + 1], size - len(out))
        except zlib.error:
            break
        if len(out) >= size:
            break
    return bytes(out), True


def _tiff_chunk(data: bytes, offset: int, count: int, compression: int, size: int,
                where: str, fill: int, ccitt=None) -> tuple:
    """(``size`` bytes of the strip or tile at ``offset``, decoded as libtiff
    decodes it: as far as its data and any damage allow, the rest 0; and
    why it is not whole, or None).  Its ``count`` bytes lie in the file.
    ``fill`` 2 reverses each byte's bits first (FillOrder); ``ccitt`` is
    (width, rows, T4Options, and libtiff's codec state: the page's Group 3
    mode and run arrays) of a CCITT strip or tile."""
    src = data[offset:offset + count]
    if fill == 2:
        src = _reverse_bits(src)
    why = None
    if compression == 1:  # libtiff's DumpModeDecode copies nothing from a short strip
        buf = src[:size] if len(src) >= size else b""
    elif compression in (8, 32946):
        buf, bad = _inflate(src, size)
        why = "damaged Deflate data" if bad else None
    elif compression == 34925:  # an .xz stream, never decoded past the strip's size
        try:
            buf = lzma.LZMADecompressor().decompress(src, size)
        except lzma.LZMAError as exc:
            raise ValueError(f"{where}: damaged LZMA data ({exc})") from None
    elif compression in _CCITT:
        out, got = native.ccitt_decode(src, compression, *ccitt[:3], state=ccitt[3],
                                       runs=ccitt[4])
        buf = out[:got if got >= 0 else -1 - got].tobytes()
        why = ("damaged CCITT data" if got < 0 else None if got == size else
               "CCITT Group 4 data that ends before its last row (libtiff reads it without "
               "error, and PIL's rows after it are memory it never set)")
    else:
        if compression == 5 and src[:1] == b"\0" and len(src) > 1 and src[1] & 1:
            raise ValueError(f"{where}: old-style LZW (before libtiff 4), which the port "
                             f"does not read; {_READS}")
        decode = {5: native.lzw_decode, 32773: native.packbits_decode,
                  50000: native.zstd_decode}[compression]
        out, got = decode(src, size)
        if compression == 50000 and got < 0:
            what = ("a dictionary, which the port does not read" if got == -2
                    else "a code the stream cannot hold")
            raise ValueError(f"{where}: damaged ZSTD data ({what})")
        if got < 0:  # a code the stream cannot hold, after -1 - got bytes
            buf, why = out[:-1 - got].tobytes(), f"damaged {_TIFF_CODECS[compression]} data"
        else:
            buf = out[:got].tobytes()
    if len(buf) < size:
        why = why or f"{len(buf)} bytes decoded of the {size} its rows hold"
        buf = buf + bytes(size - len(buf))
    return buf, why


def _ycbcr_to_rgb(ycc: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's ``TIFFYCbCrToRGB`` of (..., 3) uint8 Y, Cb, Cr: its
    tables from YCbCrCoefficients (529) and ReferenceBlackWhite (532) in
    float32 and 16-bit fixed point, as ``TIFFYCbCrToRGBInit`` builds them."""
    f32, one_half = np.float32, 1 << 15
    lr, lg, lb = (f32(v) for v in tags.get(529, (0.299, 0.587, 0.114)))
    ref = [f32(v) for v in tags.get(532, (0, 255, 128, 255, 128, 255))]

    def fix(v):  # FIX(CLAMP(v, 0, 2)): a float32 product, + 0.5 in double, truncated
        return int(float(f32(min(max(v, f32(0)), f32(2))) * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):  # float32, clamped to +-4096, truncated
        den = rw - rb if rw - rb != 0 else f32(1)
        v = ((c - np.int32(int(rb))).astype(f32) * f32(cr)) / f32(den)
        return np.clip(v, f32(-4096), f32(4096)).astype(np.int64)
    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)
    x = np.arange(-128, 128, dtype=np.int32)
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    y = y_tab[ycc[..., 0]]
    cb_i, cr_i = ycc[..., 1], ycc[..., 2]
    r = y + ((d1 * cr + one_half) >> 16)[cr_i]
    g = y + (((d4 * cb + one_half)[cb_i] + (d2 * cr)[cr_i]) >> 16)
    b = y + ((d3 * cb + one_half) >> 16)[cb_i]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _cielab_blue(lab: np.ndarray, tags: dict) -> np.ndarray:
    """The blue of libtiff's RGBA of (..., 3) 8-bit CIELab samples
    (``putcontig8bitCIELab8``: ``TIFFCIELab16ToXYZ`` of L * 257, a * 256
    and b * 256 against the WhitePoint tag's reference white, D50 by
    default, then ``TIFFXYZToRGB`` through its sRGB display's table), in
    float32 as libtiff computes it."""
    f32 = np.float32
    d50 = f32(96.425) + f32(100) + f32(82.468)
    wx, wy = (f32(v) for v in tags.get(318, (f32(96.425) / d50, f32(100) / d50)))
    y0 = f32(100)
    x0, z0 = wx / wy * y0, (f32(1) - wx - wy) / wy * y0
    values = np.arange(256)
    light = (values * 257).astype(f32) * f32(100) / f32(65535)
    small = light < f32(8.856)
    cby = np.where(small, f32(7.787) * ((light * y0 / f32(903.292)) / y0) + f32(16) / f32(116),
                   (light + f32(16)) / f32(116)).astype(f32)
    ys = np.where(small, light * y0 / f32(903.292), y0 * cby * cby * cby).astype(f32)

    def cube(t, ref):
        return np.where(t < f32(0.2069), ref * (t - f32(0.13793)) / f32(7.787),
                        ref * t * t * t).astype(f32)
    signed = (values.astype(np.uint8).view(np.int8).astype(np.int32) * 256).astype(f32)
    yl, cb = ys[lab[..., 0]], cby[lab[..., 0]]
    x = cube(signed[lab[..., 1]] / f32(256) / f32(500) + cb, x0)
    z = cube(cb - signed[lab[..., 2]] / f32(256) / f32(200), z0)
    yb = f32(0.0556) * x + f32(-0.2040) * yl + f32(1.0570) * z
    yb = np.minimum(np.maximum(yb, f32(1)), f32(100))
    step = (f32(100) - f32(1)) / f32(1500)
    gamma = 1.0 / float(f32(2.4))
    table = f32(255) * np.power(np.arange(1501) / 1500.0, gamma).astype(f32)
    i = np.minimum(((yb - f32(1)) / step).astype(np.int64), 1500)
    return np.minimum(np.floor(table[i].astype(np.float64) + 0.5), 255).astype(np.uint8)


def _tiff_pil(px: np.ndarray, mode: str, depth: int, extra) -> np.ndarray:
    """PIL's array of a page of samples ``px`` (1-, 2- and 4-bit levels
    and 8-bit min-is-white already inverted) in PIL's ``mode``."""
    if mode == "1":
        return px.astype(bool)
    if mode == "L" and depth < 8:
        return (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if mode == "I":  # int16 widened, uint32 as its bits
        return px.view(np.int32) if px.dtype == np.uint32 else px.astype(np.int32)
    if mode not in ("RGB", "RGBA", "CMYK"):
        return px.view(np.uint8) if px.dtype == np.int8 else px
    if depth == 16:
        px = (px >> 8).astype(np.uint8)  # PIL keeps 8 bits of colour
    if extra == 0:  # RGBX: PIL drops the fourth sample
        return px[..., :3]
    if extra == 1:  # associated alpha: PIL divides it out
        a = px[..., 3:].astype(np.uint32)
        rgb = np.minimum(255, px[..., :3] * np.uint32(255) // np.maximum(a, 1))
        return np.concatenate([np.where(a == 0, 0, rgb).astype(np.uint8), px[..., 3:]], -1)
    return px


def _libtiff_counts(ifd: _Ifd, data: bytes, offsets, counts, compression: int, chunk: int,
                    rps: int, h: int, tiled: bool, planes: int, spp: int, big: bool,
                    where: str):
    """The byte counts libtiff's ``TIFFReadDirectory`` reads for the
    strips or tiles at ``offsets``: the tag's, or its estimate
    (``EstimateStripByteCounts``) where the tag is missing from a page of
    one strip or tile a plane, where the one strip's count looks bad (0,
    past the file's end, or, uncompressed, short of the page), or where an
    uncompressed page of three or more strips or tiles gives the first two
    different counts.  ``chunk`` is the bytes an uncompressed strip or tile
    holds; None: libtiff reads no such page."""
    n, size = len(offsets), len(data)
    if counts is None:
        if n != planes:
            return None  # MissingRequired "StripByteCounts"
    elif not (not tiled and n == 1 and (
            (counts[0] == 0 and offsets[0] != 0)
            or (compression == 1 and offsets[0] <= size and counts[0] > size - offsets[0])
            or (compression == 1 and counts[0] < chunk * -(-h // rps)))) and not (
                planes == 1 and n > 2 and compression == 1 and counts[0] != counts[1]
                and counts[0] and counts[1]):
        return counts
    if compression != 1:
        if any(not width for width, _ in ifd.sizes):
            raise ValueError(f"{where}: no StripByteCounts, and a tag type libtiff does not "
                             f"know to estimate them by")
        space = (16 + 8 + 8 + 20 * len(ifd.sizes) if big else 8 + 2 + 4 + 12 * len(ifd.sizes)) \
            + sum(0 if w * c <= (8 if big else 4) else w * c for w, c in ifd.sizes)
        space = size if size < space else size - space
        out = [space // planes] * n
        last = offsets[-1]
        if last + out[-1] > size:
            out[-1] = 0 if last >= size else size - last
        return out
    if tiled:
        return [chunk] * n
    return [chunk // rps * (h // -(-h // rps))] * n


def _tiff_page(data: bytes, end: str, big: bool, ifd: _Ifd, name: str, page: int, rule: str):
    """The ``_Raw`` of page ``page`` (its IFD read), as PIL reads it
    (``rule`` "pil") or as cv2's libtiff does ("cv2", which raises
    ``_Cv2ReadsNothing`` where cv2 reads nothing)."""
    where = f"{name}: TIFF page {page}"
    tags = ifd.view(rule)

    def get(tag, default=None):  # a tag's values as numbers (BYTE ones as a tuple)
        v = tags.get(tag, default)
        return tuple(v) if isinstance(v, bytes) else v
    compression = get(259, (1,))[0]
    libtiff = rule == "cv2" or compression != 1  # PIL hands compressed pages to libtiff

    def refuse(why):
        if rule == "cv2":
            raise _Cv2ReadsNothing
        raise ValueError(why)
    if libtiff and ifd.cut:
        refuse(f"{where}: an IFD whose entries run past the file's end, which libtiff does "
               f"not read")
    if libtiff and ifd.lost & set(_STRIP_TAGS):
        refuse(f"{where}: strip or tile offsets or byte counts past the file's end")
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{where}: no ImageWidth or ImageLength tag")
    w, h = get(256)[0], get(257)[0]
    if 262 not in tags and rule == "cv2":
        raise _Cv2ReadsNothing  # cv2 reads no page without a Photometric tag
    photometric = get(262, (0,))[0]  # PIL's default: min-is-white
    spp = get(277, (1,))[0]
    bits = get(258, (1,))
    if rule == "pil":  # PIL fits the bits to the samples, or opens nothing
        bits = bits[:spp] if len(bits) > spp else bits * spp if len(bits) == 1 else bits
        if len(bits) != spp:
            raise ValueError(f"{where}: {len(get(258))} BitsPerSample values for {spp} "
                             f"samples, which PIL does not open; {_READS}")
    elif len(bits) != 1 and (len(bits) < spp or len(set(bits[:spp])) > 1):
        raise _Cv2ReadsNothing  # libtiff reads one value, or one a sample, all equal
    depth = bits[0]
    planar = get(284, (1,))[0] if spp > 1 else 1
    predictor = get(317, (1,))[0] if compression in _PREDICTED else 1
    formats = get(339, (1,))
    fmt = formats[0]
    fill = get(266, (1,))[0]
    extras = get(338, ())
    extra = extras[0] if extras and spp == 4 and photometric == 2 else None
    sub = tuple(get(530, (2, 2))) if photometric == 6 else (1, 1)
    dtype = _TIFF_DTYPES.get((depth, fmt))
    tiled = 322 in tags or 323 in tags
    if compression == 6:
        raise ValueError(f"{where}: old-style JPEG (compression 6) is not read; {_READS}")
    if not w or not h:
        raise ValueError(f"{where}: a page of {w} x {h} pixels")
    if w * h > (_CV2_PIXELS if rule == "cv2" else _PIL_PIXELS):  # before any allocation
        refuse(f"{where}: a page of {w} x {h} pixels, over PIL's decompression-bomb limit")
    bilevel = depth < 8 or compression in _CCITT
    if compression not in _TIFF_CODECS or predictor not in (1, 2, 3) or planar not in (1, 2) \
            or dtype is None or (photometric, spp) not in _TIFF_FORMS or fill not in (1, 2) \
            or extra not in (None, 0, 1, 2) or (photometric == 3 and 320 not in tags) \
            or (predictor == 3 and fmt != 3) or (predictor == 2 and depth < 8) \
            or (bilevel and (spp != 1 or photometric not in (0, 1)
                             or (compression in _CCITT and depth != 1))) \
            or (photometric in (6, 8) or compression == 7) and dtype != "u1" \
            or (photometric == 5 and dtype not in ("u1", "u2")) \
            or (spp == 2 and (fmt != 1 or depth not in (8, 16) or planar != 1)) \
            or (spp == 3 and photometric == 1 and dtype != "u1") \
            or (photometric == 0 and dtype in ("i1", "u4")) \
            or (fill == 2 and (spp != 1 or compression == 7)) \
            or (compression == 7 and (planar != 1 or photometric not in (1, 2, 6))) \
            or (photometric == 6 and (planar != 1 or sub not in _SUBSAMPLINGS
                                      or (sub != (1, 1) and predictor != 1))):
        raise ValueError(
            f"{where} with compression {compression}, predictor {predictor}, bits {bits}, "
            f"sample format {fmt}, fill order {fill}, {spp} samples, extra samples {extra}, "
            f"planar {planar}, photometric {photometric} is not read; {_READS}")
    if photometric == 3:
        kind = "palette"
    elif photometric == 8:
        kind = "lab"
    elif spp == 2:
        kind = "grey_alpha"
    elif photometric in (0, 1):
        kind = "grey"  # of one sample, or (cv2) the first of three
    else:
        kind = "cmyk" if photometric == 5 else "rgba" if spp == 4 else "rgb"
    key = (photometric, formats if len(formats) == 1 or set(formats) != {1} else (1,), fill,
           tuple(bits), tuple(extras))
    # PIL opens no page whose key it lacks; a big-endian BigTIFF it opens
    # not at all, and the port reads it as a little-endian one
    mode = _PIL_TIFF_MODES.get((end,) + key) or (
        _PIL_TIFF_MODES.get(("<",) + key) if big and end == ">" else None)
    if mode is None and rule == "pil":
        raise ValueError(f"{where}: {kind.upper()} of {np.dtype(dtype).name} samples "
                         f"(photometric {photometric}, bits {bits}, sample format {formats}, "
                         f"extra samples {extras}, fill order {fill}), which PIL does not "
                         f"open; {_READS}")
    if rule == "cv2" and (compression in _NOT_IN_CV2 or depth in (2, 4)
                          or (photometric == 5 and depth == 16)):
        raise _Cv2ReadsNothing  # forms cv2 5 does not decode
    # cv2 reads 8-bit samples (and grey + alpha) through libtiff's RGBA
    # interface, which leaves a strip or tile it cannot decode 0
    rgba = rule == "cv2" and (dtype == "u1" or spp == 2)
    if rgba and compression == 1 and tiled and fill == 2:
        raise _Cv2ReadsNothing  # libtiff refuses its byte counts there
    if rule == "pil" and compression == 1 and fill == 2 and depth == 8 and photometric == 0:
        raise ValueError(f"{where}: 8-bit min-is-white of FillOrder 2, uncompressed, which PIL "
                         f"does not open (no L;IR unpacker); {_READS}")
    itemsize = max(depth // 8, 1)
    planes = spp if planar == 2 else 1
    per_plane = spp // planes  # samples in each strip's or tile's pixel
    if tiled:
        tw, th = get(322, (0,))[0], get(323, (0,))[0]
        if not tw or not th:
            raise ValueError(f"{where}: tiles of {tw} x {th} pixels")
        offsets, counts = get(324), get(325)
        across = -(-w // tw)
        boxes = [((t // across) * th, (t % across) * tw) for t in range(-(-h // th) * across)]
        label, rps = "tile", th
    else:
        rps = min(get(278, (h,))[0], h)
        if not rps:
            raise ValueError(f"{where}: RowsPerStrip 0")
        offsets, counts = get(273), get(279)
        tw, th = w, rps
        boxes = [(s * rps, 0) for s in range(-(-h // rps))]
        label = "strip"
    if offsets is None:
        raise ValueError(f"{where}: no {label} offsets")
    row_bytes = (tw * per_plane * depth + 7) // 8
    if libtiff:
        counts = _libtiff_counts(ifd, data, offsets, counts, compression, row_bytes * th, rps,
                                 h, tiled, planes, spp, big, where)
        if counts is None:
            refuse(f"{where}: no {label} byte counts for {len(offsets)} {label}s, which libtiff "
                   f"does not read")
    elif not tiled and planar == 1 and get(278, (h,))[0] == h:
        offsets = offsets[-1:]  # PIL: one strip covers the page; it reads the last
    if len(offsets) < len(boxes) * planes or (libtiff and len(counts) < len(offsets)):
        raise ValueError(f"{where}: {len(offsets)} {label}s for {len(boxes) * planes}")
    out = np.zeros((h, w, spp), dtype)
    # cv2's first sample of the right-edge tiles of grey of several samples
    skewed = np.zeros((h, w % tw), np.uint16) if (
        rule == "cv2" and tiled and spp > 1 and kind in ("grey", "grey_alpha")
        and w % tw) else None
    tables = bytes(tags.get(347, b""))  # UNDEFINED (7) or BYTE (1)
    # libtiff's fax codec state, kept from strip to strip of the page
    fax_state = (np.zeros(1, np.int32), native.ccitt_runs(tw, compression,
                                                          get(292, (0,))[0])) \
        if compression in _CCITT else None

    def fetch(i, size, chunk):
        """Strip or tile i's ``size`` decoded bytes, or 0s where cv2 reads
        them so; refused as the rule refuses it."""
        offset = offsets[i]
        if not libtiff:  # PIL's own reader: the rows from the offset, whatever the count
            if offset + size > len(data):
                raise ValueError(f"{chunk}: the file ends inside it (PIL: truncated)")
            return _reverse_bits(data[offset:offset + size]) if fill == 2 else \
                data[offset:offset + size]
        count = counts[i]
        if not count or offset + count > len(data):  # libtiff's TIFFFillStrip reads nothing
            refuse(f"{chunk}: {count} bytes at byte {offset}, none or past the file's end")
        if compression == 32771 and tiled and rule == "pil":
            raise ValueError(f"{chunk}: CCITT RLEW tiles, which PIL's libtiff reads by no rule "
                             f"found (its rows differ from cv2's); {_READS}")
        if compression == 32771 and offset & 1:
            raise ValueError(f"{chunk}: CCITT RLEW data at an odd offset (libtiff aligns its "
                             f"rows to the address it maps the file at), which the port does "
                             f"not read; {_READS}")
        if tiled and compression == 1 and count < size:  # nor an uncompressed tile cut short
            refuse(f"{chunk}: {count} bytes of its {size}")
        ccitt = fax_state and (tw, th if tiled else min(rps, h - boxes[i % len(boxes)][0]),
                               get(292, (0,))[0], *fax_state)
        buf, why = _tiff_chunk(data, offset, count, compression, size, chunk, fill, ccitt)
        if why is not None and not rgba:
            refuse(f"{chunk}: {why}")
        return buf

    def place(i):
        """Decode strip or tile i (plane-major when the planes are apart)
        into ``out`` (zlib, lzma, the host library and numpy release the
        GIL: the pool's threads decode in parallel)."""
        plane, k = divmod(i, len(boxes))
        (y0, x0), rows = boxes[k], th if tiled else min(rps, h - boxes[k][0])
        chunk = f"{where}, {label} {i}"
        rh, rw = min(rows, h - y0), min(tw, w - x0)
        if compression == 7:
            count = counts[i]
            if not count or offsets[i] + count > len(data):
                refuse(f"{chunk}: {count} bytes at byte {offsets[i]}, none or past the file's "
                       f"end")
            src = data[offsets[i]:offsets[i] + count]
            try:
                # libtiff's JPEGPreDecode, before any sample is allocated: a
                # stream larger than its strip or tile is refused, except a
                # last strip of the page's width that is too tall; data that
                # ends early reads on through libtiff's fake EOI markers
                jh, jw, _ = native.jpeg_info(src, tables, "cv2")
                if jw > tw or (jh > rows and not (label == "strip" and jw == tw
                                                   and y0 + rows == h)):
                    raise ValueError(f"a JPEG of {jw} x {jh} exceeds its {tw} x {rows} {label}")
                block = native.jpeg_decode(src, tables, 2 if photometric == 6 else 1, sub,
                                           source="cv2")
            except ValueError as exc:
                raise ValueError(f"{chunk}: {exc}") from None
            if block.shape[0] < rh or block.shape[1] < rw or block.shape[2] != spp:
                raise ValueError(f"{chunk}: a JPEG of {block.shape} for {rows} rows of {tw}")
            out[y0:y0 + rh, x0:x0 + rw] = block[:rh, :rw]
            return
        if sub != (1, 1):  # YCbCr data units: sh x sv Y samples, then Cb and Cr
            sh, sv = sub
            uy, ux = -(-rows // sv), -(-tw // sh)
            buf = fetch(i, uy * ux * (sh * sv + 2), chunk)
            units = np.frombuffer(buf, np.uint8, uy * ux * (sh * sv + 2)).reshape(uy, ux, -1)
            luma = units[..., :sh * sv].reshape(uy, ux, sv, sh).transpose(0, 2, 1, 3)
            chroma = units[..., None, None, sh * sv:]
            block = np.concatenate([luma.reshape(uy, sv, ux, sh, 1),
                                    np.broadcast_to(chroma.transpose(0, 2, 1, 3, 4),
                                                    (uy, sv, ux, sh, 2))], -1)
            block = block.reshape(uy * sv, ux * sh, 3)
            out[y0:y0 + rh, x0:x0 + rw] = block[:rh, :rw]
            return
        size = rows * row_bytes
        buf = fetch(i, size, chunk)
        if depth < 8:  # levels, most significant bits first, each row from a byte
            raw = np.unpackbits(np.frombuffer(buf, np.uint8, size).reshape(rows, row_bytes),
                                axis=1).reshape(rows, -1, depth)[:, :tw]
            block = (raw << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
                axis=2, dtype=np.uint8)
        elif predictor == 3:
            # libtiff's fpAcc: each row summed bytewise with stride spp, its
            # bytes then planes, the most significant first whatever the
            # file's byte order: big-endian samples once put back together
            raw = np.frombuffer(buf, np.uint8, size).reshape(rows, -1, per_plane)
            raw = np.cumsum(raw, axis=1, dtype=np.uint8).reshape(rows, itemsize, -1)
            block = np.ascontiguousarray(raw.transpose(0, 2, 1)).view(">" + dtype)
        else:
            block = np.frombuffer(buf, end + dtype, rows * tw * per_plane)
        block = block.reshape(rows, tw, per_plane)
        if predictor == 2:  # differences along the row, modulo the sample width
            block = np.cumsum(block.astype(dtype).view(f"u{itemsize}"), axis=1,
                              dtype=f"u{itemsize}").view(dtype)
        cols = slice(plane, plane + 1) if planes > 1 else slice(None)
        out[y0:y0 + rh, x0:x0 + rw, cols] = block[:rh, :rw]
        if skewed is not None and rw < tw:
            # libtiff's grey RGBA routines step a clipped tile's rows by
            # its clipped pixels' bytes and then (tw - rw) bytes alone
            raw = np.frombuffer(np.ascontiguousarray(block).astype("<" + dtype).tobytes(),
                                np.uint8)
            step = rw * spp * itemsize + tw - rw
            at = (np.arange(rh)[:, None] * step + np.arange(rw)[None, :] * spp * itemsize)
            lo = np.pad(raw, (0, 2))
            skewed[y0:y0 + rh] = lo[at] | (lo[at + 1].astype(np.uint16) << 8 if itemsize == 2
                                           else 0)
    n_chunks = len(boxes) * planes
    if compression not in (1, 32773, *_CCITT) and n_chunks > 1:  # the slow codecs
        list(_pool().map(place, range(n_chunks)))
    else:
        for i in range(n_chunks):
            place(i)
    pixels = out[..., 0] if spp == 1 else out
    if photometric == 6 and compression != 7:
        pixels = _ycbcr_to_rgb(pixels, tags)
    if photometric == 0 and (depth < 8 or dtype == "u1"):  # both invert 1- to 8-bit min-is-white
        if spp == 1:
            pixels = (1 << depth) - 1 - pixels
        else:
            pixels[..., 0] = 255 - pixels[..., 0]
    gray = None
    if kind in ("grey", "grey_alpha") and spp > 1:
        # cv2: the first sample (the grey), its high byte at 16 bits,
        # inverted for min-is-white (8 bits: inverted above)
        g = pixels[..., 0] if depth == 8 else (pixels[..., 0] >> 8).astype(np.uint8)
        g = 255 - g if depth == 16 and photometric == 0 else g.copy()
        if skewed is not None:
            edge = (skewed >> (8 if depth == 16 else 0)).astype(np.uint8)
            g[:, w - w % tw:] = 255 - edge if photometric == 0 else edge
        gray = g.copy
    elif kind == "lab":
        gray = lambda: _cielab_blue(pixels, tags)  # noqa: E731
    cmap = np.asarray(get(320), np.uint16).reshape(3, -1).T if photometric == 3 else None
    return _Raw(pixels, kind, depth, where, cmap, extra=extra, cv2_reads=rule == "cv2",
                pil=lambda: _tiff_pil(pixels, mode, depth, extra), gray=gray)


def _tiff_raw(data: bytes, name: str, first_only: bool = False, cv2: bool = True) -> list:
    """Every page of a TIFF as ``_Raw``, following the chain of IFDs as PIL
    does: to an IFD offset of 0, to one it has read (a loop), or to an IFD
    cut short (the tags before its cut are the last page's); or the first
    page alone (``first_only``) as cv2 reads it (PIL's where cv2 reads
    nothing), or as PIL does (not ``cv2``)."""
    end, big = _TIFF_MAGIC[data[:4]]
    if len(data) < (16 if big else 8):
        raise ValueError(f"{name}: a TIFF header cut short")
    (ifd,) = struct.unpack_from(end + ("Q" if big else "I"), data, 8 if big else 4)
    if first_only and cv2:
        first = _Ifd(data, end, big, ifd, name)
        try:
            return [_tiff_page(data, end, big, first, name, 0, "cv2")]
        except _Cv2ReadsNothing:
            pass
    pages, seen = [], set()
    while ifd:
        seen.add(ifd)
        entry = _Ifd(data, end, big, ifd, name)
        pages.append(_tiff_page(data, end, big, entry, name, len(pages), "pil"))
        if first_only:
            pages[0].cv2_reads = False
            break
        ifd = 0 if entry.pil_cut or entry.next is None or entry.next in seen else entry.next
    if not pages:
        raise ValueError(f"{name}: a TIFF whose first IFD offset is 0")
    return pages


def tiff_pages(data: bytes, name: str = "<tiff>") -> list:
    """Every page of a TIFF as PIL gives it."""
    return [r.as_pil() for r in _tiff_raw(data, name)]


def read_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """The first page of a TIFF, as PIL gives it."""
    return _tiff_raw(data, name, first_only=True, cv2=False)[0].as_pil()
