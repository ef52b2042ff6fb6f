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
(32773), LZMA (34925), ZSTD (50000) or JPEG (7); horizontal differencing
(predictor 2) and floating-point differencing (predictor 3: each row's
bytes as planes, most significant first in either byte order) with LZW,
Deflate, LZMA and ZSTD, as libtiff applies them; samples together or
planes apart (planar configuration 2: the strips or tiles of each plane in
turn); uint8, uint16, int16, int32, float32 or float64 samples: one a
pixel (min-is-black; min-is-white, which both readers invert at 8 bits
only; a palette: PIL gives the indices, cv2 the colormap's blue scaled to
8 bits), RGB or RGBA, 8-bit CMYK (PIL gives the 4 samples, cv2 libtiff's
RGBA of them: b = (255 - K)(255 - Y) / 255) or 8-bit YCbCr (data units of
any subsampling libtiff reads, converted by its ``TIFFYCbCrToRGB`` tables
from the YCbCrCoefficients and ReferenceBlackWhite tags, as cv2 gives
them; PIL misreads the units, and ``imread`` gives the RGB too).  A JPEG
page (grey, RGB, or YCbCr converted to RGB as libtiff's JPEGCOLORMODE_RGB
does) decodes each strip or tile after the JPEGTables tag's tables, its
first component's sampling factors those of the YCbCrSubsampling tag (1 x
1 for grey and RGB), as libtiff checks them.  PIL gives int16 grey as
int32 (its mode I), keeps the high byte of 16-bit colour, opens no colour
of other samples than uint8 and uint16, no float64 page and no int16 or
int32 min-is-white one (then ``imread`` raises; cv2 reads them), and of a
fourth sample drops one of ExtraSamples 0 (RGBX) and divides one of 1
(associated alpha) out; cv2 keeps every sample as the file holds it,
except that it premultiplies an 8-bit RGBA TIFF of unassociated alpha
(ExtraSamples 2) by its alpha (libtiff's ``(v a + 127) / 255``).
``imread_gray`` reads the first page alone, as cv2 does.  Where PIL 12
misreads a file (a big-endian BigTIFF, which it does not open; big-endian
compressed 16- and 32-bit signed or float samples, whose bytes it does not
swap; YCbCr data units) ``imread`` gives the values the file holds, as cv2
does; where cv2 misreads one (16-bit and float planes apart, plane 0
taken for the whole pixel; the last unit of an odd-length row of 4 x 4
YCbCr units, which libtiff's scanline size leaves unread) ``imread_gray``
gives the values the file holds.

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
(compression 6); predictor 3 of integer samples; other photometric
interpretations and sample counts (CMYK with an extra sample or 16 bits,
16-bit YCbCr, CIELab, masks); an APNG frame blended OVER with alpha; a
TIFF's JPEG stream wider or taller than its strip or tile (as libtiff
refuses it, read from the stream's headers before any sample is
allocated; libtiff's one exception, a last strip of the page's width
that is too tall, reads) or smaller than it (libtiff reads that with a
warning, PIL and cv2 then differ).  A damaged strip raises and names the
file, the page and the strip; a damaged JPEG file names the file.
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
_READS = ("the port reads PNG, TIFF, JPEG and MPO, BMP, PNM, PFM, PAM, GIF, SPIDER, TGA, Sun "
          "raster, WebP, JPEG 2000, SGI, PCX, DCX, QOI, IM, XBM, MSP, Radiance HDR, XPM, ICO, "
          "CUR, PSD, ICNS, DDS, BLP, FTEX and GBR (module docstrings of data/imread.py, "
          "data/raster.py, data/webp.py, data/jpeg2000.py, data/plugins.py, data/icons.py "
          "and data/textures.py)")


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
    ``kind`` grey, grey_alpha, rgb, rgba, cmyk or palette, the sample
    ``depth`` in bits, the ``palette`` (N, 3) of a palette image, the
    ExtraSamples value of a TIFF's fourth sample (``extra``; None without
    the tag), whether cv2 decodes the file (``cv2_reads``: not LZMA or ZSTD
    TIFF, where the JAX package's ``_imread_gray`` takes PIL's array) and
    PIL opens it (``pil_opens``), and ``where`` it was read, for errors.
    A raster format whose readers' arrays follow no rule here passes them
    as functions of no arguments (``pil``, ``gray``: ``data/raster.py``)."""

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
        if self.extra == 0:  # RGBX: PIL drops the fourth sample
            return px[..., :3]
        if self.extra == 1:  # associated alpha: PIL divides it out
            a = px[..., 3:].astype(np.uint32)
            rgb = np.minimum(255, px[..., :3] * np.uint32(255) // np.maximum(a, 1))
            return np.concatenate([np.where(a == 0, 0, rgb).astype(np.uint8), px[..., 3:]], -1)
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
_TIFF_DTYPES = {(8, 1): "u1", (16, 1): "u2", (16, 2): "i2", (32, 2): "i4", (32, 3): "f4",
                (64, 3): "f8"}
# (photometric, samples a pixel) read: min-is-white or min-is-black grey,
# RGB(A), a palette, CMYK, YCbCr
_TIFF_FORMS = {(0, 1), (1, 1), (2, 3), (2, 4), (3, 1), (5, 4), (6, 3)}
# the YCbCr subsamplings (h, v) libtiff reads
_SUBSAMPLINGS = {(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)}
_TIFF_CODECS = {1: "none", 5: "LZW", 7: "JPEG", 8: "Deflate", 32946: "Deflate",
                32773: "PackBits", 34925: "LZMA", 50000: "ZSTD"}
# the compressions libtiff applies a predictor with, and those cv2 5 cannot
# decode (its libtiff is built without them)
_PREDICTED = (5, 8, 32946, 34925, 50000)
_NOT_IN_CV2 = (34925, 50000)


def _tiff_ifd(data: bytes, end: str, big: bool, ifd: int):
    """(tags, offset of the next IFD) of the IFD at ``ifd``."""
    count_code, entry, value_size = ("Q", 20, 8) if big else ("H", 12, 4)
    (n,) = struct.unpack_from(end + count_code, data, ifd)
    base = ifd + struct.calcsize(count_code)
    tags = {}
    for i in range(n):
        at = base + entry * i
        tag, typ, count = struct.unpack_from(end + ("HHQ" if big else "HHI"), data, at)
        code = _TIFF_TYPES.get(typ)
        if code is None:
            continue
        count *= 2 if typ == 5 else 1
        size = struct.calcsize(code) * count
        value = at + entry - value_size
        if size > value_size:
            (value,) = struct.unpack_from(end + ("Q" if big else "I"), data, value)
        if typ == 7:
            tags[tag] = bytes(data[value:value + count])
            continue
        tags[tag] = struct.unpack_from(end + code * count, data, value)
        if typ == 5:  # as libtiff keeps a RATIONAL: a float
            v = tags[tag]
            tags[tag] = tuple(np.float32(v[k] / v[k + 1]) if v[k + 1] else np.float32(0)
                              for k in range(0, count, 2))
    (next_ifd,) = struct.unpack_from(end + ("Q" if big else "I"), data, base + entry * n)
    return tags, next_ifd


_POOL = None


def _pool():
    """The threads that decode a page's strips or tiles."""
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                                   thread_name_prefix="imread")
    return _POOL


def _tiff_chunk(data: bytes, offset: int, count: int, compression: int, size: int,
                where: str) -> bytes:
    """``size`` decoded bytes of the strip or tile at ``offset``."""
    src = data[offset:offset + count]
    if compression == 1:
        got, buf = len(src), src[:size]
    elif compression in (8, 32946):
        try:
            buf = zlib.decompressobj().decompress(src, size)
        except zlib.error as exc:
            raise ValueError(f"{where}: damaged Deflate data ({exc})") from None
        got = len(buf)
    elif compression == 34925:  # an .xz stream, never decoded past the strip's size
        try:
            buf = lzma.LZMADecompressor().decompress(src, size)
        except lzma.LZMAError as exc:
            raise ValueError(f"{where}: damaged LZMA data ({exc})") from None
        got = len(buf)
    else:
        decode = {5: native.lzw_decode, 32773: native.packbits_decode,
                  50000: native.zstd_decode}[compression]
        out, got = decode(src, size)
        if got < 0:
            what = ("a dictionary, which the port does not read" if got == -2
                    else "a code the stream cannot hold")
            raise ValueError(f"{where}: damaged {_TIFF_CODECS[compression]} data ({what})")
        buf = out
    if got < size:
        raise ValueError(f"{where}: {got} bytes decoded of the {size} its rows hold")
    return buf


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


def _tiff_page(data: bytes, end: str, big: bool, ifd: int, name: str, page: int):
    """(``_Raw``, offset of the next IFD) of page ``page`` at ``ifd``."""
    tags, next_ifd = _tiff_ifd(data, end, big, ifd)
    w, h = tags[256][0], tags[257][0]
    bits = tags.get(258, (1,))
    compression = tags.get(259, (1,))[0]
    photometric = tags.get(262, (1,))[0]
    spp = tags.get(277, (1,))[0]
    planar = tags.get(284, (1,))[0] if spp > 1 else 1
    predictor = tags.get(317, (1,))[0] if compression in _PREDICTED else 1
    fmt = tags.get(339, (1,))[0]
    extra = tags.get(338, (None,))[0] if spp == 4 and photometric == 2 else None
    sub = tuple(tags.get(530, (2, 2))) if photometric == 6 else (1, 1)
    dtype = _TIFF_DTYPES.get((bits[0], fmt))
    where = f"{name}: TIFF page {page}"
    if compression == 6:
        raise ValueError(f"{where}: old-style JPEG (compression 6) is not read; {_READS}")
    byte_forms = photometric in (5, 6) or compression == 7
    if compression not in _TIFF_CODECS or predictor not in (1, 2, 3) or planar not in (1, 2) \
            or dtype is None or len(set(bits)) != 1 or (photometric, spp) not in _TIFF_FORMS \
            or extra not in (None, 0, 1, 2) or (photometric == 3 and 320 not in tags) \
            or (predictor == 3 and fmt != 3) or (byte_forms and dtype != "u1") \
            or (compression == 7 and (planar != 1 or photometric not in (1, 2, 6))) \
            or (photometric == 6 and (planar != 1 or sub not in _SUBSAMPLINGS
                                      or (sub != (1, 1) and predictor != 1))):
        raise ValueError(
            f"{where} with compression {compression}, predictor {predictor}, bits {bits}, "
            f"sample format {fmt}, {spp} samples, extra samples {extra}, planar {planar}, "
            f"photometric {photometric} is not read; {_READS}")
    itemsize = bits[0] // 8
    planes = spp if planar == 2 else 1
    per_plane = spp // planes  # samples in each strip's or tile's pixel
    if 322 in tags:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-w // tw)
        boxes = [((t // across) * th, (t % across) * tw) for t in range(-(-h // th) * across)]
        label = "tile"
    else:
        rps = min(tags.get(278, (h,))[0], h)
        offsets, counts = tags[273], tags[279]
        tw = w
        boxes = [(s * rps, 0) for s in range(-(-h // rps))]
        label = "strip"
    if len(offsets) < len(boxes) * planes or len(counts) < len(offsets):
        raise ValueError(f"{where}: {len(offsets)} {label}s for {len(boxes) * planes}")
    out = np.empty((h, w, spp), dtype)
    tables = bytes(tags.get(347, b""))  # UNDEFINED (7) or BYTE (1)

    def place(i):
        """Decode strip or tile i (plane-major when the planes are apart)
        into ``out`` (zlib, lzma, the host library and numpy release the
        GIL: the pool's threads decode in parallel)."""
        plane, k = divmod(i, len(boxes))
        (y0, x0), rows = boxes[k], th if label == "tile" else min(rps, h - boxes[k][0])
        chunk = f"{where}, {label} {i}"
        rh, rw = min(rows, h - y0), min(tw, w - x0)
        if compression == 7:
            src = data[offsets[i]:offsets[i] + counts[i]]
            try:
                # libtiff's JPEGPreDecode, before any sample is allocated: a
                # stream larger than its strip or tile is refused, except a
                # last strip of the page's width that is too tall
                jh, jw, _ = native.jpeg_info(src, tables)
                if jw > tw or (jh > rows and not (label == "strip" and jw == tw
                                                   and y0 + rows == h)):
                    raise ValueError(f"a JPEG of {jw} x {jh} exceeds its {tw} x {rows} {label}")
                block = native.jpeg_decode(src, tables, 2 if photometric == 6 else 1, sub)
            except ValueError as exc:
                raise ValueError(f"{chunk}: {exc}") from None
            if block.shape[0] < rh or block.shape[1] < rw or block.shape[2] != spp:
                raise ValueError(f"{chunk}: a JPEG of {block.shape} for {rows} rows of {tw}")
            out[y0:y0 + rh, x0:x0 + rw] = block[:rh, :rw]
            return
        if sub != (1, 1):  # YCbCr data units: sh x sv Y samples, then Cb and Cr
            sh, sv = sub
            uy, ux = -(-rows // sv), -(-tw // sh)
            buf = _tiff_chunk(data, offsets[i], counts[i], compression,
                              uy * ux * (sh * sv + 2), chunk)
            units = np.frombuffer(buf, np.uint8, uy * ux * (sh * sv + 2)).reshape(uy, ux, -1)
            luma = units[..., :sh * sv].reshape(uy, ux, sv, sh).transpose(0, 2, 1, 3)
            chroma = units[..., None, None, sh * sv:]
            block = np.concatenate([luma.reshape(uy, sv, ux, sh, 1),
                                    np.broadcast_to(chroma.transpose(0, 2, 1, 3, 4),
                                                    (uy, sv, ux, sh, 2))], -1)
            block = block.reshape(uy * sv, ux * sh, 3)
            out[y0:y0 + rh, x0:x0 + rw] = block[:rh, :rw]
            return
        size = rows * tw * per_plane * itemsize
        buf = _tiff_chunk(data, offsets[i], counts[i], compression, size, chunk)
        if predictor == 3:
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
    n_chunks = len(boxes) * planes
    if compression in (5, 7, 8, 32946, 34925, 50000) and n_chunks > 1:  # the slow codecs
        list(_pool().map(place, range(n_chunks)))
    else:
        for i in range(n_chunks):
            place(i)
    pixels = out[..., 0] if spp == 1 else out
    cv2_reads = compression not in _NOT_IN_CV2
    if photometric == 3:
        cmap = np.asarray(tags[320], np.uint16).reshape(3, -1).T
        return _Raw(pixels, "palette", bits[0], where, cmap, cv2_reads=cv2_reads), next_ifd
    if photometric == 6 and compression != 7:
        pixels = _ycbcr_to_rgb(pixels, tags)
    if photometric == 0 and dtype == "u1":  # both readers invert 8-bit min-is-white
        pixels = 255 - pixels
    kind = {1: "grey", 3: "rgb", 4: "cmyk" if photometric == 5 else "rgba"}[spp]
    # PIL opens no float64 page, and no int16 or int32 min-is-white one
    pil_opens = dtype != "f8" and not (photometric == 0 and dtype in ("i2", "i4"))
    return _Raw(pixels, kind, bits[0], where, extra=extra, cv2_reads=cv2_reads,
                pil_opens=pil_opens), next_ifd


def _tiff_raw(data: bytes, name: str, first_only: bool = False) -> list:
    """Every page of a TIFF as ``_Raw``, following the chain of IFDs."""
    end, big = _TIFF_MAGIC[data[:4]]
    (ifd,) = struct.unpack_from(end + ("Q" if big else "I"), data, 8 if big else 4)
    pages, seen = [], set()
    while ifd:
        if ifd in seen or ifd + 2 > len(data):
            raise ValueError(f"{name}: TIFF IFD chain loops or leaves the file at {ifd}")
        seen.add(ifd)
        page, ifd = _tiff_page(data, end, big, ifd, name, len(pages))
        pages.append(page)
        if first_only:
            break
    return pages


def tiff_pages(data: bytes, name: str = "<tiff>") -> list:
    """Every page of a TIFF as PIL gives it."""
    return [r.as_pil() for r in _tiff_raw(data, name)]


def read_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """The first page of a TIFF, as PIL gives it."""
    return _tiff_raw(data, name, first_only=True)[0].as_pil()
