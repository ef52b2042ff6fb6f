"""The raster formats beyond PNG, TIFF and JPEG that the JAX package reads
through PIL and cv2: BMP and DIB, PBM/PGM/PPM, PFM and PAM, GIF, SPIDER,
TGA and Sun raster, parsed with numpy; their RLE and LZW streams are
decoded by the port's host library (``csrc/image_codecs.cpp``).  Of PIL's
other plugins the port reads WebP, JPEG 2000, SGI, PCX, DCX, QOI, IM, XBM,
MSP, XPM, ICO, CUR, PSD, ICNS, DDS, BLP, FTEX and GBR (below) and refuses
the rest by name (FITS, McIdas, PIXAR, XVThumb, ...).

WebP, which PIL takes for one after TGA (RIFF, WEBP and a first chunk of
VP8, VP8L or VP8X, as its ``_accept``), is read by ``data/webp.py``,
JPEG 2000 (a JP2 file's signature box, or a codestream's SOC and SIZ
markers) by ``data/jpeg2000.py``, and SGI, PCX, DCX, QOI, IM (which has
no check of its own: PIL tries its text header after ICO), XBM and MSP,
and cv2's Radiance HDR (``#?RGBE`` or ``#?RADIANCE``), by
``data/plugins.py``, XPM, ICO and CUR, PSD and ICNS by ``data/icons.py``,
and DDS, BLP, FTEX and GBR by ``data/textures.py``.

``read(data, name, first_only)`` gives ``data/imread.py``'s ``_Raw`` of
each image, so that ``imread`` returns PIL's array (``Image.open``,
frames stacked) and ``imread_gray`` cv2's channel 0
(``cv2.imread(IMREAD_UNCHANGED)``; PIL's array where cv2 reads nothing:
TGA, SPIDER, DIB, and the forms each reader below names).  A file is
taken for what PIL takes it for: its plugins' checks in the order of
``PIL.Image.ID``; a file with no magic number is SPIDER if its header
passes PIL's SPIDER test, else TGA if it passes PIL's TGA test.

BMP/DIB (12-byte core, 40-, 52-, 56-, 64-byte, V4 and V5 headers;
bottom-up or top-down rows): 1-, 4- and 8-bit palettes (PIL gives the
indices, bool for a 1-bit black-and-white palette; cv2 the palette's
blue), 16-bit 5-5-5 and bitfields 5-6-5 (PIL scales a 5-bit sample v to
v * 255 // 31, cv2 to v << 3; cv2 refuses bitfields after a header longer
than 40 bytes), 24-bit, 32-bit BI_RGB (PIL drops the fourth byte) and
bitfields of the masks PIL reads (cv2 keeps the fourth byte; after a
header of 56 bytes or more it takes each sample through its mask, v *
255 // max), RLE8 and RLE4.  cv2 gives a core header's image as grey, by
its BGR-to-grey weights.  RLE is read as the format defines it and cv2
reads RLE8: runs within their row (a run into a full row goes on at the
next), an end of row or of bitmap, a delta; pixels skipped are index 0
(PIL's index 0, cv2's palette[0]).  PIL misreads a delta (it reads four
bytes), an RLE4 run of an odd number of pixels as they stand, an end of
row at a row's start, a full row without its end of row and an early end
of bitmap (it refuses the last two); cv2 misreads RLE4 deltas and early
ends; there both readers give the file's pixels.  A run past its row's
end is damaged (PIL cuts it, cv2 refuses it) and raises.

PNM: P1-P6, plain and raw, comments in the header, maxval 1-65535.  PIL
gives 1-bit as bool (white True), grey of maxval > 255 as int32 (its mode
I) and scales each sample but raw ones at maxval 255 (and 65535, grey) to
8 bits (16 for mode I), round(v / maxval * max); cv2 keeps raw samples as
they stand (uint16 above maxval 255), clips plain ones to maxval and
scales those of 8 bits by v * 255 // maxval.  PFM: ``Pf`` (both readers,
float32, rows bottom-up, the scale's sign the byte order; cv2 multiplies
by float32(1 / |scale|)) and ``PF`` (cv2's alone; ``imread`` raises, as
PIL opens none).  PAM (P7): cv2 alone (samples in the file's order),
``imread`` raises.

GIF: global and local colour tables, interlaced frames, transparency,
disposal.  ``imread`` gives frame 0 as PIL does (indices; outside the
frame index 0, or the transparent index), and frames stacked where PIL
gives every frame as grey (a grey colour table, or none); an animated
GIF of colour frames raises, as ``np.stack`` of PIL's frames (frame 0
indices, the rest RGB) does.  ``imread_gray`` is cv2's frame 0: the
colour table's blue (cv2's own table where the file has none), the
screen's background colour outside the frame and under its transparent
index; where cv2 refuses the file (a background index past the global
table, a frame past the screen, an index past its table) it is PIL's.

SPIDER: float32 images and stacks (every image's own header), either
byte order, as PIL reads them (both readers: cv2 reads no SPIDER);
volumes and Fourier forms raise, naming the form.

TGA: types 1, 2, 3 and RLE 9, 10, 11; 1-bit (raw) and 8-bit grey, grey
and alpha, 16-bit (5-5-5 scaled as PIL does, its alpha bit inverted),
24- and 32-bit colour, colour-mapped (PIL's indices); either origin.  cv2
reads no TGA: ``imread_gray`` is PIL's channel 0, red.

Sun raster: depths 1, 8, 24 and 32 (PIL: the first three bytes, B, G, R
or R, G, B of type 3), types 0, 1, 2 (byte-encoded) and 3, colour maps
(PIL's indices; cv2 its blue, or grey of a grey map); rows padded to 16
bits, which PIL's byte-encoded reader forgets (it misreads those of odd
byte width; both readers give the file's rows).

Every buffer is sized from the header and refused before it is allocated
when the file cannot hold it (raw samples past the file's end, or more
than the codec can expand its bytes to); damaged data raises and names
the file (and the frame).
"""

from __future__ import annotations

import struct

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import icons, jpeg2000, plugins, textures, webp
from empanada_tpu_torch.data.imread import _READS, _Raw, _bound

__all__ = ["identify", "read"]

# the most pixels a byte of each codec's data can expand to: GIF LZW (a
# frozen table's 12-bit codes, 4096 each), BMP RLE (255 pixels a 2-byte
# run), TGA RLE (128 pixels a 2-byte packet), Sun's byte encoding (256
# bytes a 3-byte run)
_EXPANSION = {"GIF": 2731, "BMP": 128, "TGA": 64, "SUN": 86}


def _u32(d: bytes, at: int = 0, end: str = "<") -> int:
    return struct.unpack_from(end + "I", d, at)[0] if len(d) >= at + 4 else -1


def _u16(d: bytes, at: int = 0, end: str = "<") -> int:
    return struct.unpack_from(end + "H", d, at)[0] if len(d) >= at + 2 else -1


def _im_accept(data: bytes) -> bool:
    """Whether PIL's IM plugin, which has no check of its own, takes the
    file by its text header (a header it raises on is taken: the reader
    raises, naming the file)."""
    try:
        return plugins.im_header(data) is not None
    except ValueError:
        return True


# PIL's plugins in the order of PIL.Image.ID (Image.init()) up to SPIDER,
# each with its check of the file's first bytes; the port reads BLP, BMP,
# DIB, CUR, PCX, DCX, DDS, FTEX, GBR, GIF, JPEG2000, ICNS, ICO, IM, MSP, PPM,
# PSD, QOI and SGI of them (PNG, JPEG and TIFF never reach here)
_BEFORE_SPIDER = (
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2")),
    ("BMP", lambda d: d[:2] == b"BM"),
    ("DIB", lambda d: _u32(d) in (12, 40, 52, 56, 64, 108, 124)),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC")),
    ("CUR", lambda d: d[:4] == b"\0\0\2\0" and _u16(d, 4) > 0),  # 0 cursors: PIL goes on
    ("PCX", lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5)),
    ("DCX", lambda d: _u32(d) == 0x3ADE68B1),
    ("DDS", lambda d: d[:4] == b"DDS "),
    ("EPS", lambda d: d[:4] == b"%!PS" or _u32(d) == 0xC6D3D0C5),
    ("FITS", lambda d: d[:6] == b"SIMPLE"),
    ("FLI", lambda d: len(d) >= 16 and _u16(d, 4) in (0xAF11, 0xAF12) and _u16(d, 14) in (0, 3)),
    ("FTEX", lambda d: d[:4] == b"FTEX"),
    ("GBR", lambda d: len(d) >= 8 and _u32(d, 0, ">") >= 20 and _u32(d, 4, ">") in (1, 2)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a")),
    ("GRIB", lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n"),
    ("JPEG2000", lambda d: d[:4] == b"\xff\x4f\xff\x51"
     or d[:12] == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
    ("ICNS", lambda d: d[:4] == b"icns"),
    ("ICO", lambda d: d[:4] == b"\0\0\1\0"),
    ("IM", _im_accept),
    ("MCIDAS", lambda d: d[:8] == b"\0\0\0\0\0\0\0\4"),
    ("MPEG", lambda d: d[:4] == b"\0\0\1\xb3"),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS")),
    ("PIXAR", lambda d: d[:4] == b"\x80\xe8\0\0"),
    ("PPM", lambda d: len(d) >= 2 and d[:1] == b"P" and d[1] in b"0123456fy"),
    ("PSD", lambda d: d[:4] == b"8BPS"),
    ("QOI", lambda d: d[:4] == b"qoif"),
    ("SGI", lambda d: _u16(d, 0, ">") == 474),
)
# after TGA
_AFTER_TGA = (
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP"
     and d[12:16] in (b"VP8 ", b"VP8L", b"VP8X")),
    ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\0\0" or d[:4] == b"\1\0\0\0"),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define")),  # PIL's 16-byte prefix
    ("XPM", lambda d: d[:9] == b"/* XPM */"),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332"),
)


def identify(data: bytes) -> str | None:
    """The format PIL's ``Image.open`` takes ``data`` for, by its plugins'
    checks in their order; a PAM or colour PFM (cv2's alone) is "PNM", a
    Radiance HDR (cv2's alone) "HDR"; None for none."""
    for name, accept in _BEFORE_SPIDER:
        if accept(data):
            return "PNM" if name == "PPM" else name
    if data[:2] in (b"P7", b"PF") and data[2:3] in (b"\n", b"\r", b" ", b"\t") \
            and data[:6] != b"P7 332":  # cv2's PAM and colour PFM
        return "PNM"
    if _spider_header(data) is not None:
        return "SPIDER"
    if _u32(data, 0, ">") == 0x59A66A95:
        return "SUN"
    if _tga_header(data) is not None:
        return "TGA"
    for name, accept in _AFTER_TGA:
        if accept(data):
            return name
    return "HDR" if plugins.is_hdr(data) else None


def read(data: bytes, name: str, first_only: bool = False) -> list:
    """The images of the file ``name`` (its bytes ``data``) as ``_Raw``:
    every frame, or the first alone."""
    fmt = identify(data)
    if fmt is None:
        raise ValueError(f"{name}: not a file of a format the port reads (starts "
                         f"{data[:8]!r}); {_READS}")
    reader = {"BMP": _bmp, "DIB": _bmp, "PNM": _pnm, "GIF": _gif, "SPIDER": _spider,
              "TGA": _tga, "SUN": _sun, "WEBP": webp.read, "JPEG2000": jpeg2000.read,
              **plugins.READERS, **icons.READERS, **textures.READERS}.get(fmt)
    if reader is None:
        raise ValueError(f"{name}: a {fmt} file, which the port does not read; {_READS}")
    if reader in (_bmp, _pnm, _tga, _sun):  # readers of one image take no first_only
        return reader(data, name)
    return reader(data, name, first_only)


def _luma(b, g, r) -> np.ndarray:
    """cv2's BGR-to-grey of uint8 samples: 14-bit fixed-point weights."""
    return ((b.astype(np.uint32) * 1868 + g.astype(np.uint32) * 9617
             + r.astype(np.uint32) * 4899 + (1 << 13)) >> 14).astype(np.uint8)


def _scale(v, bits: int) -> np.ndarray:
    """PIL's unpacking of a ``bits``-bit sample to 8 bits: v * 255 // max."""
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


# ----- BMP / DIB ---------------------------------------------------------------

# PIL's 32-bit bitfield masks (r, g, b, a) -> the bytes of the word its
# samples (RGB or RGBA) take
_PIL_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0, 3),
}
_MASK555, _MASK565 = (0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)


def _mask_sample(words: np.ndarray, mask: int) -> np.ndarray:
    """cv2's sample of a 32-bit bitfield: (word & mask) >> shift, scaled
    to 8 bits by v * 255 // (mask >> shift)."""
    shift = (mask & -mask).bit_length() - 1
    v = (words.astype(np.uint64) & np.uint64(mask)) >> np.uint64(shift)
    return (v * np.uint64(255) // np.uint64(mask >> shift)).astype(np.uint8)


def _bmp(data: bytes, name: str) -> list:
    dib = data[:2] != b"BM"
    base = 0 if dib else 14
    where = f"{name}: BMP"
    if len(data) < base + 16:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than its header")
    size = _u32(data, base)
    if size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, base + 4)
        compression, colors, top, entry = 0, 0, False, 3
    elif size in (40, 52, 56, 64, 108, 124) and len(data) >= base + size:
        w, h, _, bits, compression = struct.unpack_from("<IIHHI", data, base + 4)
        colors, entry = _u32(data, base + 32), 4
        top = h >> 24 == 0xFF  # PIL: a height of 0xFF...... is top-down
        h = 2 ** 32 - h if top else h
    else:
        raise ValueError(f"{where} header of {size} bytes is not read; {_READS}")
    if w <= 0 or h <= 0 or bits not in (1, 4, 8, 16, 24, 32) or compression not in (0, 1, 2, 3) \
            or (compression == 1 and bits != 8) or (compression == 2 and bits != 4) \
            or (compression == 3 and bits not in (16, 24, 32)):
        raise ValueError(f"{where} of {w} x {h}, {bits} bits, compression {compression} is "
                         f"not read; {_READS}")
    at = base + size
    masks = None
    if compression == 3:
        if size == 40:  # the masks after the header (three)
            masks = struct.unpack_from("<III", data, at) + (0,)
            at += 12
        else:
            masks = struct.unpack_from("<III", data, base + 40) + (
                _u32(data, base + 52) if size >= 56 else 0,)
    colors = colors or (1 << bits)
    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{where}: a palette of {colors} colours")
        raw_pal = np.frombuffer(data, np.uint8, min(colors * entry, len(data) - at), at)
        n = len(raw_pal) // entry
        palette = np.zeros((max(n, 256), 3), np.uint8)  # cv2's: black past the file's
        palette[:n] = raw_pal[:n * entry].reshape(n, entry)[:, 2::-1]
        at += colors * entry
    offset = at if dib else _u32(data, 10)
    if not dib and offset == 14 + size and bits <= 8:  # PIL: an offset at the palette
        offset += 4 * colors
    flip = (lambda a: a) if top else (lambda a: a[::-1])
    # what cv2 reads: not a DIB; palettes of at most 256 colours; a core
    # header without 16 bits; bitfields of 16 bits after a 40-byte header
    # with 5-5-5 or 5-6-5 masks, or of 32
    cv2_reads = not dib and (bits > 8 or colors <= 256) and not (size == 12 and bits == 16) \
        and not (compression == 3 and (bits == 24 or (bits == 16 and (
            size != 40 or masks[:3] not in (_MASK555, _MASK565)))))
    pil_opens = True
    if compression in (1, 2):
        src = data[offset:]
        _bound(where, f"a {w} x {h} RLE bitmap", w * h, _EXPANSION["BMP"] * len(src) + w)
        idx, got = native.bmp_rle_decode(src, w, h, compression == 2)
        if got < 0:
            raise ValueError(f"{where}: damaged RLE data (a run or move leaves its row)")
        if got < w * h:
            raise ValueError(f"{where}: the RLE data ends at pixel {got} of {w * h}")
        idx = flip(idx)
    else:
        stride = ((w * bits + 31) // 32) * 4
        _bound(where, f"a {w} x {h} bitmap of {bits} bits", stride * h, len(data) - offset)
        rows = flip(np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride))
        if bits < 8:
            idx = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
            idx = (idx << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(2, dtype=np.uint8)
            idx = idx[:, :w]
        elif bits == 8:
            idx = rows[:, :w]
    if bits <= 8:
        if colors == 2 and bits == 1 and np.array_equal(palette[:2], [[0] * 3, [255] * 3]):
            pil = lambda: idx.astype(bool)  # noqa: E731  PIL's mode 1
        elif colors == 2 and bits > 1 and np.array_equal(palette[:2], [[0] * 3, [255] * 3]):
            raise ValueError(f"{where}: a black-and-white palette of {bits}-bit indices, "
                             f"which PIL reads as 1-bit; {_READS}")
        else:
            pil = lambda: idx  # noqa: E731  PIL's P or L: the indices
        if size == 12:
            gray = lambda: _luma(palette[idx, 2], palette[idx, 1], palette[idx, 0])  # noqa
        else:
            gray = lambda: palette[idx, 2]  # noqa: E731
        return [_Raw(idx, "palette", bits, where, palette, cv2_reads=cv2_reads, pil=pil,
                     gray=gray)]
    if bits == 16:
        words = rows[:, :2 * w].view("<u2")
        if compression == 3 and masks[:3] not in (_MASK555, _MASK565):
            pil_opens = False
        g6 = compression == 3 and masks[:3] == _MASK565

        def pil():
            r = _scale(words >> 11, 5) if g6 else _scale((words >> 10) & 31, 5)
            g = _scale((words >> 5) & 63, 6) if g6 else _scale((words >> 5) & 31, 5)
            return np.stack([r, g, _scale(words & 31, 5)], -1)

        def gray():
            return ((words & 31) << 3).astype(np.uint8)
        return [_Raw(words, "rgb", 16, where, cv2_reads=cv2_reads, pil_opens=pil_opens,
                     pil=pil, gray=gray)]
    px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
    if bits == 24:
        if compression == 3 and masks[:3] != (0xFF0000, 0xFF00, 0xFF):
            pil_opens = False

        def pil():
            return px[..., ::-1]
    else:
        order = (2, 1, 0) if compression == 0 else _PIL_MASKS32.get(masks)
        pil_opens = order is not None

        def pil():
            return px[..., order]
    if size == 12:
        gray = lambda: _luma(px[..., 0], px[..., 1], px[..., 2])  # noqa: E731
    elif bits == 32 and compression == 3 and size >= 56 and all(masks[:3]):
        gray = lambda: _mask_sample(px.view("<u4")[..., 0], masks[2])  # noqa: E731
    else:
        gray = lambda: px[..., 0]  # noqa: E731
    return [_Raw(px, "rgb", 8, where, cv2_reads=cv2_reads, pil_opens=pil_opens, pil=pil,
                 gray=gray)]


# ----- PNM, PFM, PAM -----------------------------------------------------------

_WHITE = b" \t\n\x0b\x0c\r"


def _pnm_tokens(data: bytes, pos: int, n: int) -> tuple:
    """PIL's ``PpmImageFile._read_token`` n times from ``pos``: whitespace
    skipped, a comment from ``#`` to the end of its line dropped (within a
    token too), at most 10 characters; (tokens, the position after the
    whitespace that ends the last)."""
    out = []
    for _ in range(n):
        token = bytearray()
        while len(token) <= 10:
            if pos >= len(data):
                break
            c = data[pos]
            pos += 1
            if c in _WHITE:
                if not token:
                    continue
                break
            if c == 0x23:  # '#'
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            token.append(c)
        if not token or len(token) > 10:
            raise ValueError("a PNM header token is missing or too long")
        out.append(bytes(token))
    return out, pos


def _plain_samples(data: bytes, pos: int, count: int, where: str) -> np.ndarray:
    """The first ``count`` whitespace-separated samples after ``pos``,
    comments dropped."""
    tokens = _plain_text(data, pos).split()
    if len(tokens) < count:
        raise ValueError(f"{where}: {len(tokens)} plain samples of the {count} its size holds")
    if any(len(t) > 10 for t in tokens[:count]):
        raise ValueError(f"{where}: a plain sample longer than 10 characters")
    return np.array(tokens[:count], np.int64)


def _pnm(data: bytes, name: str) -> list:
    magic = data[:2]
    where = f"{name}: PNM {magic.decode('latin-1')}"
    if magic == b"P7":
        return _pam(data, name)
    end = 2
    while end < min(len(data), 6) and data[end] not in _WHITE:
        end += 1
    if data[:end] not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"PF"):
        raise ValueError(f"{name}: a PNM of magic {data[:end]!r}, which the port does not "
                         f"read; {_READS}")
    plain, bits = magic in (b"P1", b"P2", b"P3"), magic in (b"P1", b"P4")
    try:
        tokens, pos = _pnm_tokens(data, end + 1, 2 if bits else 3)
        w, h = int(tokens[0]), int(tokens[1])
    except ValueError as exc:
        raise ValueError(f"{where}: {exc}") from None
    if w <= 0 or h <= 0:
        raise ValueError(f"{where} of {w} x {h}")
    if magic in (b"Pf", b"PF"):
        scale = float(tokens[2])
        if scale == 0 or not np.isfinite(scale):
            raise ValueError(f"{where}: a scale of {tokens[2]!r}")
        c = 3 if magic == b"PF" else 1
        _bound(where, f"{w} x {h} float32 samples", w * h * c * 4, len(data) - pos)
        px = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h * c, pos)
        px = px.reshape(h, w, c)[::-1].astype(np.float32)
        inv = np.float32(1 / abs(scale))  # cv2 multiplies by it; PIL keeps the samples
        return [_Raw(px[..., 0] if c == 1 else px, "grey" if c == 1 else "rgb", 32, where,
                     pil_opens=c == 1, pil=lambda: px[..., 0], gray=lambda: px[..., c - 1] * inv)]
    maxval = 1 if bits else int(tokens[2])
    if not 0 < maxval < 65536:
        raise ValueError(f"{where}: maxval {maxval}")
    c = 3 if magic in (b"P3", b"P6") else 1
    if bits:  # 1 black, 0 white
        if plain:
            text = b"".join(_plain_text(data, pos).split())
            _bound(where, f"{w} x {h} plain bits", w * h, len(text))
            raw = np.frombuffer(text, np.uint8, w * h).reshape(h, w)
            if not np.isin(raw, (48, 49)).all():
                raise ValueError(f"{where}: a plain bit other than 0 or 1")
            black = raw == 49
        else:
            stride = (w + 7) // 8
            _bound(where, f"{w} x {h} bits", stride * h, len(data) - pos)
            rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
            black = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
        return [_Raw(black, "grey", 1, where, pil=lambda: ~black,
                     gray=lambda: np.where(black, 0, 255).astype(np.uint8))]
    wide = maxval > 255
    if plain:
        v = _plain_samples(data, pos, w * h * c, where).reshape(h, w, c)
    else:
        _bound(where, f"{w} x {h} x {c} samples", w * h * c * (2 if wide else 1),
               len(data) - pos)
        v = np.frombuffer(data, ">u2" if wide else np.uint8, w * h * c, pos).reshape(h, w, c)
    out_max = 65535 if wide and c == 1 else 255

    def pil():
        if plain and (v > maxval).any():
            raise ValueError(f"{where}: a sample above maxval {maxval}, which PIL refuses")
        if (maxval == 255 and not plain) or (maxval == 65535 and c == 1 and not plain):
            p = v
        else:  # PIL's round(v / maxval * out_max), clipped to out_max
            p = np.minimum(np.rint(v / maxval * out_max), out_max)
        p = p.astype(np.int32 if wide and c == 1 else np.uint8)
        return p[..., 0] if c == 1 else p

    def gray():
        g = v[..., 2 if c == 3 else 0]  # cv2's BGR: blue is the third sample
        if plain:
            g = np.minimum(g, maxval)
            if not wide:
                g = g * 255 // maxval
        return g.astype(np.uint16 if wide else np.uint8)
    return [_Raw(v, "grey" if c == 1 else "rgb", 16 if wide else 8, where, pil=pil,
                 gray=gray)]


def _plain_text(data: bytes, pos: int) -> bytes:
    """The bytes after ``pos`` with each comment (``#`` to the end of its
    line) dropped."""
    out = bytearray()
    for line in data[pos:].splitlines(keepends=True):
        cut = line.find(b"#")
        out += line if cut < 0 else line[:cut] + b"\n"
    return bytes(out)


_PAM_TYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
              b"RGB_ALPHA": 4}


def _pam(data: bytes, name: str) -> list:
    """A PAM, which cv2 reads and PIL does not open: samples as they stand,
    in the file's order (cv2 misreads maxval 1 as packed bits, and the
    port gives the samples)."""
    where = f"{name}: PAM"
    end = data.find(b"ENDHDR")
    if end < 0:
        raise ValueError(f"{where}: no ENDHDR")
    fields = {}
    for line in data[2:end].splitlines():
        line = line.split(b"#")[0].split()
        if len(line) >= 2:
            fields[line[0]] = line[1]
    pos = data.index(b"\n", end) + 1
    try:
        w, h, c, maxval = (int(fields[k]) for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    except (KeyError, ValueError):
        raise ValueError(f"{where}: a header without WIDTH, HEIGHT, DEPTH or MAXVAL") from None
    kind = fields.get(b"TUPLTYPE")
    if kind is None and maxval < 256:  # cv2 takes grey or RGB by the depth alone
        kind = {1: b"GRAYSCALE", 3: b"RGB"}.get(c)
    if w <= 0 or h <= 0 or not 0 < maxval < 65536 or _PAM_TYPES.get(kind) != c \
            or (maxval == 1 and c in (2, 4)):
        raise ValueError(f"{where} of {w} x {h}, depth {c}, maxval {maxval}, tuple type "
                         f"{kind!r} is not read (cv2 refuses it); {_READS}")
    wide = maxval > 255
    _bound(where, f"{w} x {h} x {c} samples", w * h * c * (2 if wide else 1), len(data) - pos)
    v = np.frombuffer(data, ">u2" if wide else np.uint8, w * h * c, pos).reshape(h, w, c)
    v = v.astype(np.uint16 if wide else np.uint8)  # cv2 keeps the file's order
    return [_Raw(v, "rgb", 16 if wide else 8, where, pil_opens=False,
                 gray=lambda: v[..., 0])]


# ----- GIF ---------------------------------------------------------------------

_GIF_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def _gif_needed(table) -> bool:
    """PIL's ``_is_palette_needed``: the table is not grey i -> (i, i, i)."""
    return table is not None and not np.array_equal(
        table, np.repeat(np.arange(len(table), dtype=np.uint8)[:, None], 3, 1))


def _gif_frames(data: bytes, name: str, first_only: bool) -> tuple:
    """(screen, background, global table, frames): each frame's extent,
    interlace, local table, transparency, disposal and LZW stream."""
    where = f"{name}: GIF"
    if len(data) < 13:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than its header")
    sw, sh, flags, bg = struct.unpack_from("<HHBB", data, 6)
    pos, table = 13, None
    if flags & 0x80:
        n = 2 << (flags & 7)
        _bound(where, "a colour table", 3 * n, len(data) - pos)
        table = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        pos += 3 * n

    def blocks(pos):
        """The joined sub-blocks from ``pos``, and the position after."""
        parts = []
        while pos < len(data) and data[pos]:
            parts.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return b"".join(parts), pos + 1
    frames, gce = [], None
    while pos < len(data) and data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:  # an extension: only the graphic control one is read
            label = data[pos + 1] if pos + 1 < len(data) else 0
            body, pos = blocks(pos + 2)
            if label == 0xF9 and len(body) >= 4:
                gce = (body[3] if body[0] & 1 else None, (body[0] >> 2) & 7)
        elif kind == 0x2C:  # an image
            if pos + 10 > len(data):
                raise ValueError(f"{where} frame {len(frames)}: cut in its descriptor")
            x, y, w, h, f = struct.unpack_from("<HHHHB", data, pos + 1)
            pos += 10
            local = None
            if f & 0x80:
                n = 2 << (f & 7)
                _bound(f"{where} frame {len(frames)}", "a colour table", 3 * n,
                       len(data) - pos)
                local = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
                pos += 3 * n
            if pos >= len(data):
                raise ValueError(f"{where} frame {len(frames)}: cut before its data")
            min_size = data[pos]
            stream, pos = blocks(pos + 1)
            frames.append(dict(box=(x, y, w, h), interlace=bool(f & 0x40), local=local,
                               transparency=gce[0] if gce else None,
                               disposal=gce[1] if gce else 0, min_size=min_size,
                               stream=stream))
            gce = None
            if first_only:
                break
        else:  # PIL skips a byte it does not know
            pos += 1
    if not frames:
        raise ValueError(f"{where}: no image in the file")
    return (sw, sh), bg, table, flags & 0x80, frames


def _gif_decode(frame: dict, where: str) -> np.ndarray:
    """The (h, w) indices of a frame, its rows put back in order."""
    x, y, w, h = frame["box"]
    _bound(where, f"a {w} x {h} frame", w * h, _EXPANSION["GIF"] * len(frame["stream"]) + 16)
    px, got = native.gif_lzw_decode(frame["stream"], frame["min_size"], w * h)
    if got < 0:
        raise ValueError(f"{where}: damaged LZW data (a code the stream cannot hold)")
    if got < w * h:
        raise ValueError(f"{where}: {got} pixels decoded of the {w * h} its size holds")
    px = px.reshape(h, w)
    if frame["interlace"]:
        order = np.concatenate([np.arange(s, h, d) for s, d in _GIF_PASSES])
        out = np.empty_like(px)
        out[order] = px
        px = out
    return px


def _gif(data: bytes, name: str, first_only: bool) -> list:
    screen, bg, gtable, has_global, frames = _gif_frames(data, name, first_only)
    where = f"{name}: GIF frame 0"
    f0 = frames[0]
    x, y, w, h = f0["box"]
    size = (max(screen[0], x + w), max(screen[1], y + h))  # PIL grows the screen
    idx = _gif_decode(f0, where)
    t0 = f0["transparency"]
    canvas = np.full((size[1], size[0]), 0 if t0 is None else t0, np.uint8)
    canvas[y:y + h, x:x + w] = idx
    table = f0["local"] if f0["local"] is not None else gtable

    # cv2 (frame 0 alone): the table's blue over the screen's background
    # colour; it refuses a background past the global table, a frame past
    # the screen and an index past its table
    cv2_reads = not ((has_global and bg >= len(gtable)) or x + w > screen[0]
                     or y + h > screen[1] or (table is not None and idx.max() >= len(table)))

    def gray():
        lut = table if table is not None else np.repeat(np.arange(256, dtype=np.uint8)[:, None],
                                                        3, 1)
        if table is None:
            lut = lut.copy()
            lut[1] = 255  # cv2's table without one: grey, its entry 1 white
        back = gtable[bg, 2] if has_global else 0
        out = np.full((screen[1], screen[0]), back, np.uint8)
        blue = lut[idx, 2]
        out[y:y + h, x:x + w] = blue if t0 is None else np.where(idx == t0, back, blue)
        return out
    first = _Raw(canvas, "palette", 8, where, cv2_reads=cv2_reads, pil=lambda c=canvas: c,
                 gray=gray)
    if first_only or len(frames) == 1:
        return [first]
    # PIL's later frames: composed onto the screen in its grey mode (L);
    # after a frame 0 of a colour table (mode P) they are RGB, and a later
    # frame of a colour table fails to load in mode L
    out = [first]
    if _gif_needed(table):
        k = 1
    else:
        disposal, back = f0["disposal"], bg if has_global else 0
        restore = None if t0 is None else np.full((h, w), t0, np.uint8)
        pending = _gif_dispose(disposal, f0["box"], t0, t0, back, restore)
        for k, frame in enumerate(frames[1:], 1):
            fx, fy, fw, fh = frame["box"]
            ftable = frame["local"] if frame["local"] is not None else gtable
            if _gif_needed(ftable) or fx + fw > size[0] or fy + fh > size[1]:
                break
            fidx = _gif_decode(frame, f"{name}: GIF frame {k}")
            canvas = canvas.copy()
            if pending is not None:
                (px, py, pw, ph), fill = pending
                canvas[py:py + ph, px:px + pw] = fill
            disposal = frame["disposal"] or disposal  # PIL keeps the last one given
            ft = frame["transparency"]
            region = canvas[fy:fy + fh, fx:fx + fw]
            restore = region.copy()
            region[...] = fidx if ft is None else np.where(fidx == ft, region, fidx)
            out.append(_Raw(canvas, "palette", 8, f"{name}: GIF frame {k}",
                            pil=lambda c=canvas: c))
            pending = _gif_dispose(disposal, frame["box"], t0, ft, back, restore)
        else:
            return out

    def refused(k=k):
        raise ValueError(f"{name}: GIF frame {k}: PIL does not give this animation's frames "
                         f"as one grey or palette image each (colour frames are RGB after a "
                         f"frame 0 of indices, or a frame leaves the screen), so the JAX "
                         f"package's stack of them fails; {_READS}")
    return out + [_Raw(None, "rgb", 8, f"{name}: GIF frame {k}", pil=refused)]


def _gif_dispose(disposal: int, box, info_t, frame_t, back: int, restore):
    """PIL's disposal of a frame in mode L, applied before the next: (its
    extent, the fill) or None.  2: the transparent index (frame 0's, else
    its own) or the background index; 3: what the extent held before it."""
    if disposal == 2:
        t = info_t if info_t is not None else frame_t
        return box, back if t is None else t
    if disposal == 3 and restore is not None:
        return box, restore
    return None


# ----- SPIDER ------------------------------------------------------------------

_IFORMS = (1, 3, -11, -12, -21, -22)


def _spider_header(data: bytes, at: int = 0):
    """PIL's SPIDER test of the 27 words at ``at`` (big-endian first): (byte
    order, header words with a dummy at 0, header bytes) or None."""
    if len(data) < at + 108:
        return None
    for end in (">", "<"):
        t = (99.0,) + struct.unpack_from(end + "27f", data, at)
        if not all(np.isfinite(t[i]) and t[i] == int(t[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        if int(t[5]) in _IFORMS and int(t[22]) == int(t[13]) * int(t[23]) and int(t[22]):
            return end, t, int(t[22])
    return None


def _spider(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: SPIDER"
    end, t, hdr = _spider_header(data)
    if int(t[5]) != 1:
        raise ValueError(f"{where}: iform {int(t[5])} (a volume or a Fourier form), which PIL "
                         f"does not open; {_READS}")
    istack, imgnum = int(t[24]), int(t[27])
    if istack == 0 and imgnum == 0:
        n, offsets = 1, [None]
    elif istack > 0 and imgnum == 0:
        w, h = int(t[12]), int(t[2])
        n = int(t[26])
        step = hdr + w * h * 4
        offsets = [hdr + k * step for k in range(1 if first_only else max(n, 1))]
    else:
        raise ValueError(f"{where}: inconsistent stack header values (istack {istack}, "
                         f"image {imgnum})")
    out = []
    for k, at in enumerate(offsets):
        fwhere = f"{where} image {k}" if n > 1 else where
        if at is None:  # a single image
            fend, ft, fhdr, data_at = end, t, hdr, hdr
        else:  # each image of a stack by its own header, as PIL seeks to it
            found = _spider_header(data, at)
            if found is None or int(found[1][5]) != 1:
                raise ValueError(f"{fwhere}: not a SPIDER 2D image header at byte {at}")
            fend, ft, fhdr = found
            s, i = int(ft[24]), int(ft[27])
            if s > 0 and i == 0:  # PIL reopens the stack: its first image again
                data_at = 2 * fhdr
            elif s == 0 and i > 0:
                data_at = at + fhdr
            else:
                raise ValueError(f"{fwhere}: inconsistent stack header values")
        w, h = int(ft[12]), int(ft[2])
        if w <= 0 or h <= 0:
            raise ValueError(f"{fwhere} of {w} x {h}")
        _bound(fwhere, f"a {w} x {h} float32 image", w * h * 4, len(data) - data_at)
        px = np.frombuffer(data, fend + "f4", w * h, data_at).reshape(h, w).astype(np.float32)
        out.append(_Raw(px, "grey", 32, fwhere, cv2_reads=False))
    return out


# ----- TGA ---------------------------------------------------------------------

# (image type & 7, depth) -> PIL's mode
_TGA_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "RGBA15",
              (2, 24): "RGB", (2, 32): "RGBA"}


def _tga_header(data: bytes):
    """PIL's TGA test: (id length, map type, image type, map start, map
    length, map depth, width, height, depth, flags) or None."""
    if len(data) < 18:
        return None
    head = struct.unpack_from("<BBBHHBHHHHBB", data)
    idl, cmt, it, _, _, md, _, _, w, h, depth, _ = head
    if cmt not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32) \
            or it not in (1, 2, 3, 9, 10, 11) or (cmt and md not in (16, 24, 32)):
        return None
    return head


def _tga(data: bytes, name: str) -> list:
    where = f"{name}: TGA"
    idl, cmt, it, _, mlen, md, _, _, w, h, depth, flags = _tga_header(data)
    mode = _TGA_MODES.get((it & 7, depth))
    # PIL loads no 1-bit RLE, no RLE colour-mapped type without a map and
    # no map of 32-bit entries
    if mode is None or (mode == "1" and it & 8) or (it == 9 and not cmt) or (cmt and md == 32):
        raise ValueError(f"{where} of image type {it}, {depth} bits, which PIL does not read; "
                         f"{_READS}")
    pos = 18 + idl + (mlen * md // 8 if cmt else 0)
    bpp = max(depth // 8, 1)
    if mode == "1":
        stride = (w + 7) // 8
        _bound(where, f"a {w} x {h} bitmap", stride * h, len(data) - pos)
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
        px = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    else:
        size = w * h * bpp
        if it & 8:
            src = data[pos:]
            _bound(where, f"a {w} x {h} RLE image", w * h, _EXPANSION["TGA"] * len(src) + 128)
            buf, got = native.tga_rle_decode(src, bpp, w * bpp, size)
            if got < 0:
                raise ValueError(f"{where}: damaged RLE data (a repeated pixel's packet crosses "
                                 f"its row)")
            if got < size:
                raise ValueError(f"{where}: {got} bytes decoded of the {size} its rows hold")
        else:
            _bound(where, f"a {w} x {h} image of {depth} bits", size, len(data) - pos)
            buf = np.frombuffer(data, np.uint8, size, pos)
        px = buf.reshape(h, w, bpp)
    if not flags & 0x20:  # bottom-up rows
        px = px[::-1]
    if flags & 0x10:  # right-to-left
        px = px[:, ::-1]
    if mode == "1":
        return [_Raw(px, "grey", 1, where, cv2_reads=False, pil=lambda: px)]

    def pil():
        if mode in ("P", "L"):
            return px[..., 0]
        if mode == "LA":
            return px
        if mode == "RGBA15":
            v = px.view("<u2")[..., 0]
            return np.stack([_scale((v >> 10) & 31, 5), _scale((v >> 5) & 31, 5),
                             _scale(v & 31, 5),
                             np.where(v & 0x8000, 0, 255).astype(np.uint8)], -1)
        return px[..., [2, 1, 0, 3][:bpp]]
    return [_Raw(px, "rgb", 8, where, cv2_reads=False, pil=pil)]


# ----- Sun raster --------------------------------------------------------------


def _sun(data: bytes, name: str) -> list:
    where = f"{name}: Sun raster"
    if len(data) < 32:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than its header")
    _, w, h, depth, _, ftype, maptype, maplen = struct.unpack_from(">8I", data)
    if depth not in (1, 8, 24, 32) or ftype not in (0, 1, 2, 3, 4, 5) or w <= 0 or h <= 0 \
            or maplen > 1024 or (maplen and maptype != 1) or (ftype == 3 and depth < 24):
        raise ValueError(f"{where} of depth {depth}, type {ftype}, map type {maptype} of "
                         f"{maplen} bytes is not read; {_READS}")
    pos = 32 + maplen
    palette = None
    if maplen:
        n = maplen // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
    stride = ((w * depth + 15) // 16) * 2
    size = stride * h
    if ftype == 2:
        src = data[pos:]
        _bound(where, f"a {w} x {h} byte-encoded image", size, _EXPANSION["SUN"] * len(src))
        buf, got = native.sun_rle_decode(src, size)
        if got < size:
            raise ValueError(f"{where}: {got} bytes decoded of the {size} its rows hold")
    else:
        _bound(where, f"a {w} x {h} image of {depth} bits", size, len(data) - pos)
        buf = np.frombuffer(data, np.uint8, size, pos)
    rows = buf.reshape(h, stride)
    # cv2 reads types 0 and 1 (raw, B, G, R order), and of 1 and 8 bits
    # only with a colour map (it gives zeros without one: there the port
    # gives the file's values)
    cv2_reads = ftype in (0, 1)
    if depth == 1:
        black = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
        return [_Raw(black, "grey", 1, where, cv2_reads=cv2_reads, pil=lambda: ~black,
                     gray=lambda: np.where(black, 0, 255).astype(np.uint8))]
    if depth == 8:
        idx = rows[:, :w]
        if palette is None:
            return [_Raw(idx, "grey", 8, where, cv2_reads=cv2_reads)]
        return [_Raw(idx, "palette", 8, where, palette, cv2_reads=cv2_reads, pil=lambda: idx)]
    px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
    rgb = ftype == 3
    if depth == 24:
        order = (0, 1, 2) if rgb else (2, 1, 0)
    else:  # PIL takes RGBX or BGRX; cv2 the XBGR the format defines
        order = (0, 1, 2) if rgb else (2, 1, 0)
    return [_Raw(px, "rgb", 8, where, cv2_reads=cv2_reads, pil=lambda: px[..., order],
                 gray=lambda: px[..., 1 if depth == 32 else 0])]
