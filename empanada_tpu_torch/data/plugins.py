"""The last raster formats of PIL's plugins that the port reads, and cv2's
Radiance HDR: SGI, PCX and DCX, QOI, IM (LabEye IFUNC), XBM and MSP, parsed
with numpy, their RLE and op streams decoded by the port's host library
(``csrc/image_codecs.cpp``).  ``data/raster.py`` identifies each file by
PIL's plugin order and calls ``READERS[format](data, name, first_only)``,
which gives ``data/imread.py``'s ``_Raw`` of each image.

cv2 reads none of PIL's formats here, so ``imread_gray`` (the JAX
package's ``_imread_gray``) is PIL's array, channel 0, and ``imread`` PIL's
array (``Image.open``, frames stacked) of each.  PIL refuses an image of
more than 2 * 89478485 pixels (its decompression-bomb limit), and so does
the port.

SGI: raw or RLE, 1 or 2 bytes a sample, dimension 1 or 2 of one channel or
3 of 3 or 4 (PIL's ``SgiImagePlugin.MODES``), rows bottom-up, each channel
a plane.  PIL gives 8 bits of 16-bit samples, the high byte.  RLE: the
start and length tables (one entry a row and channel) must fit in the
file; each row is packets (a count, 0x80 for the samples that follow, else
one sample repeated), as PIL's decoder reads them: the length counts
packets, not bytes (one of 2^31 or more none: PIL takes it for an int),
and bounds nothing else, a last packet that is not 0
ends the image (the rows not reached stay 0), a short row keeps the
samples of the row read before it, and a row starting in the header, a
run past its row or a read past the file's last byte (a copy reaching it
too) raises.

PCX: 1 bit in 1 plane (bool), 1 bit in 2 or 4 planes (the palette's
indices), version 5 at 8 bits in 1 plane (grey, or the indices of the
palette appended after it: the same array) and in 3 planes (RGB).  PIL
computes the stride itself (the row's bytes, rounded up to even when the
header's differs) and does not trust the header's; a scanline is the
planes' strides; before it unpacks PIL moves the planes together, planes
of bits to ``ceil(width / 8)`` bytes apart and others to the width apart,
each by the stride it divides out of the scanline (the scanline's bytes
over the planes of bits, else over its bytes // width: an RGB row of width
3 and stride 4 divides into four of 3 and stays where it is, misread).  A run may
not cross its scanline (PIL refuses it); data run on past the image into
what follows (an 8-bit file's palette); an 8-bit, 1-plane file shorter
than the 769 bytes of a palette raises, as PIL's seek before the end does.
DCX: up to 1024 PCX pages from its offset table, stacked (PIL checks each
page's palette against the end of the whole file).

QOI: RGB (3 channels) or RGBA (any other count); the op stream as PIL's
decoder reads it: a slot of the 64-pixel table never filled is (0, 0, 0,
0), and a RUN fills no slot (the format's reference decoder fills one);
the end marker is not read.

IM: the text header, lines of ``key: value`` read until a NUL or 0x1A
(a line over 100 bytes, a line not of that form, or no known key, and PIL
does not take the file for IM), then the data after the next 0x1A (after
the Lut's 768 bytes when the header has a ``Lut`` line); ``Image type``
one of ``ImImagePlugin.OPEN``'s: 1, L, LA, P and PA (P from B2 and B4,
packed), RGB (line-interleaved, or ``X 24`` pixel-interleaved, or the
G, R, B planes of RGB3 and RYB3), RGBA, RGBX (RGB), CMYK, YCbCr (its
samples), I;16, I;16L, I;16B (big-endian uint16, as PIL's array is),
I;32S and I;32 (int32), and F from 8-, 16- and 32-bit unsigned, signed
and float samples (float32); rows bottom-up.  A Lut not grey turns L into
P and LA into PA (P from B2 or B4 then reads 8-bit samples), as PIL does;
PA without such a Lut raises (PIL has no raw mode for it).  ``File size
(no of images)`` > 1: the frames, stacked; PIL finds frame k at k times
(width * bits + 7) // 8 * height bytes from the data, bits 1 for mode 1
and else 8 times the mode's name's length (16 for I;16, 8 for F), and the
port reads the frames there (a frame past the file's end raises).  The
``L*n`` images of n bits from 2 to 31 but 8 and 16 (F, float32) are read
as PIL's bit decoder reads them (``native.im_bit_decode``): least
significant bit first, rows bottom-up and padded to a byte, with the
decoder's bit buffer not cleared at a row's end; more than one frame of
them raises, as PIL reads the later frames raw, in a raw mode it has not.

XBM: PIL's header expression on the first 512 bytes (the width and height
``#define``s, an optional hotspot, up to ``_bits[]``), then each ``x``
followed by two characters is a byte (0-9, a-f, A-F, any other character
0), least significant bit first, rows padded to bytes; bool.

MSP: version 1 (``DanM``, rows of bits as they stand) and 2 (``LinS``: a
map of each row's encoded length, a length of 0 a row of set bits; in a
row, 0, count, value is a run, any other byte a count of bytes that follow,
cut at the row's end); PIL joins the rows' bytes and unpacks them as one
(a row that decodes to more or fewer bytes shifts the rest); the header's
16 words must XOR to 0; bool.

Radiance HDR is cv2's alone (PIL opens none, so ``imread`` raises, as the
JAX package's does): ``#?RGBE`` or ``#?RADIANCE``, header lines (read as
C's ``fgets`` of 128 bytes) up to a blank one, among them exactly
``FORMAT=32-bit_rle_rgbe``, then a resolution line ``-Y h +X w`` (the only
orientation cv2 reads); EXPOSURE and GAMMA are not applied.  Scanlines of
the new RLE until one that does not begin 2, 2, from which the rest is
flat, 4 bytes a pixel (all of it under a width of 8 or over 32767);
old-style runs (1, 1, 1, n) are pixels to cv2, which does not expand them
(a file of them then ends early and raises).  Each pixel is cv2's float:
sample * float32(2^(e - 136)), 0 where e is 0; ``imread_gray`` gives
channel 0, blue (the file's third byte).

Every buffer is sized from the header and refused before it is allocated
when the file cannot hold it (``_EXPANSION``, the SGI tables, the XBM
text, PIL's pixel limit); damaged data raises and names the file (and the
frame).
"""

from __future__ import annotations

import re
import struct

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.data.imread import _PIL_PIXELS, _READS, _Raw, _bound

__all__ = ["READERS", "im_header", "is_hdr"]

# the most output a byte of each codec's data expands to: PCX (63 bytes a
# 2-byte run), QOI (62 pixels a RUN byte), MSP version 2 (255 bytes a
# 3-byte run), HDR's new RLE (127 samples of a channel a 2-byte run: under
# 16 pixels a byte with the scanline's 4 header bytes)
_EXPANSION = {"PCX": 32, "QOI": 62, "MSP": 85, "HDR": 16}


def _pixels(where: str, w: int, h: int) -> None:
    """Refuse a size PIL does not open: none of its sides positive, or more
    pixels than its decompression-bomb limit."""
    if w <= 0 or h <= 0:
        raise ValueError(f"{where} of {w} x {h}, which PIL does not open; {_READS}")
    if w * h > _PIL_PIXELS:
        raise ValueError(f"{where}: {w} x {h} pixels, over PIL's limit of {_PIL_PIXELS}; "
                         f"{_READS}")


def _one(pixels, where: str) -> _Raw:
    """PIL's array of an image cv2 does not read."""
    return _Raw(pixels, "grey" if pixels.ndim == 2 else "rgb", 8, where, cv2_reads=False,
                pil=lambda: pixels)


# ----- SGI ---------------------------------------------------------------------

# (bytes a sample, dimension, channels) -> bands, PIL's SgiImagePlugin.MODES
_SGI_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1, (1, 3, 3): 3,
              (2, 3, 3): 3, (1, 3, 4): 4, (2, 3, 4): 4}


def _sgi(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: SGI"
    if len(data) < 512:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than its 512-byte header")
    storage, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">4H", data, 4)
    bands = _SGI_MODES.get((bpc, dim, z))
    if bands is None or storage not in (0, 1):
        raise ValueError(f"{where} of {bpc} bytes a sample, dimension {dim}, {z} channels, "
                         f"storage {storage}, which PIL does not read; {_READS}")
    _pixels(where, w, h)
    if storage == 0:
        size = bands * h * w * bpc
        _bound(where, f"{bands} planes of {w} x {h} samples of {bpc} bytes", size,
               len(data) - 512)
        planes = np.frombuffer(data, np.uint8, size, 512).reshape(bands, h, w, bpc)
        px = planes[..., 0].transpose(1, 2, 0)  # the high byte of each sample
    else:
        n = bands * h
        _bound(where, f"RLE tables of {n} rows", 8 * n, len(data) - 512)
        starts = np.frombuffer(data, ">u4", n, 512)
        lengths = np.frombuffer(data, ">u4", n, 512 + 4 * n)
        rows, got = native.sgi_rle_decode(data[512:], starts, lengths, w, h, bands, bpc)
        if got < 0:
            raise ValueError(f"{where}: damaged RLE data (a row before the data, a run past "
                             f"its row or a read past the file's last byte)")
        px = rows.reshape(h, w, bands, bpc)[..., 0]
    px = px[::-1]
    return [_one(px[..., 0] if bands == 1 else px, where)]


# ----- PCX and DCX -------------------------------------------------------------


def _pcx_image(data: bytes, at: int, where: str) -> _Raw:
    """The PCX image whose header is at ``at`` (its data running on to the
    file's end), as PIL reads it."""
    head = data[at:at + 68]
    if len(head) < 68 or head[0] != 10 or head[1] not in (0, 2, 3, 5):
        raise ValueError(f"{where}: not a PCX header at byte {at}")
    x0, y0, x1, y1 = struct.unpack_from("<4H", head, 4)
    version, bits, planes = head[1], head[3], head[65]
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise ValueError(f"{where}: a bounding box of {w} x {h}, which PIL refuses")
    if bits == 1 and planes in (1, 2, 4):
        pass
    elif version == 5 and bits == 8 and planes in (1, 3):
        if planes == 1 and len(data) < 769:  # PIL seeks to a palette before the end
            raise ValueError(f"{where}: an 8-bit file of {len(data)} bytes, shorter than the "
                             f"769 of a palette, which PIL does not open; {_READS}")
    else:
        raise ValueError(f"{where} of version {version}, {bits} bits in {planes} planes, which "
                         f"PIL does not read; {_READS}")
    _pixels(where, w, h)
    stride = (w * bits + 7) // 8
    if struct.unpack_from("<H", head, 66)[0] != stride:  # PIL: not the header's
        stride += stride % 2
    size = planes * stride
    src = data[at + 128:]
    _bound(where, f"{h} scanlines of {size} bytes", size * h, _EXPANSION["PCX"] * len(src))
    buf, got = native.pcx_rle_decode(src, size, h)
    if got < 0:
        raise ValueError(f"{where}: damaged RLE data (a run crosses its scanline)")
    if got < size * h:
        raise ValueError(f"{where}: {got} bytes decoded of the {size * h} its rows hold")
    rows = buf.reshape(h, size)
    # PIL moves the planes together before it unpacks: planes of bits to
    # ceil(w / 8) bytes apart, others to w bytes apart, each by the stride
    # it divides out of the scanline (a scanline that is not a multiple of
    # the width by the wrong one)
    unit, bands = ((w + 7) // 8, planes) if bits == 1 and planes > 1 else (w, size // w)
    step = size // bands if bands else 0
    if step > unit:
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * unit:(i + 1) * unit] = rows[:, i * step:i * step + unit]
    if bits == 1:
        planes_bits = [np.unpackbits(rows[:, k * unit:(k + 1) * unit], axis=1)[:, :w]
                       for k in range(planes)]
        if planes == 1:
            return _one(planes_bits[0].astype(bool), where)
        return _one(sum(p << k for k, p in enumerate(planes_bits)).astype(np.uint8), where)
    if planes == 1:
        return _one(rows[:, :w], where)
    return _one(np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1), where)


def _pcx(data: bytes, name: str, first_only: bool) -> list:
    return [_pcx_image(data, 0, f"{name}: PCX")]


def _dcx(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: DCX"
    offsets = []
    for k in range(1024):
        if len(data) < 8 + 4 * k:
            raise ValueError(f"{where}: cut in its table of pages")
        offset = struct.unpack_from("<I", data, 4 + 4 * k)[0]
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise ValueError(f"{where}: a table of no pages, which PIL does not open")
    if first_only:
        offsets = offsets[:1]
    return [_pcx_image(data, at, f"{where} page {k}") for k, at in enumerate(offsets)]


# ----- QOI ---------------------------------------------------------------------


def _qoi(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: QOI"
    if len(data) < 14:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than its header")
    w, h, channels = struct.unpack_from(">IIB", data, 4)
    _pixels(where, w, h)
    src = data[14:]
    _bound(where, f"{w} x {h} pixels", w * h, _EXPANSION["QOI"] * len(src))
    px, got = native.qoi_decode(src, w * h)
    if got < w * h:
        raise ValueError(f"{where}: the op stream ends at pixel {got} of {w * h}")
    px = px.reshape(h, w, 4)
    return [_one(px[..., :3] if channels == 3 else px, where)]


# ----- IM (LabEye IFUNC) ---------------------------------------------------------

# ImImagePlugin.OPEN: image type -> (mode, raw mode), built in its order
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# raw mode -> (bits a pixel, numpy dtype of a sample or None for bytes)
_IM_RAW = {"1": (1, None), "P;2": (2, None), "P;4": (4, None), "L": (8, None), "P": (8, None),
           "LA;L": (16, None), "PA;L": (16, None), "RGB": (24, None), "RGB;L": (24, None),
           "YCbCr;L": (24, None), "RGBA;L": (32, None), "RGBX;L": (32, None),
           "CMYK;L": (32, None), "I;16": (16, "<u2"), "I;16L": (16, "<u2"),
           "I;16B": (16, ">u2"), "I;32": (32, "<i4"), "I;32S": (32, "<i4"), "F;8": (8, "u1"),
           "F;8S": (8, "i1"), "F;16": (16, "<u2"), "F;16S": (16, "<i2"), "F;32": (32, "<u4"),
           "F;32S": (32, "<i4"), "F;32F": (32, "<f4")}


def _number(v: str):
    try:
        return int(v)
    except ValueError:
        return float(v)


def im_header(data: bytes):
    """PIL's reading of an IM header: (info, mode, raw mode, offset of the
    data) or None where PIL's IM plugin does not take the file; raises
    where PIL raises on it."""
    if b"\n" not in data[:100]:
        return None
    info = {"Image type": "L", "Image size (x*y)": (512, 512), "File size (no of images)": 1}
    raw, pos, known = "L", 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos, pos + 100)  # no line of PIL's is longer
        end = min(len(data), pos + 100) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return None
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_LINE.match(s)
        if not m:
            return None
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _IM_OPEN:
            v, raw = _IM_OPEN[v]
        info[k] = v
        known += k in _IM_TAGS
    if not known:
        return None
    while s and s != b"\x1a":
        s = data[pos:pos + 1]
        pos += 1
    if not s:
        return None
    return info, info["Image type"], raw, pos


def _im_frame(data: bytes, at: int, w: int, h: int, raw: str, where: str) -> np.ndarray:
    """PIL's raw decoding of one IM frame at ``at``: rows bottom-up."""
    if raw in ("RGB;T", "RYB;T"):  # the G, R and B planes of the whole image
        _bound(where, f"3 planes of {w} x {h}", 3 * w * h, len(data) - at)
        g, r, b = np.frombuffer(data, np.uint8, 3 * w * h, at).reshape(3, h, w)[:, ::-1]
        return np.stack([r, g, b], -1)
    if raw not in _IM_RAW:
        raise ValueError(f"{where}: raw mode {raw}, which PIL does not read (it has no raw "
                         f"mode of that name for the image's mode, or reads it bit by bit); "
                         f"{_READS}")
    bits, dtype = _IM_RAW[raw]
    stride = (w * bits + 7) // 8
    _bound(where, f"{h} rows of {stride} bytes", h * stride, len(data) - at)
    rows = np.frombuffer(data, np.uint8, h * stride, at).reshape(h, stride)[::-1]
    if raw == "1":
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if raw in ("P;2", "P;4"):
        v = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        return (v << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(2, dtype=np.uint8)
    if dtype is not None:
        v = rows.view(dtype).reshape(h, w)
        return v.astype(np.float32) if raw.startswith("F;") else v.copy()
    if raw in ("L", "P"):
        return rows.copy()
    if raw == "RGB":
        return rows.reshape(h, w, 3).copy()
    planes = rows.reshape(h, bits // 8, w).transpose(0, 2, 1)
    return np.ascontiguousarray(planes[..., :3] if raw == "RGBX;L" else planes)


def _im_bits(data: bytes, bits: int, w: int, h: int, where: str) -> np.ndarray:
    """An ``L*<bits>`` frame as PIL's bit decoder reads it
    (``native.im_bit_decode``): float32, rows bottom-up."""
    if bits >= 32:
        raise ValueError(f"{where}: samples of {bits} bits, which PIL's bit decoder refuses; "
                         f"{_READS}")
    _bound(where, f"{h} rows of {w} samples of {bits} bits", h * ((w * bits + 7) // 8),
           len(data))
    px, code = native.im_bit_decode(data, bits, w, h)
    if code < 0:
        raise ValueError(f"{where}: its {bits}-bit samples end before the image (PIL: "
                         f"truncated); {_READS}")
    return px


def _im(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: IM"
    try:
        info, mode, raw, at = im_header(data)
    except ValueError as exc:
        raise ValueError(f"{where}: a header value PIL cannot read ({exc}); {_READS}") from None
    size, frames = info["Image size (x*y)"], info["File size (no of images)"]
    # a frame count that is not a whole number fails _load_array's stack
    # (PIL's first frame still reads)
    frames_bad = isinstance(frames, tuple) or (isinstance(frames, float) and frames > 1)
    if mode not in ("1", "L", "LA", "P", "PA", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F",
                    "I;16", "I;16L", "I;16B") or not isinstance(size, tuple) or len(size) != 2 \
            or not all(isinstance(v, int) for v in size) or (frames_bad and not first_only):
        raise ValueError(f"{where}: image type {mode!r} of size {size!r} and {frames!r} "
                         f"frames, which PIL does not read; {_READS}")
    w, h = size
    _pixels(where, w, h)
    if "Lut" in info:
        lut = np.frombuffer(data, np.uint8, min(768, len(data) - at), at)
        if len(lut) < 768:
            raise ValueError(f"{where}: cut in its Lut")
        at += 768
        grey = (lut[:256] == lut[256:512]).all() and (lut[:256] == lut[512:]).all()
        if not grey and mode in ("L", "P"):
            mode, raw = "P", "P"
        elif not grey and mode in ("LA", "PA"):
            mode, raw = "PA", "PA;L"
    if raw == "PA;L" and mode != "PA":
        raise ValueError(f"{where}: image type PA without a colour Lut, which PIL does not "
                         f"read; {_READS}")
    n = frames if isinstance(frames, int) and frames > 1 and not first_only else 1
    if raw.startswith("F;") and raw[2:].isdigit() and int(raw[2:]) not in (8, 16, 32):
        if n > 1:  # PIL reads frames after the first raw, and has no raw mode F;<bits>
            raise ValueError(f"{where}: {n} frames of {raw[2:]}-bit samples, which PIL reads "
                             f"for frame 0 alone; {_READS}")
        return [_one(_im_bits(data[at:], int(raw[2:]), w, h, where), where)]
    if n > 1 and raw in ("RGB;T", "RYB;T"):
        raise ValueError(f"{where}: {n} frames of raw mode {raw}, which PIL reads for frame 0 "
                         f"alone; {_READS}")
    bits = 1 if mode == "1" else 8 * len(mode)  # PIL's frame size, by the mode's name
    step = (w * bits + 7) // 8 * h
    return [_one(_im_frame(data, at + k * step, w, h, raw,
                           f"{where} frame {k}" if n > 1 else where), where)
            for k in range(n)]


# ----- XBM and MSP -------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdefABCDEF":
    _HEX[_c] = int(chr(_c), 16)


def _xbm(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: XBM"
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise ValueError(f"{where}: no width, height and _bits[] in its first 512 bytes")
    w, h = int(m.group("width")), int(m.group("height"))
    _pixels(where, w, h)
    stride = (w + 7) // 8
    text = np.frombuffer(data, np.uint8, offset=m.end())
    _bound(where, f"{h} rows of {stride} bytes", h * stride, len(text) // 3)
    xs = np.flatnonzero(text == ord("x"))
    if len(xs) > 1 and (np.diff(xs) < 3).any():  # an x within a byte's digits is a digit
        keep, nxt = [], 0
        for x in xs.tolist():
            if x >= nxt:
                keep.append(x)
                nxt = x + 3
        xs = np.asarray(keep, np.int64)
    xs = xs[xs + 2 < len(text)][:h * stride]
    if len(xs) < h * stride:
        raise ValueError(f"{where}: {len(xs)} bytes of the {h * stride} its rows hold")
    rows = (_HEX[text[xs + 1]] << 4 | _HEX[text[xs + 2]]).reshape(h, stride)
    return [_one(np.unpackbits(rows, axis=1, bitorder="little")[:, :w].astype(bool), where)]


def _msp(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: MSP"
    if len(data) < 32:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than its header")
    words = struct.unpack_from("<16H", data)
    check = 0
    for v in words:
        check ^= v
    if check:
        raise ValueError(f"{where}: its header's checksum is not 0, which PIL refuses")
    w, h = words[2], words[3]
    _pixels(where, w, h)
    stride = (w + 7) // 8
    size = stride * h
    if data[:4] == b"DanM":
        _bound(where, f"{h} rows of {stride} bytes", size, len(data) - 32)
        buf = np.frombuffer(data, np.uint8, size, 32)
    else:
        _bound(where, f"a row map of {h} rows", 2 * h, len(data) - 32)
        rowmap = np.frombuffer(data, "<u2", h, 32)
        src = data[32 + 2 * h:]
        _bound(where, f"{h} rows of {stride} bytes", size,
               _EXPANSION["MSP"] * len(src) + stride * int((rowmap == 0).sum()))
        buf, got = native.msp_decode(src, rowmap, stride, size)
        if got < 0:
            raise ValueError(f"{where}: damaged RLE data (a row past the file's end, or a "
                             f"run's count and value past its row)")
        if got < size:
            raise ValueError(f"{where}: {got} bytes decoded of the {size} its rows hold")
    rows = buf.reshape(h, stride)
    return [_one(np.unpackbits(rows, axis=1)[:, :w].astype(bool), where)]


# ----- Radiance HDR ------------------------------------------------------------

_HDR_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")
# cv2's limits on a decoded image's sides and pixels
_CV2_SIDE, _CV2_PIXELS = 1 << 20, 1 << 30


def is_hdr(data: bytes) -> bool:
    """cv2's Radiance signature: ``#?RGBE`` or ``#?RADIANCE`` first."""
    return data[:6] == b"#?RGBE" or data[:10] == b"#?RADIANCE"


def _hdr(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: Radiance HDR"
    pos = 0

    def fgets():
        """C's fgets of 128 bytes from ``pos``, as a C string (to its
        first NUL), or None at the end of the file."""
        nonlocal pos
        if pos >= len(data):
            return None
        end = data.find(b"\n", pos, pos + 127)
        end = min(pos + 127, len(data)) if end < 0 else end + 1
        line, pos = data[pos:end], end
        return line.split(b"\0")[0]
    fgets()  # the signature's line
    has_format = False
    while True:
        line = fgets()
        if line is None:
            raise ValueError(f"{where}: the header has no blank line (cv2 refuses it)")
        if line == b"\n":  # a line of a NUL first is not blank to cv2
            break
        has_format |= line == b"FORMAT=32-bit_rle_rgbe\n"
    line = fgets()
    m = _HDR_SIZE.match(line or b"")
    if not has_format or m is None:
        raise ValueError(f"{where}: no FORMAT=32-bit_rle_rgbe line, or no -Y h +X w line after "
                         f"the header (cv2 refuses it); {_READS}")
    h, w = int(m.group(1)), int(m.group(2))
    if not (0 < w <= _CV2_SIDE and 0 < h <= _CV2_SIDE and w * h <= _CV2_PIXELS):
        raise ValueError(f"{where} of {w} x {h}, which cv2 does not read; {_READS}")
    src = data[pos:]
    _bound(where, f"{w} x {h} pixels", w * h, _EXPANSION["HDR"] * len(src))
    rgbe, status = native.hdr_rle_decode(src, w, h)
    if status == -1:
        raise ValueError(f"{where}: the data ends before its {h} scanlines")
    if status < 0:
        raise ValueError(f"{where}: damaged RLE data (a scanline of another width, or a count "
                         f"of 0 or past its channel)")

    def gray():
        e = rgbe[..., 3].astype(np.int64)
        f = np.ldexp(1.0, e - 136).astype(np.float32)
        return np.where(e == 0, np.float32(0), rgbe[..., 2] * f).astype(np.float32)

    def refused():
        raise ValueError(f"{where}: a Radiance HDR, which PIL does not open (cv2 reads it: "
                         f"imread_gray); {_READS}")
    return [_Raw(rgbe, "rgb", 32, where, pil=refused, gray=gray)]


READERS = {"SGI": _sgi, "PCX": _pcx, "DCX": _dcx, "QOI": _qoi, "IM": _im, "XBM": _xbm,
           "MSP": _msp, "HDR": _hdr}
