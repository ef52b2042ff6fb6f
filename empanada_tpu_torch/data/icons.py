"""The icon and layered formats of PIL's plugins that the JAX package reads
through ``Image.open``: XPM, ICO and CUR, PSD and ICNS, parsed as PIL
12.1's plugins parse them; PSD's PackBits rows and ICNS's RGB runs are
decoded by the port's host library (``csrc/image_codecs.cpp``), ICO's and
ICNS's PNG members by ``data/imread.py`` and their DIB and JPEG 2000
members by ``data/raster.py`` and ``data/jpeg2000.py``.
``data/raster.py`` identifies each file by PIL's plugin order and calls
``READERS[format](data, name, first_only)``, which gives
``data/imread.py``'s ``_Raw`` of the image.  cv2 reads none of them, so
``imread_gray`` (the JAX package's ``_imread_gray``) is PIL's array,
channel 0, and ``imread`` PIL's array.

XPM (``XpmImagePlugin``): the first line after ``/* XPM */`` that starts
``"W H N cpp``, then N colour lines, each a key of cpp characters after its
quote and pairs of words up to the line's last two characters, of which
the first ``c`` pair is the colour: ``#`` and hexadecimal digits (the low
24 bits as R, G, B), or ``None`` (the key gets no colour: a pixel of it
raises, as PIL's lookup does); any other colour, or a line without ``c``,
is refused, as PIL refuses it.  Then every line's text between its first
and last quote (a ``/* pixels */`` line skipped once), cut into keys of
cpp characters, row after row until the image is full: the keys' indices
(mode P, up to 256 colours) or their RGB (more).

ICO (``IcoImagePlugin``): the directory's entries sorted by colour depth
(bpp, else ceil(log2(colours)), else 256), then by area, largest first;
the first is read.  A PNG member is the PNG's array as PIL gives it (its
size may differ from the directory's); a DIB member (``data/raster.py``'s
BMP reader, its height halved) is RGBA: its colours (a palette looked up),
and as alpha the fourth byte of each pixel where the directory says 32
bits, else the AND mask at the member's end (by the directory's size; a
set bit transparent; its last row's padding may be missing, as PIL's raw
decoder reads no padding after its last row), rows bottom-up; a damaged
PNG member raises.  CUR (``CurImagePlugin``): the
first entry, or a later one wider and taller by the directory's bytes;
its DIB, height halved, as PIL's BMP reader gives it, without a mask:
indices of a palette, and BGRA read as RGBA for 32 bits when the DIB
starts at byte 22 (a CUR of one entry), else RGB.  A PNG in a CUR is
refused, as PIL refuses it.

PSD (``PsdImagePlugin``): colour modes bitmap (1 bit: bool), grey,
indexed (its indices), RGB (RGBA of exactly four channels), CMYK (each
channel inverted, as PIL's ``;I`` raw modes), multichannel and duotone (the
first channel) and Lab (a and b XORed with 0x80: PIL's signed samples)
at 8 bits (``MODES``); other depths and modes are
refused by name, as PIL refuses them.  The composite follows the colour
mode data, the image resources (walked as PIL walks them) and the layer
and mask section: raw planes, or PackBits rows behind their byte-count
table (a table of the channels PIL reads, not the file's: a fifth channel
shifts the rest, as in PIL), each channel a stream of packets from its
offset on, a packet past its row's end cut (PIL's decoder); other
compressions are refused, as PIL cannot load them.  PIL numbers a PSD's
layers from 1, and the JAX package's ``_load_array`` seeks frame 0 of any
file of more than one frame, which raises: ``imread`` of a PSD of two or
more layers (PIL's count: records of more than 4 channels do not count)
raises with that reason, while ``imread_gray`` reads the composite, as
``np.asarray(Image.open(...))`` does.

ICNS (``IcnsImagePlugin``): the blocks up to the header's length; of
PIL's sizes (w, h, scale) the largest as a tuple; every member of it read
in PIL's order (PNG, JPEG 2000, then ``it32``/``ih32``/``il32``/``is32``
RGB, raw interleaved where its length is exactly three planes, else
runs, and the ``t8mk``/``h8mk``/``l8mk``/``s8mk`` mask); a PNG or JPEG
2000 member wins (a JPEG 2000 converted to RGBA as PIL converts it), else
the RGB with the mask as alpha; an image whose size none of the file's
sizes divides is refused, as PIL's size check refuses it.  ``np.asarray``
of PIL's image packs the bytes of the mode ``_open`` set (RGBA) and shapes
them by the loaded mode: an RGB image (no mask, or an RGB PNG) is the
first three quarters of its RGBX bytes (each pixel's fourth byte 255)
seen as RGB, and a grey, palette or grey-alpha PNG is refused, as PIL
has no packer for it.  An RGB member of runs without a mask is refused:
PIL puts its planes into ``Image.new("RGB", size, None)``, whose fourth
bytes it never writes, so its array holds whatever that memory held.

Every buffer is sized from the header and refused before it is allocated
when the file cannot hold it; PIL's decompression-bomb limit holds; damaged
data raises and names the file.
"""

from __future__ import annotations

import io
import math
import re
import struct
import zlib

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.data.imread import _PNG_SIGNATURE, _READS, _png_raw
from empanada_tpu_torch.data.plugins import _one, _pixels

__all__ = ["READERS"]


def _refuse(where: str, why: str):
    raise ValueError(f"{where}: {why}; {_READS}")


def _png_member(data: bytes, where: str) -> np.ndarray:
    """PIL's array of an icon's PNG member (the PNG reader's default
    image); damaged PNG data raises ValueError naming the file."""
    try:
        raw = _png_raw(data, f"{where} PNG member", first_only=True)[0]
        _pixels(where, *raw.pixels.shape[1::-1])
        return raw.as_pil()
    except (zlib.error, struct.error, IndexError) as exc:
        _refuse(where, f"a damaged PNG member ({exc})")


def _unpack(fmt: str, data: bytes, where: str, what: str):
    """struct.unpack of ``data``, refusing it (as PIL's struct.error does)
    where it is too short."""
    if len(data) < struct.calcsize(fmt):
        _refuse(where, f"{what} cut by the file's end")
    return struct.unpack_from(fmt, data)


# ----- XPM ---------------------------------------------------------------------

_XPM_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _xpm(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: XPM"
    f = io.BytesIO(data)
    f.read(9)
    while True:
        line = f.readline()
        if not line:
            _refuse(where, "no values line, which PIL does not open")
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, n, cpp = (int(g) for g in m.groups())
    except ValueError:
        _refuse(where, "an empty value in its values line, which PIL does not open")
    palette = {}
    for _ in range(n):
        line = f.readline().rstrip()
        key, words = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    _refuse(where, f"a colour key {key!r} without a value")
                rgb = words[i + 1]
                if rgb == b"None":  # transparency: the key gets no colour
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        _refuse(where, f"colour {rgb!r}, which PIL cannot read")
                    palette[key] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    _refuse(where, f"colour {rgb!r} (PIL reads # and None alone)")
                break
        else:
            _refuse(where, f"a colour line without a c key ({line[:40]!r}), which PIL "
                           f"cannot read")
    _pixels(where, w, h)
    rgb_mode = n > 256
    if cpp <= 0:
        _refuse(where, f"{cpp} characters a pixel, which PIL cannot read")
    keys = list(palette)
    table = {k: (palette[k] if rgb_mode else bytes((i,))) for i, k in enumerate(keys)}
    need = w * h * (3 if rgb_mode else 1)
    out, header = [], False
    got = 0
    while got < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        full = len(text) // cpp * cpp
        if full:
            codes = np.frombuffer(text, np.dtype((np.void, cpp)), full // cpp)
            uniq, inverse = np.unique(codes, return_inverse=True)
            try:
                values = [table[bytes(u)] for u in uniq]
            except KeyError as exc:
                _refuse(where, f"a pixel of key {exc.args[0]!r}, which its colours do not "
                               f"give (PIL raises)")
            lut = np.frombuffer(b"".join(values), np.uint8).reshape(len(uniq), -1)
            out.append(lut[inverse.ravel()].ravel())
            got += out[-1].size
        if full < len(text):
            tail = text[full:]
            if tail not in table:
                _refuse(where, f"a pixel of key {tail!r}, which its colours do not give "
                               f"(PIL raises)")
            out.append(np.frombuffer(table[tail], np.uint8))
            got += out[-1].size
    if got < need:
        _refuse(where, f"pixels for {got} of {need} bytes (PIL: not enough image data)")
    px = np.concatenate(out)[:need]
    return [_one(px.reshape(h, w, 3) if rgb_mode else px.reshape(h, w), where)]


# ----- ICO and CUR ---------------------------------------------------------------

def _dib_halved(member: bytes, where: str, check_pixels: bool):
    """The DIB ``member`` with its height halved as PIL halves an icon's
    (int(h / 2)), for ``data/raster.py``'s BMP reader; and the offset of
    its pixels in it."""
    if member[:2] == b"BM" or len(member) < 16:
        _refuse(where, "a member that is no DIB, which PIL does not open")
    size = struct.unpack_from("<I", member)[0]
    out = bytearray(member)
    if size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", member, 4)
        struct.pack_into("<H", out, 6, h // 2)
        compression, colors, entry = 0, 0, 3
    elif len(member) >= 40:
        w, h, _, bits, compression = struct.unpack_from("<IIHHI", member, 4)
        colors, entry = struct.unpack_from("<I", member, 32)[0], 4
        top = h >> 24 == 0xFF
        h = 2 ** 32 - h if top else h
        struct.pack_into("<I", out, 8, 2 ** 32 - h // 2 if top else h // 2)
    else:
        _refuse(where, "a DIB header cut by the file's end")
    if check_pixels:
        _pixels(where, w, h)
    at = size + (12 if compression == 3 and size == 40 else 0)
    if bits <= 8:
        at += (colors or 1 << bits) * entry
    return bytes(out), at, w, h // 2


def _bmp_raw(dib: bytes, where: str):
    from empanada_tpu_torch.data import raster

    return raster._bmp(dib, where)[0]


def _ico(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: ICO"
    (count,) = _unpack("<4xH", data, where, "its header")
    entries = []
    for k in range(count):
        s = data[6 + 16 * k:22 + 16 * k]
        width, height, colours, _, _, bpp, size, offset = _unpack(
            "<BBBBHHII", s, where, f"directory entry {k}")
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append(((width or 256) * (height or 256), depth, bpp, size, offset))
    if not entries:
        _refuse(where, "no icons, which PIL does not open")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    member = data[offset:]
    if member[:8] == _PNG_SIGNATURE:
        return [_one(_png_member(member, where), where)]
    dib, at, w, h = _dib_halved(member, where, True)
    raw = _bmp_raw(dib, f"{where} DIB member")
    if raw.palette is not None:
        rgb = raw.palette[raw.pixels]
    else:
        rgb = raw.as_pil()[..., :3]
    if bpp == 32:  # the fourth byte of each pixel, rows bottom-up
        alpha = np.frombuffer(member[at:at + w * h * 4][3::4], np.uint8)
        if alpha.size < w * h:
            _refuse(where, "a 32-bit member cut by the file's end")
        alpha = alpha[:w * h].reshape(h, w)[::-1]
    else:  # the AND mask at the member's end by the directory's size
        stride = (w + 31) // 32 * 4
        start = offset + size - stride * h
        mask = data[max(start, 0):start + stride * h]
        # PIL's raw decoder needs no padding after the last row it reads
        if start < 0 or len(mask) < stride * (h - 1) + (w + 7) // 8:
            _refuse(where, "an AND mask outside the file")
        mask = np.frombuffer(mask.ljust(stride * h, b"\0"), np.uint8)
        bits = np.unpackbits(mask.reshape(h, stride), axis=1)[::-1, :w]
        alpha = np.where(bits == 1, 0, 255).astype(np.uint8)
    return [_one(np.concatenate([rgb, alpha[..., None]], -1), where)]


def _cur(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: CUR"
    (count,) = _unpack("<4xH", data, where, "its header")
    best = b""
    for k in range(count):
        s = data[6 + 16 * k:22 + 16 * k]
        if not best:
            best = s
        elif len(s) < 2:
            _refuse(where, f"directory entry {k} cut by the file's end")
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    if not best:
        _refuse(where, "no cursors, which PIL does not open")
    (offset,) = _unpack("<12xI", best, where, "its cursor's directory entry")
    member = data[offset:]
    if member[:8] == _PNG_SIGNATURE:
        _refuse(where, "a PNG cursor, which PIL does not open")
    dib, at, w, h = _dib_halved(member, where, False)
    _pixels(where, w, h)
    raw = _bmp_raw(dib, f"{where} DIB member")
    bits, compression = struct.unpack_from("<H", dib, 14)[0], struct.unpack_from("<I", dib, 16)[0]
    if offset == 22 and bits == 32 and compression == 0 and raw.pixels.ndim == 3:
        return [_one(np.ascontiguousarray(raw.pixels[..., [2, 1, 0, 3]]), where)]  # BGRA
    return [_one(raw.as_pil(), where)]


# ----- PSD ---------------------------------------------------------------------

# (colour mode, bits) -> (PIL's mode, channels read), PsdImagePlugin.MODES
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}


def _psd_layers(block: bytes, where: str) -> int:
    """PIL's count of the layers (``n_frames``) in the layer info ``block``:
    records of more than 4 channels skipped; raises where PIL's
    ``_layerinfo`` raises on the records or the channel data after them."""
    f = io.BytesIO(block)

    def read(n):
        b = f.read(n)
        if len(b) < n:
            _refuse(where, "a layer record cut short (PIL's layer count raises)")
        return b

    (ct,) = struct.unpack(">h", read(2))
    if len(block) < abs(ct) * 20:
        _refuse(where, "a layer block too short for its layers (PIL raises)")
    layers = []
    for _ in range(abs(ct)):
        y0, x0, y1, x1, types = struct.unpack(">iiiiH", read(18))
        if types > 4:
            f.seek(types * 6 + 12, io.SEEK_CUR)
            f.seek(struct.unpack(">I", read(4))[0], io.SEEK_CUR)
            continue
        bands = []
        for _ in range(types):
            (kind,) = struct.unpack(">H", read(2))
            if kind != 65535 and kind > 3:
                _refuse(where, f"a layer channel of type {kind} (PIL's layer count raises)")
            bands.append("A" if kind == 65535 else "RGBA"[kind])
            read(4)
        bands.sort()
        mode = {"R": "L", "BGR": "RGB", "ABGR": "RGBA"}.get("".join(bands), "")
        read(12)
        (size,) = struct.unpack(">I", read(4))
        if size:
            end = f.tell() + size
            (length,) = struct.unpack(">I", read(4))
            if length:
                f.seek(length - 16, io.SEEK_CUR)
            (length,) = struct.unpack(">I", read(4))
            if length:
                f.seek(length, io.SEEK_CUR)
            length = read(1)[0]
            if length:
                read(length)
            f.seek(end)
        layers.append((mode, x1 - x0, y1 - y0))
    for mode, xsize, ysize in layers:  # _maketile of each band's channel data
        for _ in mode:
            (compression,) = struct.unpack(">H", read(2))
            offset = f.tell()
            if compression == 0:
                offset += xsize * ysize
            elif compression == 1:
                counts = f.read(ysize * 2) if ysize >= 0 else f.read()
                offset = f.tell()
                for y in range(ysize):
                    if 2 * y + 2 > len(counts):
                        _refuse(where, "a layer's row table cut short (PIL's layer count "
                                       "raises)")
                    offset += struct.unpack_from(">H", counts, 2 * y)[0]
            f.seek(offset)
            if offset & 1:
                f.read(1)
    return len(layers)


def _psd(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: PSD"
    f = io.BytesIO(data)

    def u32():
        return _unpack(">I", f.read(4), where, "a section length")[0]

    head = f.read(26)
    if len(head) < 26 or struct.unpack_from(">H", head, 4)[0] != 1:
        _refuse(where, "a header that is not PSD version 1, which PIL does not open")
    channels_file, h, w, bits, colour = struct.unpack_from(">HIIHH", head, 12)
    if (colour, bits) not in _PSD_MODES:
        _refuse(where, f"colour mode {colour} at {bits} bits, which PIL does not open")
    mode, channels = _PSD_MODES[(colour, bits)]
    if channels > channels_file:
        _refuse(where, f"{channels_file} channels where its mode needs {channels}")
    if mode == "RGB" and channels_file == 4:
        mode, channels = "RGBA", 4
    _pixels(where, w, h)
    f.read(u32())  # colour mode data
    size = u32()
    if size:  # image resources, walked as PIL walks them
        end = f.tell() + size
        while f.tell() < end:
            f.read(4)
            _unpack(">H", f.read(2), where, "an image resource")
            length = f.read(1)
            if not length:
                _refuse(where, "an image resource cut by the file's end")
            if not len(f.read(length[0])) & 1:
                f.read(1)
            if len(f.read(u32())) & 1:
                f.read(1)
    layers_at = None
    size = u32()
    if size:
        end = f.tell() + size
        layers_size = u32()
        if layers_size:
            layers_at = f.tell()
        f.seek(end)
    (compression,) = _unpack(">H", f.read(2), where, "the image data's compression")
    if not first_only and layers_at is not None:
        block = data[layers_at:layers_at + layers_size]
        if len(block) < layers_size:
            _refuse(where, "a layer section cut by the file's end (PIL's layer count raises)")
        try:
            n = _psd_layers(block, where)
        except ValueError as exc:
            if where in str(exc):
                raise
            _refuse(where, f"its layer records ({exc}), on which PIL's layer count raises")
        if n > 1:
            _refuse(where, f"{n} layers: PIL numbers PSD layers from 1, so the JAX package's "
                           f"reader, which seeks frame 0 of a file of more than one frame, "
                           f"raises (imread_gray reads the composite)")
    row = (w + 7) // 8 if mode == "1" else w
    offset = f.tell()
    planes = []
    if compression == 0:
        for k in range(channels):
            at = offset + k * w * h
            if at + row * h > len(data):
                _refuse(where, f"channel {k} cut by the file's end (PIL: truncated)")
            planes.append(np.frombuffer(data, np.uint8, row * h, at).reshape(h, row))
    elif compression == 1:
        table = f.read(channels * h * 2)
        if len(table) < channels * h * 2:
            _refuse(where, "its row byte counts cut by the file's end")
        counts = np.frombuffer(table, ">u2").astype(np.int64)
        at = offset + len(table)
        for k in range(channels):
            # a 2-byte packet gives at most 128 bytes: refuse before allocating
            if row * h > 64 * max(len(data) - at, 0):
                _refuse(where, f"channel {k}'s PackBits data too short for its {h} rows "
                               f"(PIL: truncated)")
            plane, used = native.packbits_rows_decode(data[at:], row, h)
            if used < 0:
                _refuse(where, f"channel {k}'s PackBits data ends before its {h} rows "
                               f"(PIL: truncated)")
            planes.append(plane)
            at += int(counts[k * h:(k + 1) * h].sum())
    else:
        _refuse(where, f"compression {compression} of its image data, which PIL cannot load")
    if mode == "1":
        return [_one(np.unpackbits(planes[0], axis=1)[:, :w].astype(bool), where)]
    if channels == 1:
        return [_one(np.ascontiguousarray(planes[0]), where)]
    px = np.stack(planes, -1)
    if mode == "CMYK":  # PIL's C;I, M;I, Y;I, K;I
        px = 255 - px
    elif mode == "LAB":  # PIL's A and B samples are signed: their bytes ^ 0x80
        px[..., 1:] ^= 0x80
    return [_one(px, where)]


# ----- ICNS --------------------------------------------------------------------

# PIL's IcnsFile.SIZES: (w, h, scale) -> its members' types, in its order
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk")}
_ICNS_RGB = (b"it32", b"ih32", b"il32", b"is32")
_ICNS_MASK = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")


def _rgba(px: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGBA")`` of an 8-bit L, LA, RGB or RGBA array."""
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[2] in (1, 2):
        px = np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], -1)
    if px.shape[2] == 3:
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255, np.uint8)], -1)
    return px


def _icns_member(data: bytes, kind: bytes, start: int, length: int, size, where: str) -> dict:
    """PIL's reader of one ICNS member: {"RGBA" | "RGB" | "A": array}."""
    w, h = size[0] * size[2], size[1] * size[2]
    if kind in _ICNS_MASK:
        mask = np.frombuffer(data[start:start + w * h], np.uint8)
        if mask.size < w * h:
            _refuse(where, f"its {kind.decode()} mask cut by the file's end")
        return {"A": mask.reshape(h, w)}
    if kind in _ICNS_RGB:
        if kind == b"it32":
            if data[start:start + 4] != b"\0\0\0\0":
                _refuse(where, "an it32 member without its four zero bytes")
            start, length = start + 4, length - 4
        if length == w * h * 3:
            rgb = np.frombuffer(data[start:start + length], np.uint8)
            if rgb.size < length:
                _refuse(where, f"its {kind.decode()} member cut by the file's end")
            return {"RGB": rgb.reshape(h, w, 3)}
        planes, code = native.icns_rle_decode(data[start:], w * h)
        if code < 0:
            _refuse(where, f"its {kind.decode()} runs overshoot a plane or end early (PIL "
                           f"raises)")
        return {"RGB": np.ascontiguousarray(planes.reshape(3, h, w).transpose(1, 2, 0)),
                "runs": True}
    sig = data[start:start + 12]
    if sig.startswith(_PNG_SIGNATURE):
        return {"RGBA": _png_member(data[start:], where)}
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) \
            or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        from empanada_tpu_torch.data import jpeg2000

        px = jpeg2000.read(data[start:start + length], f"{where} JPEG 2000 member")[0].as_pil()
        if px.dtype != np.uint8:
            _refuse(where, f"a JPEG 2000 member of {px.dtype} samples, which the port does "
                           f"not convert to RGBA")
        return {"RGBA": _rgba(px)}
    _refuse(where, f"a {kind.decode('latin-1')} member of a form PIL does not read")


def _icns(data: bytes, name: str, first_only: bool) -> list:
    where = f"{name}: ICNS"
    _, total = _unpack(">4si", data, where, "its header")
    blocks, i = {}, 8
    while i < total:
        kind, size = _unpack(">4si", data[i:i + 8], where, "a block header")
        if size <= 0:
            _refuse(where, "a block of no length, which PIL does not open")
        blocks[kind] = (i + 8, size - 8)
        i += size
    sizes = [s for s, kinds in _ICNS_SIZES.items() if any(k in blocks for k in kinds)]
    if not sizes:
        _refuse(where, "no icon of a size PIL reads")
    best = max(sizes)
    _pixels(where, best[0] * best[2], best[1] * best[2])
    got = {}
    for kind in _ICNS_SIZES[best]:
        if kind in blocks:
            got.update(_icns_member(data, kind, *blocks[kind], best, where))
    if "RGBA" in got:
        px = got["RGBA"]
    elif "RGB" not in got:
        _refuse(where, "a mask without its RGB member (PIL raises)")
    elif "A" in got:
        px = np.concatenate([got["RGB"], got["A"][..., None]], -1)
    elif "runs" in got:
        _refuse(where, "an RGB member of runs without its mask: PIL's array of it holds "
                       "the fourth byte of each pixel, which PIL's Image.new never set")
    else:
        px = got["RGB"]
    # np.asarray takes PIL's tobytes of the mode _open set (RGBA), which
    # the loaded image's mode then shapes: RGBA as it is, RGB as the first
    # three quarters of its RGBX bytes, and no other mode packs to RGBA
    if px.dtype != np.uint8 or px.ndim != 3 or px.shape[2] not in (3, 4):
        _refuse(where, "a member of another mode than RGB or RGBA (PIL: no packer to RGBA)")
    ph, pw = px.shape[:2]
    if px.shape[2] == 3:
        rgbx = _rgba(px).ravel()
        px = rgbx[:ph * pw * 3].reshape(ph, pw, 3)
    for s in sizes:  # PIL's size setter: one of the file's sizes a multiple of the image's
        if (s[1] * s[2]) / ph == (s[0] * s[2]) // pw:
            break
    else:
        _refuse(where, f"an image of {pw} x {ph}, which none of its sizes fits (PIL raises)")
    return [_one(px, where)]


READERS = {"XPM": _xpm, "ICO": _ico, "CUR": _cur, "PSD": _psd, "ICNS": _icns}
