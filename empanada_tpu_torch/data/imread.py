"""Image reading without cv2 or PIL: the PNG and TIFF files that training
folders and the command line hold, decoded with numpy and zlib.

``imread(path)`` returns the whole file as PIL's ``Image.open`` gives it,
pages stacked: a multipage TIFF (the IFD chain) or an animated PNG is
(Z, H, W).

``imread_gray(path)`` returns what the JAX package's ``_imread_gray``
returns (``cv2.imread(path, IMREAD_UNCHANGED)``, then channel 0 of a
colour image):

- PNG: 8- and 16-bit grey, 8-bit RGB and RGBA, not interlaced, with any
  of the five row filters.  cv2 orders colour channels BGR, so channel 0
  is blue: the LAST colour channel of the file's RGB;
- TIFF: uncompressed, in strips, one plane (PIL's writer): uint8, uint16,
  int32 or float32 samples, one sample a pixel or RGB (blue again; cv2
  premultiplies an RGBA TIFF by its alpha, which is not reproduced).

Anything else raises and names the format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["imread", "imread_gray", "png_frames", "read_png", "read_tiff", "tiff_pages"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def imread_gray(path: str) -> np.ndarray:
    """The (H, W) image at ``path`` (PNG or TIFF, module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        img = read_png(data, path)
    elif data[:4] in (b"II*\x00", b"MM\x00*"):
        img = read_tiff(data, path)
    else:
        raise ValueError(f"{path}: not a PNG or TIFF file (starts {data[:8]!r}); the "
                         "port reads PNG and uncompressed TIFF")
    if img.ndim == 3:
        # cv2's channel 0 of BGR(A) is blue: the last colour channel of RGB(A)
        img = img[..., 2]
    return img


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


def _png_chunks(data: bytes):
    pos = 8
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _png_unfilter(raw: bytes, w: int, h: int, depth: int, channels: int, name: str):
    bpp = channels * depth // 8
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{name}: PNG data holds {len(raw)} bytes, not {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters, out = rows[:, 0], rows[:, 1:].copy()
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        kind = int(filters[r])
        cur = out[r]
        if kind == 1:
            cur[:] = np.cumsum(cur.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
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
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    return out.reshape(h, w, channels) if channels > 1 else out.reshape(h, w)


def png_frames(data: bytes, name: str = "<png>") -> list:
    """The images of a PNG: its one image, or each frame of an animated
    PNG (APNG) composed onto the canvas as its ``fcTL`` says (offsets,
    dispose ops; blend op OVER only without an alpha channel, where it
    equals SOURCE)."""
    header, idat, frames, control = None, [], [], None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"fcTL":
            control = struct.unpack(">IIIIIHHBB", body)[1:]
            frames.append([control, []])
        elif kind == b"IDAT":
            idat.append(body)
            if frames:  # the default image is the first frame
                frames[-1][1].append(body)
        elif kind == b"fdAT":
            frames[-1][1].append(body[4:])
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if channels is None or depth not in (8, 16) or (channels > 1 and depth != 8) or interlace:
        raise ValueError(
            f"{name}: PNG colour type {color}, bit depth {depth}, interlace {interlace} "
            "is not read; the port reads 8/16-bit grey and 8-bit RGB/RGBA, not interlaced")
    if not frames:
        return [_png_unfilter(zlib.decompress(b"".join(idat)), w, h, depth, channels, name)]
    canvas, out = None, []
    for (fw, fh, x0, y0, _, _, dispose, blend), parts in frames:
        img = _png_unfilter(zlib.decompress(b"".join(parts)), fw, fh, depth, channels, name)
        if canvas is None:
            canvas = np.zeros((h, w) + img.shape[2:], img.dtype)
        if blend == 1 and channels == 4:
            raise ValueError(f"{name}: APNG frame blended OVER with alpha is not read")
        region = (slice(y0, y0 + fh), slice(x0, x0 + fw))
        before = canvas.copy() if dispose == 2 else None
        canvas[region] = img
        out.append(canvas.copy())
        if dispose == 1:
            canvas[region] = 0
        elif dispose == 2:
            canvas = before
    return out


def read_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """The first image of a PNG (module docstring)."""
    return png_frames(data, name)[0]


_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}  # BYTE, SHORT, LONG, LONG8


def _tiff_page(data: bytes, end: str, ifd: int, name: str):
    """(image, offset of the next IFD) of the IFD at ``ifd``."""
    (n,) = struct.unpack(end + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack(end + "HHI4s",
                                               data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        code = _TIFF_TYPES.get(typ)
        if code is None:
            continue
        size = struct.calcsize(code) * count
        raw = value if size <= 4 else data[struct.unpack(end + "I", value)[0]:][:size]
        tags[tag] = struct.unpack(end + code * count, raw[:size])
    (next_ifd,) = struct.unpack(end + "I", data[ifd + 2 + 12 * n:ifd + 6 + 12 * n])
    w, h = tags[256][0], tags[257][0]
    bits = tags.get(258, (1,))
    compression = tags.get(259, (1,))[0]
    spp = tags.get(277, (1,))[0]
    fmt = tags.get(339, (1,))[0]
    planar = tags.get(284, (1,))[0]
    dtype = {(8, 1): "u1", (16, 1): "u2", (32, 2): "i4", (32, 3): "f4"}.get((bits[0], fmt))
    if compression != 1 or planar != 1 or dtype is None or len(set(bits)) != 1 \
            or spp not in (1, 3):
        raise ValueError(
            f"{name}: TIFF with compression {compression}, bits {bits}, sample format "
            f"{fmt}, {spp} samples, planar {planar} is not read; the port reads "
            "uncompressed uint8/uint16/int32/float32 strips")
    offsets, counts = tags[273], tags[279]
    buf = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
    img = np.frombuffer(buf, end + dtype, count=w * h * spp).astype(dtype)
    return (img.reshape(h, w, spp) if spp > 1 else img.reshape(h, w)), next_ifd


def tiff_pages(data: bytes, name: str = "<tiff>") -> list:
    """Every page of a TIFF, following the chain of IFDs (one a page, as
    PIL's multipage writer and ``imwrite`` lay them out)."""
    end = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(end + "I", data[4:8])
    pages, seen = [], set()
    while ifd:
        if ifd in seen or ifd + 2 > len(data):
            raise ValueError(f"{name}: TIFF IFD chain loops or leaves the file at {ifd}")
        seen.add(ifd)
        page, ifd = _tiff_page(data, end, ifd, name)
        pages.append(page)
    return pages


def read_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """The first page of a TIFF (module docstring)."""
    end = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(end + "I", data[4:8])
    return _tiff_page(data, end, ifd, name)[0]


def imread(path: str) -> np.ndarray:
    """The whole image file at ``path`` as PIL's ``Image.open`` gives it:
    (H, W) or (H, W, C) for one image, and the pages (frames) stacked as
    (Z, H, W) for a multipage TIFF or an animated PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        pages = png_frames(data, path)
    elif data[:4] in (b"II*\x00", b"MM\x00*"):
        pages = tiff_pages(data, path)
    else:
        raise ValueError(f"{path}: not a PNG or TIFF file (starts {data[:8]!r}); the "
                         "port reads PNG and uncompressed TIFF")
    if len(pages) == 1:
        return pages[0]
    if len({p.shape for p in pages}) != 1:
        raise ValueError(f"{path}: its {len(pages)} pages differ in shape")
    return np.stack(pages)  # pages of other dtypes promote, as numpy stacks PIL's
