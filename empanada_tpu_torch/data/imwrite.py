"""Image writing without PIL: PNG and uncompressed TIFF, one image or a
stack of pages, for the command line and the curation layer.

``imwrite(path, array)`` picks the format by the extension (``.png``,
``.tif``, ``.tiff``) and writes what PIL's ``Image.fromarray(a).save(path)``
(``save_all=True`` for a stack) would, read back pixel for pixel:

- uint8 and uint16 as 8- and 16-bit grey; int32 as 32-bit signed and
  float32 as 32-bit float samples in TIFF;
- in PNG, int32 is clipped to [0, 65535] and written as 16-bit grey (what
  PIL does with its "I" mode); float32 has no PNG form and raises;
- a (Z, H, W) stack, or a list of (H, W) pages, is a multipage TIFF (one
  IFD a page, each with one strip and its own dtype) or an animated PNG
  (every frame whole, none of PIL's difference cropping).

``imread`` reads all of them back.  Other dtypes, other extensions and
TIFFs past 4 GiB (BigTIFF) raise.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["imwrite", "png_bytes", "tiff_bytes"]

# TIFF (BitsPerSample, SampleFormat) per dtype
_TIFF_SAMPLES = {np.dtype(np.uint8): (8, 1), np.dtype(np.uint16): (16, 1),
                 np.dtype(np.int32): (32, 2), np.dtype(np.float32): (32, 3)}
_SHORT, _LONG = 3, 4


def _pages(array, name: str) -> list:
    """The 2D pages of an (H, W) image, a (Z, H, W) stack or a list of
    (H, W) images (pages may differ in dtype, as PIL's frames may)."""
    pages = [np.asarray(array)] if not isinstance(array, (list, tuple)) else \
        [np.asarray(a) for a in array]
    if len(pages) == 1 and pages[0].ndim == 3:
        pages = list(pages[0])
    for a in pages:
        if a.dtype not in _TIFF_SAMPLES:
            raise ValueError(f"{name}: dtype {a.dtype} is not written; the port writes "
                             "uint8, uint16, int32 and float32 images")
        if a.ndim != 2 or 0 in a.shape or a.shape != pages[0].shape:
            raise ValueError(f"{name}: (H, W) pages of one shape, not {a.shape}")
    if not pages:
        raise ValueError(f"{name}: no page to write")
    return pages


def tiff_bytes(array, name: str = "<tiff>") -> bytes:
    """Little-endian uncompressed TIFF of an (H, W) image, a (Z, H, W)
    stack or a list of (H, W) pages (module docstring)."""
    pages = _pages(array, name)
    h, w = pages[0].shape
    # the strips first, then the IFDs one after the other (each points at
    # the next), all on word boundaries
    strips = [np.ascontiguousarray(p, p.dtype.newbyteorder("<")).tobytes() for p in pages]
    at = np.cumsum([8] + [len(b) + len(b) % 2 for b in strips])
    n_tags = 11
    ifd_size = 2 + 12 * n_tags + 4
    if at[-1] + ifd_size * len(strips) > 2 ** 32 - 1:
        raise ValueError(f"{name}: a TIFF past 4 GiB needs BigTIFF, which the port "
                         "does not write")
    out = [b"II*\x00", struct.pack("<I", at[-1])]
    out += [b + b"\x00" * (len(b) % 2) for b in strips]
    for z, page in enumerate(pages):
        bits, fmt = _TIFF_SAMPLES[page.dtype]
        tags = [(256, _LONG, w), (257, _LONG, h), (258, _SHORT, bits), (259, _SHORT, 1),
                (262, _SHORT, 1), (273, _LONG, int(at[z])), (277, _SHORT, 1),
                (278, _LONG, h), (279, _LONG, len(strips[z])), (284, _SHORT, 1),
                (339, _SHORT, fmt)]
        nxt = int(at[-1]) + ifd_size * (z + 1) if z + 1 < len(pages) else 0
        out.append(struct.pack("<H", n_tags) + b"".join(
            struct.pack("<HHI", tag, typ, 1)
            + (struct.pack("<HH", v, 0) if typ == _SHORT else struct.pack("<I", v))
            for tag, typ, v in tags) + struct.pack("<I", nxt))
    return b"".join(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_bytes(array, name: str = "<png>") -> bytes:
    """8- or 16-bit grey PNG of an (H, W) image, or an animated PNG of a
    (Z, H, W) stack or a list of pages (module docstring; 8-bit pages
    among 16-bit ones are widened)."""
    pages = _pages(array, name)
    if any(p.dtype == np.float32 for p in pages):
        raise ValueError(f"{name}: float32 has no PNG form; write it as TIFF")
    pages = np.stack([np.clip(p, 0, 65535).astype(np.uint16) if p.dtype == np.int32 else p
                      for p in pages])
    depth = 8 if pages.dtype == np.uint8 else 16
    z, h, w = pages.shape
    rows = np.ascontiguousarray(pages, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    rows = rows.reshape(z, h, -1)
    filt = np.zeros((h, 1), np.uint8)  # filter 0 on every row
    data = [zlib.compress(np.concatenate([filt, rows[i]], axis=1).tobytes(), 6)
            for i in range(z)]
    out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                             0, 0, 0, 0))]
    if z == 1:
        out.append(_chunk(b"IDAT", data[0]))
    else:
        out.append(_chunk(b"acTL", struct.pack(">II", z, 0)))
        seq = 0
        for i, body in enumerate(data):
            # the whole canvas, shown for 0/1 s, dispose NONE, blend SOURCE
            out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 0, 1, 0, 0)))
            seq += 1
            if i == 0:
                out.append(_chunk(b"IDAT", body))
            else:
                out.append(_chunk(b"fdAT", struct.pack(">I", seq) + body))
                seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def imwrite(path: str, array) -> str:
    """Write ``array`` at ``path`` as PNG or TIFF by its extension (module
    docstring); returns ``path``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = png_bytes(array, path)
    elif ext in (".tif", ".tiff"):
        data = tiff_bytes(array, path)
    else:
        raise ValueError(f"{path}: format {ext or '(no extension)'!r} is not written; the "
                         "port writes .png, .tif and .tiff (and .npy through numpy)")
    with open(path, "wb") as f:
        f.write(data)
    return path
