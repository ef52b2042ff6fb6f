"""JPEG 2000, read as the JAX package's two readers read it: PIL
(``Image.open``, its ``Jpeg2KImagePlugin``) and cv2
(``cv2.imread(IMREAD_UNCHANGED)``), both through OpenJPEG.  The codestream
is decoded by the port's host library (``csrc/j2k_decode.cpp``) to the
samples OpenJPEG gives; the JP2 boxes and the rules by which each reader
turns OpenJPEG's components into an array are here.

A file is a JP2 (the 12-byte ``jP`` signature box, ``ftyp``, a ``jp2h``
box holding ``ihdr``, ``colr`` and optionally ``cdef`` and ``res``, then
``jp2c``, whose codestream is read) or a bare codestream (``.j2k``,
``.j2c``: ``FF 4F FF 51``).  Both hold one image: PIL's ``n_frames`` is 1.

``imread`` is PIL's array.  Its mode comes from the headers (``ihdr``'s
components and bit depth, or SIZ's): L (one component of up to 8 bits),
I;16 (one of more), LA, RGB, RGBA, and its size from ``ihdr`` (or SIZ,
less the image offset).  PIL decodes tile by tile and maps each sample
``v`` of a ``p``-bit component (OpenJPEG's tile data: its two's-complement
bits in ``(p + 7) // 8`` bytes) to ``(v + o) << (8 - p)`` for an 8-bit
mode (16 for I;16), kept to the mode's width, where ``o`` is ``2^(p-1)``
for a signed component, and ``2^(p-9)`` more (rounding) where the shift
is negative: so a signed 8-bit component reads as ``v + 128`` and a 16-bit
colour component as ``(v + 128) >> 8``, which wraps to 0 from 65408 up.
PIL refuses a subsampled component in modes L, I;16 and LA; in RGB and
RGBA it places each component's samples as its unpacker indexes them
(``x / dx`` of rows ``w / dx`` long, each component's tile data taken to
start ``w / dx * h / dy`` samples after the one before, so that a tile of
odd size misplaces them), except where the first component is full-size
and the second or third subsampled: that it reads as sYCC, which the port
refuses.

``imread_gray`` is ``_imread_gray``'s array: cv2's, channel 0, where cv2
reads the file: one component as it is, colour as BGR(A), of which channel
0 is blue (component 2); uint16 above 8 bits.  cv2 reads no signed
component, no two-component image, no component subsampled or offset from
the origin (a non-zero image offset), no width or height over 2^20; there
PIL's array is taken, channel 0 (red, or L of LA).

Refused, naming the form: palettes (``pclr``, ``cmap``), ``bpcc``, a
``colr`` box other than enumerated sRGB or greyscale (sYCC, ICC) or that
does not fit the components, a ``cdef`` box that reorders channels, an
``ihdr`` that disagrees with SIZ, precisions other than 8 and 16 bits and
components of different precisions or signs, boxes other than those
above and ``xml`` and ``uuid`` (passed over); and the codestream forms
``csrc/j2k_decode.cpp`` refuses.  A
header may claim a huge image from a few bytes (empty packets code
nothing), so the port bounds what it allocates: an image over 178956970
pixels (``csrc/j2k_decode.cpp``'s ``kMaxPixels``, PIL's
``DecompressionBombError`` limit) is refused from its SIZ marker, before
any buffer of its size, and so is a tile of more packets than bytes
(each packet of a valid stream takes one at least).
"""

from __future__ import annotations

import struct

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.data.imread import _READS, _Raw

__all__ = ["read"]

_CV2_MAX_SIDE = 1 << 20  # cv2's CV_IO_MAX_IMAGE_WIDTH and HEIGHT
SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xff\x4f\xff\x51"
_SRGB, _GREY = 16, 17  # colr enumerated colour spaces
_SKIPPED = (b"xml ", b"uuid")  # boxes both readers pass over


def _boxes(data: bytes, start: int, end: int) -> list:
    """The boxes in data[start:end]: (type, payload start, payload end);
    a box of length 0 runs to ``end``."""
    out, pos = [], start
    while pos < end:
        if end - pos < 8:
            raise ValueError("a box header cut short: the file is cut")
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if end - pos < 16:
                raise ValueError("a box header cut short: the file is cut")
            size, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"a {kind!r} box of {size} bytes past its end: the file is cut "
                             f"or its boxes damaged")
        out.append((kind, pos + head, pos + size))
        pos += size
    return out


def _jp2(data: bytes) -> tuple:
    """(codestream, ihdr's (height, width, components, bpc), the colr
    enumerated colour space) of a JP2 file, its boxes checked."""
    boxes = _boxes(data, 0, len(data))
    if boxes[0][0] != b"jP  " or data[boxes[0][1]:boxes[0][2]] != b"\r\n\x87\n":
        raise ValueError("a JP2 file without its signature box")
    if len(boxes) < 2 or boxes[1][0] != b"ftyp" or (boxes[1][2] - boxes[1][1]) % 4 \
            or boxes[1][2] - boxes[1][1] < 8:
        raise ValueError("a JP2 file whose second box is not a file-type box")
    ihdr = colr = codestream = None
    cdef = None
    for kind, start, end in boxes[2:]:
        if kind == b"jp2h":
            if ihdr is not None:
                raise ValueError("a second JP2 header box")
            inner = _boxes(data, start, end)
            if not inner or inner[0][0] != b"ihdr" or inner[0][2] - inner[0][1] != 14:
                raise ValueError("a JP2 header box that does not start with its ihdr box")
            ihdr = struct.unpack_from(">IIHB", data, inner[0][1])
            for sub, s, e in inner[1:]:
                if sub == b"colr":
                    if colr is not None:
                        raise ValueError("a second colr box")
                    if e - s < 3:
                        raise ValueError("a colr box cut short")
                    meth = data[s]
                    if meth != 1:
                        raise ValueError(f"a colr box of method {meth}" + (
                            " (an ICC profile)" if meth in (2, 3) else "") + ", which the port "
                                         "does not read")
                    if e - s != 7:
                        raise ValueError("a colr box of another length than 7")
                    colr = struct.unpack_from(">I", data, s + 3)[0]
                    if colr not in (_SRGB, _GREY):
                        raise ValueError(f"a colr colour space {colr}" + (
                            " (sYCC)" if colr == 18 else "") + ", which the port does not read")
                elif sub == b"cdef":
                    cdef = data[s:e]
                elif sub in (b"pclr", b"cmap"):
                    raise ValueError("a palette (pclr and cmap boxes), which the port does not "
                                     "read")
                elif sub == b"bpcc":
                    raise ValueError("components of their own bit depths (a bpcc box), which the "
                                     "port does not read")
                elif sub != b"res ":
                    raise ValueError(f"a {sub!r} box in the JP2 header, which the port does not "
                                     f"read")
        elif kind == b"jp2c":
            if ihdr is None:
                raise ValueError("a codestream box before the JP2 header box")
            codestream = data[start:end]
            break
        elif kind not in _SKIPPED:
            raise ValueError(f"a {kind!r} box, which the port does not read")
    if codestream is None:
        raise ValueError("a JP2 file without a codestream box: the file is cut")
    if colr is None:
        raise ValueError("a JP2 header without its colr box")
    if cdef is not None:
        _check_cdef(cdef, ihdr[2])
    return codestream, ihdr, colr


def _check_cdef(cdef: bytes, nc: int) -> None:
    """A cdef box that names each channel once, in order: colour channel i
    of association i + 1, or an opacity channel of the whole image (as PIL
    and OpenJPEG write LA and RGBA); any other reorders channels, which PIL
    and cv2 do differently."""
    if len(cdef) < 2 or len(cdef) != 2 + 6 * struct.unpack_from(">H", cdef)[0]:
        raise ValueError("a cdef box of another length than its entries")
    entries = [struct.unpack_from(">HHH", cdef, 2 + 6 * k) for k in range((len(cdef) - 2) // 6)]
    ok = len(entries) == nc and all(
        cn == k and ((typ == 0 and asoc == k + 1) or (typ in (1, 2) and asoc in (0, 65535)))
        for k, (cn, typ, asoc) in enumerate(entries))
    if not ok:
        raise ValueError("a cdef box that reorders or reassigns channels, which the port does "
                         "not read")


def _header(data: bytes) -> tuple:
    """(codestream, its headers from ``native.j2k_info``, PIL's mode) of a
    JP2 file or a codestream, the JP2 boxes held to the codestream (PIL
    takes the mode and size from ``ihdr``, OpenJPEG from SIZ)."""
    jp2 = data[:12] == SIGNATURE
    if jp2:
        codestream, ihdr, colr = _jp2(data)
    elif data[:4] == CODESTREAM:
        codestream, ihdr, colr = data, None, None
    else:
        raise ValueError("not a JP2 file nor a JPEG 2000 codestream")
    if codestream[:4] != CODESTREAM:
        raise ValueError("a codestream box without SOC and SIZ markers")
    head = native.j2k_info(codestream)
    x0, y0, x1, y1 = head["area"]
    comps = head["comps"]
    precs = {(c["prec"], c["sgnd"]) for c in comps}
    if len(precs) > 1:
        raise ValueError(f"components of different precisions or signs {sorted(precs)}, which "
                         f"the port does not read")
    prec, sgnd = precs.pop()
    if prec not in (8, 16):
        raise ValueError(f"{prec}-bit samples, which the port does not read (8 and 16 bits)")
    nc = len(comps)
    if jp2:
        height, width, inc, bpc = ihdr
        if (height, width, inc) != (y1 - y0, x1 - x0, nc) or bpc != ((prec - 1) | sgnd << 7):
            raise ValueError(f"an ihdr box of {width} x {height}, {inc} components of depth "
                             f"{bpc} where the codestream holds {x1 - x0} x {y1 - y0}, {nc} of "
                             f"{prec} bits: its headers disagree")
        if (colr == _GREY) != (nc <= 2):
            raise ValueError(f"a colr {'greyscale' if colr == _GREY else 'sRGB'} colour space "
                             f"for {nc} components")
    mode = {1: "I;16" if prec > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
    return codestream, head, mode


def _map(planes: list, comps: list, bits: int) -> list:
    """PIL's j2ku_shift of each component into a mode of ``bits`` bits."""
    out = []
    for plane, c in zip(planes, comps):
        prec = c["prec"]
        shift = bits - prec
        offset = 1 << (prec - 1) if c["sgnd"] else 0
        if shift < 0:
            offset += 1 << (-shift - 1)
        v = plane.astype(np.uint32) + offset
        v = v >> -shift if shift < 0 else v << shift
        out.append((v & ((1 << bits) - 1)).astype(np.uint8 if bits == 8 else np.uint16))
    return out


def _pil_unpack(planes: list, head: dict, mode: str) -> np.ndarray:
    """PIL's array: each tile unpacked as its unpacker does."""
    comps = head["comps"]
    mapped = _map(planes, comps, 16 if mode == "I;16" else 8)
    x0, y0, x1, y1 = head["area"]
    if all(c["dx"] == 1 and c["dy"] == 1 for c in comps):
        return mapped[0] if len(mapped) == 1 else np.stack(mapped, -1)
    if mode not in ("RGB", "RGBA"):
        raise ValueError(f"a subsampled component in mode {mode}, which PIL's unpacker does "
                         f"not place")
    if (comps[0]["dx"], comps[0]["dy"]) == (1, 1) and any(
            (c["dx"], c["dy"]) != (1, 1) for c in comps[1:3]):
        raise ValueError("chroma components subsampled under a full-size first component, "
                         "which PIL reads as sYCC")
    # tile by tile: each component's tile data one after another, indexed as
    # PIL's unpacker does (rows w // dx long, each after w // dx * h // dy)
    out = np.zeros((y1 - y0, x1 - x0, len(comps)), np.uint8)
    gx0, gy0, tdx, tdy, across, down = head["tiles"]
    for q in range(down):
        for p in range(across):
            tx0, ty0 = max(gx0 + p * tdx, x0), max(gy0 + q * tdy, y0)
            tx1, ty1 = min(gx0 + (p + 1) * tdx, x1), min(gy0 + (q + 1) * tdy, y1)
            w, h = tx1 - tx0, ty1 - ty0
            tiles = []
            for plane, c in zip(mapped, comps):
                ax, ay = c["area"][:2]
                tiles.append(plane[-(-ty0 // c["dy"]) - ay:-(-ty1 // c["dy"]) - ay,
                                   -(-tx0 // c["dx"]) - ax:-(-tx1 // c["dx"]) - ax].ravel())
            buf, base = np.concatenate(tiles), 0
            for n, c in enumerate(comps):
                row = w // c["dx"]
                idx = base + (np.arange(h) // c["dy"])[:, None] * row + (np.arange(w)
                                                                        // c["dx"])[None, :]
                out[ty0 - y0:ty1 - y0, tx0 - x0:tx1 - x0, n] = buf[idx]
                base += row * (h // c["dy"])
    return out if mode == "RGBA" else out[..., :3]


def _cv2_channel(head: dict):
    """The component cv2's channel 0 holds (blue: 2 of a colour image), or
    None where cv2 reads nothing."""
    comps = head["comps"]
    x0, y0, x1, y1 = head["area"]
    if any(c["sgnd"] for c in comps) or len(comps) == 2:
        return None
    if x1 - x0 > _CV2_MAX_SIDE or y1 - y0 > _CV2_MAX_SIDE:
        return None
    if any((c["dx"], c["dy"], c["area"][0], c["area"][1]) != (1, 1, 0, 0) for c in comps):
        return None
    return 2 if len(comps) >= 3 else 0


def read(data: bytes, name: str, first_only: bool = False) -> list:
    """The image of the JPEG 2000 file ``name`` (its bytes ``data``) as a
    ``_Raw``: PIL's array and cv2's channel 0 (``first_only`` changes
    nothing: the format holds one image)."""
    where = f"{name}: JPEG 2000"
    try:
        codestream, head, mode = _header(data)
        planes = native.j2k_decode(codestream)
    except ValueError as exc:
        raise ValueError(f"{where}: {exc}; {_READS}") from None

    def pil():
        try:
            return _pil_unpack(planes, head, mode)
        except ValueError as exc:
            raise ValueError(f"{where}: {exc}; {_READS}") from None

    channel = _cv2_channel(head)
    return [_Raw(None, "grey" if len(planes) == 1 else "rgba", head["comps"][0]["prec"], where,
                 cv2_reads=channel is not None, pil=pil, gray=lambda: planes[channel].copy())]
