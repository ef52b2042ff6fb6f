"""The texture and brush formats of PIL's plugins that the JAX package reads
through ``Image.open``: DDS, BLP, FTEX and GBR, parsed as PIL 12.1's
plugins parse them; their BC1-BC7 blocks are decoded by the port's host
library (``csrc/bcn_decode.cpp``), BLP1's JPEG by ``csrc/jpeg_decode.cpp``.
``data/raster.py`` identifies each file by PIL's plugin order and calls
``READERS[format](data, name, first_only)``, which gives
``data/imread.py``'s ``_Raw`` of the image.  cv2 reads none of them, so
``imread_gray`` (the JAX package's ``_imread_gray``) is PIL's array,
channel 0, and ``imread`` PIL's array.

DDS (``DdsImagePlugin``): the 124-byte header; the first surface alone
(mipmaps, cube faces and array slices after it are not read).  By the
pixel format's flags, in PIL's order: ``DDPF_RGB`` (RGB, or RGBA with
``DDPF_ALPHAPIXELS``): pixels of bit count / 8 bytes, little-endian, each
sample its mask's bits scaled to 8 bits by ``int(v / max * 255)``, a file
cut short read as zeros (PIL's ``DdsRgbDecoder``); ``DDPF_LUMINANCE`` of 8
bits (L) or of 16 with alpha (LA); ``DDPF_PALETTEINDEXED8`` (P: the
indices after a 1024-byte palette); ``DDPF_FOURCC``: DXT1, DXT3, DXT5
(RGBA), BC4U and ATI1 (L), BC5U and ATI2 (RGB; blue 0), BC5S (RGB; each
signed sample + 128, blue 128), or DX10 with a DXGI format of BC1, BC2,
BC3 (typeless or UNORM: RGBA), BC4 (L), BC5 (RGB), BC5_SNORM, BC6H_UF16,
BC6H_SF16 (RGB), BC7 (typeless, UNORM or SRGB: RGBA) or R8G8B8A8
(typeless, UNORM or SRGB: RGBA, raw).  Blocks past the image's right or
bottom edge are cut.  Other formats, bit counts, header sizes, and
surfaces the file holds too few bytes of, are refused, as PIL refuses
them.

BLP (``BlpImagePlugin``): RGBA where the header's alpha is set, else RGB.
BLP1 JPEG: the shared header joined to the first mip's data, a JPEG opened
and decoded as PIL opens and decodes a ``.jpg`` (a 4-component one with
its planes as stored, the CMYK source that PIL's patch of its tile sets,
inverted as PIL's ``CMYK;I`` and converted to RGB by PIL's ``cmyk2rgb``),
its RGB bytes read as BGR into an image of the BLP's size; BLP1 palette
(encodings 4 and 5) and BLP2 palette (encoding 1): a BGRA palette of 256
entries and one index a pixel (BLP1's right after the
palette, BLP2's at the first mip's offset); BLP2 DXT1, DXT3 and DXT5 (its
alpha encodings 0, 1 and 7) decoded by ``BlpImagePlugin``'s Python rule
(``bcn_decode``'s "blp": 5-6-5 colours with their low bits 0), every
block whole and the bytes read as rows of the image's width, as PIL's
``set_as_raw`` reads them (a width that is not a multiple of 4 shears the
rows; DXT3 and DXT5 without alpha give RGBA bytes read as RGB).  Other
compressions, encodings and alpha encodings, and a file cut short, are
refused, as PIL refuses them.

FTEX (``FtexImagePlugin``): one format a file; format 0 is BC1 (RGBA, PIL's
C rule), format 1 raw RGB; the mip's size as its header says (a negative
one reads to the file's end).

GBR (``GbrImagePlugin``): version 1, or 2 with its ``GIMP`` magic; colour
depth 1 (L) or 4 (RGBA); the samples at the header's length.

Every size of 0 is refused, as PIL refuses it, and PIL's
decompression-bomb limit holds; damaged data raises and names the file.
"""

from __future__ import annotations

import struct

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.data.imread import _PIL_PIXELS, _READS, _Raw, _pil_jpeg_open

__all__ = ["READERS"]

# DDS pixel format flags (DDPF)
_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FOURCC -> (BCn, signed)
_FOURCCS = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False), b"BC4U": (4, False),
            b"ATI1": (4, False), b"BC5S": (5, True), b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (BCn, signed); 0 for R8G8B8A8
_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False), 76: (3, False),
         77: (3, False), 79: (4, False), 80: (4, False), 82: (5, False), 83: (5, False),
         84: (5, True), 95: (6, False), 96: (6, True), 97: (7, False), 98: (7, False),
         99: (7, False), 27: (0, False), 28: (0, False), 29: (0, False)}
_KINDS = {1: "grey", 2: "grey_alpha", 3: "rgb", 4: "rgba"}


def _refuse(where: str, why: str):
    raise ValueError(f"{where}: {why}; {_READS}")


def _size(where: str, w: int, h: int) -> None:
    """PIL's checks of an image's size: none of 0 (or less), and no more
    pixels than its decompression-bomb limit."""
    if w <= 0 or h <= 0:
        _refuse(where, f"a size of {w} x {h}, which PIL does not open")
    if w * h > _PIL_PIXELS:
        _refuse(where, f"{w} x {h} pixels, over PIL's decompression-bomb limit")


def _chunk(data: bytes, at: int, n: int, where: str) -> np.ndarray:
    """``n`` bytes of ``data`` from ``at``; a file cut short raises (PIL:
    the image file is truncated, or Truncated File Read)."""
    if at < 0 or at + n > len(data):
        _refuse(where, f"a file cut short ({max(0, len(data) - at)} of {n} bytes from {at})")
    return np.frombuffer(data, np.uint8, n, at)


def _raw(data: bytes, at: int, w: int, h: int, channels: int, where: str) -> np.ndarray:
    """(h, w, channels) bytes of ``data`` from ``at``."""
    return _chunk(data, at, w * h * channels, where).reshape(h, w, channels)


def _image(px: np.ndarray, where: str) -> list:
    """One image of PIL's mode as ``_Raw`` (a palette's indices as they
    are)."""
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[..., 0]
    kind = _KINDS[1 if px.ndim == 2 else px.shape[2]]
    return [_Raw(np.ascontiguousarray(px), kind, 8, where, cv2_reads=False)]


def _bcn(data: bytes, at: int, fmt: int, w: int, h: int, signed: bool, where: str,
         rule: str = "pil"):
    """The surface of BC``fmt`` blocks at ``at`` (``native.bcn_decode``)."""
    blocks = _chunk(data, at, -(-w // 4) * -(-h // 4) * native.bcn_layout(fmt)[0], where)
    return native.bcn_decode(blocks, fmt, w, h, signed, rule)


# ----- DDS ---------------------------------------------------------------------


def _mask_samples(values: np.ndarray, mask: int) -> np.ndarray:
    """PIL's ``DdsRgbDecoder`` of one mask: the masked bits shifted down
    and scaled to 8 bits, ``int(v / max * 255)`` in double."""
    if not mask:
        return np.zeros(values.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    v = (values & np.uint32(mask)) >> np.uint32(shift)
    return (v.astype(np.float64) / (mask >> shift) * 255).astype(np.uint8)


def _dds_rgb(data: bytes, w: int, h: int, bitcount: int, masks, where: str) -> np.ndarray:
    """PIL's ``DdsRgbDecoder``: pixel p the ``bitcount // 8`` bytes from
    128 + p * that, little-endian, those past the file's end 0 (the reads
    come back empty); the masks see the low 32 bits, so only the low four
    bytes of a pixel are read, whatever its bit count."""
    width = bitcount // 8
    values = np.zeros(w * h, np.uint32)
    body = np.frombuffer(data, np.uint8, offset=128)
    for k in range(min(width, 4)):
        low = body[k::width][:values.size]  # byte k of each pixel inside the file
        values[:low.size] |= low.astype(np.uint32) << np.uint32(8 * k)
    return np.stack([_mask_samples(values, m) for m in masks], -1).reshape(h, w, len(masks))


def _dds(data: bytes, name: str, first_only: bool = False) -> list:
    where = f"{name}: DDS"
    if len(data) < 8 or struct.unpack_from("<I", data, 4)[0] != 124:
        _refuse(where, "a header size other than 124, which PIL does not open")
    if len(data) < 128:
        _refuse(where, f"an incomplete header ({len(data) - 8} of 124 bytes)")
    _, h, w = struct.unpack_from("<3I", data, 8)
    _, flags, fourcc, bitcount = struct.unpack_from("<4I", data, 76)
    _size(where, w, h)
    if flags & _RGB:
        masks = struct.unpack_from("<4I" if flags & _ALPHAPIXELS else "<3I", data, 92)
        return _image(_dds_rgb(data, w, h, bitcount, masks, where), where)
    if flags & _LUMINANCE:
        if bitcount == 8:
            return _image(_raw(data, 128, w, h, 1, where), where)
        if bitcount == 16 and flags & _ALPHAPIXELS:
            return _image(_raw(data, 128, w, h, 2, where), where)
        _refuse(where, f"luminance of {bitcount} bits (flags {flags:#x}), which PIL does not "
                       "open")
    if flags & _PALETTEINDEXED8:  # P: PIL's array holds the indices
        return [_Raw(_raw(data, 128 + 1024, w, h, 1, where)[..., 0].copy(), "palette", 8, where,
                     cv2_reads=False)]
    if not flags & _FOURCC:
        _refuse(where, f"pixel format flags {flags:#x}, which PIL does not open")
    code = struct.pack("<I", fourcc)
    if code == b"DX10":
        if len(data) < 148:
            _refuse(where, "a DX10 header cut short, which PIL does not open")
        dxgi = struct.unpack_from("<I", data, 128)[0]
        if dxgi not in _DXGI:
            _refuse(where, f"DXGI format {dxgi}, which PIL does not read")
        fmt, signed = _DXGI[dxgi]
        if not fmt:  # R8G8B8A8
            return _image(_raw(data, 148, w, h, 4, where), where)
        return _image(_bcn(data, 148, fmt, w, h, signed, where), where)
    if code not in _FOURCCS:
        _refuse(where, f"pixel format {code!r}, which PIL does not read")
    fmt, signed = _FOURCCS[code]
    return _image(_bcn(data, 128, fmt, w, h, signed, where), where)


# ----- BLP ---------------------------------------------------------------------


def _blp_palette(data: bytes, at: int, indices: np.ndarray, w: int, h: int, alpha: bool,
                 where: str) -> np.ndarray:
    """PIL's ``_read_bgra``: the BGRA palette at ``at`` looked up, RGB(A)."""
    bgra = _chunk(data, at, 1024, where).reshape(256, 4)
    rgba = bgra[:, [2, 1, 0, 3] if alpha else [2, 1, 0]]
    if indices.size < w * h:
        _refuse(where, f"{indices.size} indices for {w * h} pixels (PIL: not enough image data)")
    return rgba[indices[:w * h]].reshape(h, w, -1)


def _blp1_jpeg(data: bytes, offset: int, length: int, w: int, h: int, alpha: bool,
               where: str) -> np.ndarray:
    size = struct.unpack("<I", _chunk(data, 156, 4, where).tobytes())[0]
    header = _chunk(data, 160, size, where).tobytes()
    at = max(offset, 160 + size)
    jpeg = header + _chunk(data, at, length, where).tobytes()
    _pil_jpeg_open(jpeg, f"{where} JPEG")
    try:
        px = native.jpeg_decode(jpeg, source="pil", cmyk=True)
    except ValueError as exc:
        raise ValueError(f"{where} JPEG: {exc}; {_READS}") from None
    if px.shape[2] == 1:  # L -> RGB
        px = np.repeat(px, 3, axis=2)
    elif px.shape[2] == 4:  # CMYK;I (inverted), then PIL's cmyk2rgb
        cmyk = 255 - px.astype(np.int32)
        nk = 255 - cmyk[..., 3:]
        t = cmyk[..., :3] * nk + 128
        px = (nk - (((t >> 8) + t) >> 8)).clip(0, 255).astype(np.uint8)
    flat = px.reshape(-1)
    if flat.size < w * h * 3:
        _refuse(where, f"a JPEG of {px.shape[1]} x {px.shape[0]} for a {w} x {h} image "
                       "(PIL: not enough image data)")
    rgb = flat[:w * h * 3].reshape(h, w, 3)[..., ::-1]  # set_as_raw(..., "BGR")
    if alpha:
        rgb = np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
    return rgb


def _blp(data: bytes, name: str, first_only: bool = False) -> list:
    where = f"{name}: BLP"
    blp1 = data[:4] == b"BLP1"
    if len(data) < (28 if blp1 else 20):
        _refuse(where, "a header cut short, which PIL does not open")
    compression = struct.unpack_from("<i", data, 4)[0]
    if blp1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        w, h, encoding = struct.unpack_from("<IIi", data, 12)
        table = 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        w, h = struct.unpack_from("<II", data, 12)
        table = 20
    _size(where, w, h)
    offsets = struct.unpack("<16I", _chunk(data, table, 64, where).tobytes())
    lengths = struct.unpack("<16I", _chunk(data, table + 64, 64, where).tobytes())
    if blp1:
        if compression == 0:
            return _image(_blp1_jpeg(data, offsets[0], lengths[0], w, h, alpha, where), where)
        if compression != 1 or encoding not in (4, 5):
            _refuse(where, f"BLP1 compression {compression}, encoding {encoding}, which PIL "
                           "does not read")
        indices = _chunk(data, 156 + 1024, lengths[0], where)
        return _image(_blp_palette(data, 156, indices, w, h, alpha, where), where)
    _chunk(data, 148, 1024, where)  # PIL reads the palette first, whatever the encoding
    if compression != 1 or encoding not in (1, 2):
        _refuse(where, f"BLP2 compression {compression}, encoding {encoding} (PIL: Unknown "
                       "BLP encoding)")
    if encoding == 1:
        indices = _chunk(data, offsets[0], lengths[0], where)
        return _image(_blp_palette(data, 148, indices, w, h, alpha, where), where)
    fmt = {0: 1, 1: 2, 7: 3}.get(alpha_encoding)
    if fmt is None:
        _refuse(where, f"BLP2 alpha encoding {alpha_encoding} (PIL: Unsupported alpha "
                       "encoding)")
    px = _bcn(data, offsets[0], fmt, w, h, False, where, rule="blp")
    if fmt == 1 and not alpha:  # decode_dxt1 without alpha writes RGB
        px = px[..., :3]
    c = 4 if alpha else 3  # set_as_raw: the bytes as rows of the image's width
    return _image(px.reshape(-1)[:w * h * c].reshape(h, w, c), where)


# ----- FTEX --------------------------------------------------------------------


def _ftex(data: bytes, name: str, first_only: bool = False) -> list:
    where = f"{name}: FTEX"
    if len(data) < 32:
        _refuse(where, "a header cut short, which PIL does not open")
    w, h, _, count, fmt, at = struct.unpack_from("<6i", data, 8)
    if count != 1:
        _refuse(where, f"{count} formats (PIL asserts one)")
    if at < 0 or at + 4 > len(data):
        _refuse(where, f"a mip at byte {at}, outside the file, which PIL does not open")
    _size(where, w, h)
    size = struct.unpack_from("<i", data, at)[0]
    mip = data[at + 4:] if size < 0 else data[at + 4:at + 4 + size]
    if fmt == 0:
        return _image(_bcn(mip, 0, 1, w, h, False, where), where)
    if fmt == 1:
        return _image(_raw(mip, 0, w, h, 3, where), where)
    _refuse(where, f"texture compression format {fmt}, which PIL does not read")


# ----- GBR ---------------------------------------------------------------------


def _gbr(data: bytes, name: str, first_only: bool = False) -> list:
    where = f"{name}: GBR"
    if len(data) < 20:
        _refuse(where, "a header cut short, which PIL does not open")
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or depth not in (1, 4):
        _refuse(where, f"a header of {size} bytes, version {version}, colour depth {depth}, "
                       "which PIL does not open")
    if version == 2 and data[20:24] != b"GIMP":
        _refuse(where, "a version 2 brush without its GIMP magic, which PIL does not open")
    _size(where, w, h)
    # a comment PIL reads with a negative length takes the rest of the file
    at = size if size >= (28 if version == 2 else 20) else len(data)
    return _image(_raw(data, at, w, h, depth, where), where)


READERS = {"DDS": _dds, "BLP": _blp, "FTEX": _ftex, "GBR": _gbr}
