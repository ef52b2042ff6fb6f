"""Writers of DDS, BLP, FTEX and GBR files in numpy, for the tests of
``data/textures.py`` and for ``chip_smoke.py``'s phase 24 (the card's
machine has no PIL): the formats' headers around given data, seeded
random BC1-BC7 blocks that reach every mode of BC6H and BC7, and a simple
encoder of BC1-BC5 blocks (each block's extremes as its endpoints, each
pixel the nearest of their levels)."""

import struct

import numpy as np

# bytes a block of BC1 ... BC7
BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}
# the first byte's low 5 bits of each BC6H mode, the 14 of the
# specification and its 4 reserved ones
BC6H_MODES = (0x00, 0x01, 0x02, 0x06, 0x0A, 0x0E, 0x12, 0x16, 0x1A, 0x1E, 0x03, 0x07, 0x0B,
              0x0F, 0x13, 0x17, 0x1B, 0x1F)


def dds_bytes(w, h, body, flags=0x4, fourcc=b"DX10", bitcount=0, masks=(0, 0, 0, 0),
              dxgi=None, mipmaps=0, header_size=124):
    """A DDS file: the 124-byte header (pixel format ``flags``, ``fourcc``,
    ``bitcount`` and RGBA ``masks``), the DX10 header where ``dxgi`` is
    given, then ``body`` (every surface, the first first)."""
    code = struct.unpack("<I", fourcc)[0] if fourcc else 0
    head = b"DDS " + struct.pack("<7I", header_size, 0x1007 | (0x20000 if mipmaps else 0), h, w,
                                 0, 0, mipmaps) + bytes(44)
    head += struct.pack("<4I", 32, flags, code, bitcount) + struct.pack("<4I", *masks)
    head += struct.pack("<5I", 0x1000 | (0x400008 if mipmaps else 0), 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + bytes(body)


def random_blocks(fmt, n, seed):
    """``n`` seeded random blocks of BC``fmt``; of BC6H and BC7 the first
    blocks set to each mode in turn (reserved ones included), so that any
    ``n`` >= 18 reaches them all."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, BLOCK_BYTES[fmt]), dtype=np.uint8)
    if fmt == 6:
        for k, mode in enumerate(BC6H_MODES[:n]):
            blocks[k, 0] = (blocks[k, 0] & 0xE0) | mode
    elif fmt == 7:
        for k in range(min(n, 9)):  # mode m: m zero bits, then a one; 8: none
            blocks[k, 0] = 0 if k == 8 else ((blocks[k, 0] | 1) << k) & 0xFF
    return blocks


def bc6h_mode(block) -> int:
    """The low 5 bits that name a BC6H block's mode (2 bits for modes 1
    and 2)."""
    m = int(block[0]) & 0x1F
    return m & 3 if m & 3 < 2 else m


def bc7_mode(block) -> int:
    """A BC7 block's mode: its first set bit, 8 (reserved) for none."""
    b = int(block[0])
    return (b & -b).bit_length() - 1 if b else 8


def _tiles(img):
    """(block rows, blocks a row, 16, C) of ``img`` (H, W, C), its edges
    repeated out to whole blocks."""
    h, w, c = img.shape
    bh, bw = -(-h // 4), -(-w // 4)
    pad = np.pad(img, ((0, 4 * bh - h), (0, 4 * bw - w), (0, 0)), mode="edge")
    return pad.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh, bw, 16, c)


def _alpha_block(t):
    """BC4 blocks of (..., 16) uint8 values: max and min as a0 > a1 (eight
    levels), each value the nearest level; a flat block all index 0."""
    t = t.astype(np.int32)
    a0, a1 = t.max(-1), t.min(-1)
    levels = np.stack([a0, a1] + [((7 - k) * a0 + k * a1) // 7 for k in range(1, 7)], -1)
    idx = np.abs(t[..., :, None] - levels[..., None, :]).argmin(-1)
    idx = np.where((a0 == a1)[..., None], 0, idx).astype(np.uint64)
    bits = (idx << (3 * np.arange(16, dtype=np.uint64))).sum(-1, dtype=np.uint64)
    out = np.zeros(t.shape[:-1] + (8,), np.uint8)
    out[..., 0], out[..., 1] = a0, a1
    for k in range(6):
        out[..., 2 + k] = (bits >> np.uint64(8 * k)) & np.uint64(255)
    return out


def _colour_block(t):
    """BC1 colour blocks of (..., 16, 3) uint8 RGB: the brightest and the
    darkest pixel as 5-6-5 c0 >= c1 (four colours where they differ), each
    pixel the nearest of the four."""
    t = t.astype(np.int32)
    lum = t @ np.array([2, 3, 1])
    hi = np.take_along_axis(t, lum.argmax(-1)[..., None, None], -2)[..., 0, :]
    lo = np.take_along_axis(t, lum.argmin(-1)[..., None, None], -2)[..., 0, :]

    def c565(c):
        return (c[..., 0] >> 3 << 11) | (c[..., 1] >> 2 << 5) | (c[..., 2] >> 3)
    c0, c1 = c565(hi), c565(lo)
    c0, c1 = np.maximum(c0, c1), np.minimum(c0, c1)

    def rgb(c):
        r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
        return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)], -1)
    p0, p1 = rgb(c0), rgb(c1)
    pal = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], -2)
    d = ((t[..., :, None, :] - pal[..., None, :, :]) ** 2).sum(-1)
    idx = np.where((c0 == c1)[..., None], 0, d.argmin(-1)).astype(np.uint64)
    bits = (idx << (2 * np.arange(16, dtype=np.uint64))).sum(-1, dtype=np.uint64)
    out = np.zeros(t.shape[:-2] + (8,), np.uint8)
    for k, v in enumerate((c0 & 255, c0 >> 8, c1 & 255, c1 >> 8)):
        out[..., k] = v
    for k in range(4):
        out[..., 4 + k] = (bits >> np.uint64(8 * k)) & np.uint64(255)
    return out


def bc_encode(img, fmt):
    """The blocks, in raster order, of ``img`` as BC``fmt`` (1-5): (H, W)
    grey or (H, W, C) uint8; BC1-BC3 from RGB (grey repeated) and alpha
    (255 without), BC4 from channel 0, BC5 from channels 0 and 1."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    t = _tiles(img)
    if fmt == 4:
        return _alpha_block(t[..., 0]).tobytes()
    if fmt == 5:
        return np.concatenate([_alpha_block(t[..., 0]),
                               _alpha_block(t[..., min(1, t.shape[-1] - 1)])], -1).tobytes()
    rgb = t[..., :3] if t.shape[-1] >= 3 else np.repeat(t[..., :1], 3, -1)
    colour = _colour_block(rgb)
    alpha = t[..., 3] if t.shape[-1] == 4 else np.full(t.shape[:-1], 255, np.uint8)
    if fmt == 1:
        return colour.tobytes()
    if fmt == 2:
        nib = (alpha >> 4).astype(np.uint8)
        packed = nib[..., 0::2] | (nib[..., 1::2] << 4)
        return np.concatenate([packed, colour], -1).tobytes()
    return np.concatenate([_alpha_block(alpha), colour], -1).tobytes()


def blp1_bytes(w, h, mips, compression=1, encoding=5, alpha=0, palette=None, jpeg_header=b""):
    """A BLP1 file: its header, the offsets and lengths of ``mips``, then
    the BGRA ``palette`` (1024 bytes, compression 1) or the JPEG header's
    length and the header (compression 0), then the mips."""
    head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h, encoding, 0)
    middle = (bytes(palette if palette is not None else bytes(1024)) if compression == 1
              else struct.pack("<I", len(jpeg_header)) + jpeg_header)
    at = len(head) + 128 + len(middle)
    offsets, lengths = [], []
    for mip in mips:
        offsets.append(at)
        lengths.append(len(mip))
        at += len(mip)
    pad = [0] * (16 - len(mips))
    return (head + struct.pack("<16I", *offsets, *pad) + struct.pack("<16I", *lengths, *pad)
            + middle + b"".join(mips))


def blp2_bytes(w, h, mips, encoding=2, alpha=0, alpha_encoding=0, palette=None,
               compression=1):
    """A BLP2 file: its header, the offsets and lengths of ``mips``, the
    BGRA ``palette`` (1024 bytes; zeros without one), then the mips."""
    head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding,
                                 len(mips), w, h)
    at = len(head) + 128 + 1024
    offsets, lengths = [], []
    for mip in mips:
        offsets.append(at)
        lengths.append(len(mip))
        at += len(mip)
    pad = [0] * (16 - len(mips))
    return (head + struct.pack("<16I", *offsets, *pad) + struct.pack("<16I", *lengths, *pad)
            + bytes(palette if palette is not None else bytes(1024)) + b"".join(mips))


def ftex_bytes(w, h, fmt, mip, formats=1, size=None):
    """An FTEX file of one mip: the header, then the mip's size (``size``,
    else its length) and the mip."""
    head = b"FTEX" + struct.pack("<iiiiiii", 1, w, h, 1, formats, fmt, 32)
    return head + struct.pack("<i", len(mip) if size is None else size) + bytes(mip)


def gbr_bytes(img, version=2, comment=b"brush\0", magic=b"GIMP", spacing=25):
    """A GIMP brush of ``img``: (H, W) grey (depth 1) or (H, W, 4) RGBA."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else img.shape[2]
    extra = magic + struct.pack(">I", spacing) if version == 2 else b""
    size = 20 + len(extra) + len(comment)
    return struct.pack(">5I", size, version, w, h, depth) + extra + comment + img.tobytes()
