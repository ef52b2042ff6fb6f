"""A seeded baseline JPEG writer in numpy, for the port's JPEG tests and
for phases 18, 22 and 23 of chip_smoke.py (whose machine has no PIL): 8-bit
grey images, and three-component ones (each component 1 x 1, with the
luminance tables), the standard quantisation table scaled to a quality as
the IJG library scales it, the separable 8 x 8 DCT, the standard
Huffman tables (ITU T.81 Annex K), and the Huffman coding of every block
at once (symbols, then their bits, in vectors).

``jpeg_bytes(pixels, quality)`` is a whole ``.jpg`` (JFIF: three
components are Y, Cb and Cr to a decoder); with ``tables=False`` it is an
abbreviated stream without DQT and DHT, whose tables
``jpeg_tables(quality)`` holds: the form of a JPEG strip or tile of a TIFF
(compression 7) and of its JPEGTables tag; with ``progressive=True`` a
progressive file of spectral selection alone.  ``patched_dqt`` rewrites a
file's quantisation tables (the out-of-range coefficients of C15)."""

import struct

import numpy as np

# the standard luminance quantisation table (T.81 K.1), natural order
_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
# the standard luminance Huffman tables (T.81 K.3): code counts by length, values
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
    0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
    0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]
# zigzag position -> natural (row-major) index
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, (i % 8 if (i // 8 + i % 8) % 2 == 0 else i // 8))), np.int64)


def _codes(bits, vals):
    """Canonical Huffman codes: (code, length) arrays indexed by value."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


_DC_CODE, _DC_LEN = _codes(_DC_BITS, _DC_VALS)
_AC_CODE, _AC_LEN = _codes(_AC_BITS, _AC_VALS)
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def quant_table(quality: int) -> np.ndarray:
    """The standard table scaled to ``quality`` (1-100) as the IJG library
    scales it, limited to 1..255 (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_QUANT * scale + 50) // 100, 1, 255)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def jpeg_tables(quality: int) -> bytes:
    """SOI, the DQT of ``quality`` and the two DHTs, EOI: a TIFF's
    JPEGTables."""
    dqt = _segment(0xDB, bytes([0]) + bytes(quant_table(quality)[_ZIGZAG].tolist()))
    dht = _segment(0xC4, bytes([0x00] + _DC_BITS + _DC_VALS)
                   + bytes([0x10] + _AC_BITS + _AC_VALS))
    return b"\xff\xd8" + dqt + dht + b"\xff\xd9"


def _size(v):
    """Bits of the magnitude category of each value (0 for 0)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _scan(planes: np.ndarray, quality: int, part=None) -> bytes:
    """The entropy-coded data of an (H, W, C) image, its C components'
    blocks interleaved a block each (bytes stuffed, padded with one
    bits); ``part`` "dc" keeps the DC codes alone (a progressive DC scan),
    an int ``ci`` the AC codes of component ci's blocks alone (its
    progressive AC scan of coefficients 1-63)."""
    h, w, c = planes.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    px = np.empty((ph, pw, c), np.float64)
    px[:h, :w] = planes
    px[h:, :w] = px[h - 1:h, :w]  # pad by replicating the edge, as encoders do
    px[:, w:] = px[:, w - 1:w]
    # (block, component, 8, 8): the blocks in the scan's order
    blocks = (px - 128).reshape(ph // 8, 8, pw // 8, 8, c).transpose(0, 2, 4, 1, 3).reshape(
        -1, 8, 8)
    # the separable DCT, each sum taken term by term (elementwise products
    # and sums round the same on every machine, as a BLAS product need not)
    rows = sum(blocks[:, :, y, None] * _DCT[:, y] for y in range(8))
    coef = sum(_DCT[:, x, None] * rows[:, x, None, :] for x in range(8)).reshape(-1, 64)
    q = np.rint(coef / quant_table(quality)).astype(np.int64)[:, _ZIGZAG]
    n = len(q)
    # one entry per code: (sort key, code bits, length); a Huffman code and
    # its value's bits make one entry; each component predicts its DC from
    # its own previous block
    dc = np.diff(q[:, 0].reshape(-1, c), axis=0, prepend=0).reshape(-1)
    s = _size(dc)
    keys = [np.arange(n) * 256]
    codes = [(_DC_CODE[s] << s) | (np.where(dc < 0, dc + (1 << s) - 1, dc) & ((1 << s) - 1))]
    lens = [_DC_LEN[s] + s]
    b, k = np.nonzero(q[:, 1:])
    k = k + 1
    v = q[b, k]
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    s = _size(v)
    sym = (run % 16) << 4 | s
    keys.append(b * 256 + 4 * k + 1)
    codes.append((_AC_CODE[sym] << s) | (np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)))
    lens.append(_AC_LEN[sym] + s)
    zrl = np.repeat(np.arange(len(b)), run // 16)  # a 16-zero run code each
    keys.append(b[zrl] * 256 + 4 * k[zrl])
    codes.append(np.full(len(zrl), _AC_CODE[0xF0]))
    lens.append(np.full(len(zrl), _AC_LEN[0xF0]))
    last = np.full(n, 0)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 256 + 255)
    codes.append(np.full(len(eob), _AC_CODE[0]))
    lens.append(np.full(len(eob), _AC_LEN[0]))
    keys = np.concatenate(keys)
    keep = np.ones(len(keys), bool) if part is None else (keys % 256 == 0) if part == "dc" \
        else (keys % 256 != 0) & ((keys // 256) % c == part)
    order = np.argsort(keys[keep], kind="stable")
    codes, lens = np.concatenate(codes)[keep][order], np.concatenate(lens)[keep][order]
    starts = np.cumsum(lens) - lens
    total = int(lens.sum())
    idx = np.repeat(np.arange(len(lens)), lens)
    shift = lens[idx] - 1 - (np.arange(total) - starts[idx])
    bits = ((codes[idx] >> shift) & 1).astype(np.uint8)
    bits = np.r_[bits, np.ones(-total % 8, np.uint8)]
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def jpeg_bytes(pixels: np.ndarray, quality: int = 75, tables: bool = True,
               progressive: bool = False) -> bytes:
    """A baseline JPEG of the (H, W) or (H, W, 3) uint8 image ``pixels``
    at ``quality`` (three components: Y, Cb and Cr as they stand): a JFIF
    file, or (``tables`` False) an abbreviated stream whose tables are
    ``jpeg_tables(quality)``; ``progressive``: a progressive one (SOF2) of
    spectral selection alone, a DC scan of every component, then each
    component's AC scan of coefficients 1-63."""
    pixels = np.asarray(pixels, np.uint8)
    planes = pixels[..., None] if pixels.ndim == 2 else pixels
    h, w, c = planes.shape
    out = b"\xff\xd8"
    if tables:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
        out += jpeg_tables(quality)[2:-2]
    out += _segment(0xC2 if progressive else 0xC0, struct.pack(">BHHB", 8, h, w, c)
                    + b"".join(bytes([k + 1, 0x11, 0]) for k in range(c)))
    if not progressive:
        out += _segment(0xDA, bytes([c]) + b"".join(bytes([k + 1, 0x00]) for k in range(c))
                        + bytes([0, 63, 0]))
        return out + _scan(planes, quality) + b"\xff\xd9"
    out += _segment(0xDA, bytes([c]) + b"".join(bytes([k + 1, 0x00]) for k in range(c))
                    + bytes([0, 0, 0])) + _scan(planes, quality, "dc")
    for k in range(c):
        out += _segment(0xDA, bytes([1, k + 1, 0x00, 1, 63, 0])) + _scan(planes, quality, k)
    return out + b"\xff\xd9"


def patched_dqt(stream: bytes, value: int) -> bytes:
    """``stream`` with every quantisation table's 64 entries set to
    ``value`` (16-bit entries, Pq 1, where it is over 255): on a quality-100
    file (an all-1 table) its dequantised coefficients pass 16 bits."""
    pos, out = 2, bytearray(stream[:2])
    while pos + 4 <= len(stream) and stream[pos + 1] not in (0xDA, 0xD9):
        (n,) = struct.unpack_from(">H", stream, pos + 2)
        seg = stream[pos:pos + 2 + n]
        if seg[1] == 0xDB:
            body, at = bytearray(), 4
            while at < len(seg):
                wide = seg[at] >> 4
                body += bytes([(seg[at] & 15) | (0x10 if value > 255 else 0)])
                body += struct.pack(">64H", *[value] * 64) if value > 255 else bytes([value] * 64)
                at += 1 + 64 * (2 if wide else 1)
            seg = b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
        out += seg
        pos += 2 + n
    return bytes(out + stream[pos:])
