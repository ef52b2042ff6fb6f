"""Writers of the raster formats ``data/raster.py`` reads, for the port's
raster tests and for phase 19 of chip_smoke.py (the card's machine has no
PIL): BMP and DIB (core, info, V4 and V5 headers; palettes, 16-, 24- and
32-bit pixels, bitfields, RLE8 and RLE4), PNM (P1-P6 plain and raw at any
maxval, comments in the header), PFM, PAM, GIF (global and local colour
tables, interlaced frames, transparency, disposal; an LZW encoder of its
own), SPIDER images and stacks in either byte order, TGA (colour-mapped,
true-colour and grey, raw or RLE, either origin) and Sun raster (raw or
byte-encoded, colour maps).  numpy and the standard library only; every
file is a pure function of its arguments."""

import struct

import numpy as np


# ----- BMP ---------------------------------------------------------------------


def _rle_runs(row: np.ndarray):
    """(start, length) of the runs of equal values in ``row``."""
    cuts = np.flatnonzero(np.diff(row.astype(np.int16))) + 1
    starts = np.concatenate([[0], cuts])
    return zip(starts.tolist(), np.diff(np.concatenate([starts, [len(row)]])).tolist())


def bmp_rle_row(row: np.ndarray, rle4: bool) -> bytes:
    """One row of indices as BMP RLE8 (or RLE4) packets, then the end of
    row: runs of 3 or more as repeat packets (at most 255 pixels), the rest
    as absolute packets of 3 to 255 pixels padded to a 16-bit word, or as
    repeat packets of one or two pixels."""
    out, lit = bytearray(), []

    def flush():
        k = 0
        while k < len(lit):
            part = lit[k:k + 254]  # even, so RLE4's nibbles stay paired
            k += len(part)
            if len(part) < 3:
                for v in part:
                    out.extend((1, v << 4 if rle4 else v))
                continue
            if rle4:
                nib = part + [0] * (len(part) & 1)
                body = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
            else:
                body = bytes(part)
            out.extend((0, len(part)))
            out.extend(body + b"\x00" * (len(body) & 1))
        lit.clear()
    for start, length in _rle_runs(row):
        v = int(row[start])
        if length < 3:
            lit.extend([v] * length)
            continue
        flush()
        while length:
            n = min(length, 255)
            out.extend((n, (v << 4 | v) if rle4 else v))
            length -= n
    flush()
    return bytes(out) + b"\x00\x00"


def bmp_bytes(pixels: np.ndarray, bits: int = None, palette=None, header: int = 40,
              compression: int = 0, masks=None, top_down: bool = False, dib: bool = False,
              rle_data: bytes = None) -> bytes:
    """A BMP (a DIB without its file header if ``dib``) of ``pixels``:
    (H, W) indices into ``palette`` ((N, 3) RGB; bits 1, 4 or 8), (H, W)
    uint16 words (bits 16), (H, W, 3) RGB (bits 24) or (H, W, 4) bytes in
    the file's order (bits 32).  ``header`` 12 (OS/2 core), 40, 52, 56,
    108 (V4) or 124 (V5); ``compression`` 0 (BI_RGB), 1 (RLE8), 2 (RLE4)
    or 3 (bitfields, ``masks`` (r, g, b[, a]): after a 40-byte header,
    within a longer one); ``top_down``: a negative height; ``rle_data``:
    the RLE stream as given, for crafted ones."""
    h, w = pixels.shape[:2]
    if bits is None:
        bits = (16 if pixels.dtype == np.uint16 else 8) if pixels.ndim == 2 \
            else 8 * pixels.shape[2]
    pal = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        entry = 3 if header == 12 else 4
        quad = np.zeros((len(palette), entry), np.uint8)
        quad[:, :3] = palette[:, ::-1]
        pal = quad.tobytes()
    rows = pixels[::-1] if not top_down else pixels  # the file's row order
    if compression in (1, 2):
        body = rle_data if rle_data is not None else b"".join(
            bmp_rle_row(r, compression == 2) for r in rows) + b"\x00\x01"
    else:
        stride = ((w * bits + 31) // 32) * 4
        if bits < 8:
            per = 8 // bits
            idx = np.zeros((h, -(-w // per) * per), np.uint8)
            idx[:, :w] = rows
            packed = np.zeros((h, idx.shape[1] // per), np.uint8)
            for k in range(per):
                packed |= idx[:, k::per] << (8 - bits * (k + 1))
            raw = packed
        elif bits == 8:
            raw = rows.astype(np.uint8)
        elif bits == 16:
            raw = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bits == 24:
            raw = rows[..., ::-1].reshape(h, -1)
        else:
            raw = rows.reshape(h, -1)
        out = np.zeros((h, stride), np.uint8)
        out[:, :raw.shape[1]] = raw
        body = out.tobytes()
    after = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(body), 2835, 2835, len(pal) // 4, 0)
        extra = bytearray(header - 40)
        if compression == 3 and masks is not None:
            m = struct.pack(f"<{len(masks)}I", *masks)
            if header == 40:
                after = m[:12]
            else:
                extra[:min(len(m), header - 40)] = m[:header - 40]
        if header >= 108:
            extra[16:20] = b"BGRs"  # LCS_sRGB
        info += bytes(extra)
    head = info + after + pal
    if dib:
        return head + body
    return b"BM" + struct.pack("<IHHI", 14 + len(head) + len(body), 0, 0, 14 + len(head)) \
        + head + body


# ----- PNM, PFM, PAM -----------------------------------------------------------


def pnm_bytes(pixels: np.ndarray, magic: str, maxval: int = 255, comment: bytes = b"") -> bytes:
    """PBM (P1, P4: ``pixels`` 0 white, 1 black), PGM (P2, P5) or PPM (P3,
    P6) of ``pixels`` at ``maxval`` (raw samples of 2 bytes, big-endian,
    above 255); ``comment`` goes in after the magic and again before the
    maxval."""
    h, w = pixels.shape[:2]
    c = b"#" + comment + b"\n" if comment else b""
    head = magic.encode() + b"\n" + c + b"%d %d\n" % (w, h)
    if magic not in ("P1", "P4"):
        head += c + b"%d\n" % maxval
    if magic in ("P1", "P2", "P3"):
        flat = pixels.reshape(h, -1)
        sep = "" if magic == "P1" else " "
        return head + "".join(sep.join(map(str, r.tolist())) + "\n" for r in flat).encode()
    if magic == "P4":
        return head + np.packbits(pixels.astype(np.uint8), axis=1).tobytes()
    return head + pixels.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm_bytes(pixels: np.ndarray, little: bool = True, scale: float = 1.0) -> bytes:
    """A PFM of float32 ``pixels``: (H, W) as ``Pf``, (H, W, 3) RGB as
    ``PF``; rows bottom-up, the scale's sign the byte order."""
    h, w = pixels.shape[:2]
    head = b"%s\n%d %d\n%s\n" % (b"Pf" if pixels.ndim == 2 else b"PF", w, h,
                                 repr(-scale if little else scale).encode())
    return head + pixels[::-1].astype("<f4" if little else ">f4").tobytes()


def pam_bytes(pixels: np.ndarray, maxval: int = 255) -> bytes:
    """A PAM (P7) of (H, W) or (H, W, C) ``pixels``, its tuple type by the
    depth."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else pixels.shape[2]
    tupltype = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB", 4: "RGB_ALPHA"}[depth]
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
            f"TUPLTYPE {tupltype}\nENDHDR\n").encode()
    return head + pixels.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ----- GIF ---------------------------------------------------------------------


def gif_lzw_encode(indices: bytes, min_size: int, clear_when_full: bool = True) -> bytes:
    """GIF LZW of ``indices``: a clear code first, codes of min_size + 1 to
    12 bits, least significant bit first, the width growing when the next
    free entry needs it; when the table fills, a clear code (or none, the
    table frozen, without ``clear_when_full``); the end code last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes, widths = [clear], [min_size + 1]
    table, nxt, width, prefix = {}, end + 1, min_size + 1, -1
    for b in indices:
        if prefix < 0:
            prefix = b
            continue
        key = prefix << 8 | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        prefix = b
        if nxt < 4096:
            table[key] = nxt
            if nxt == (1 << width) and width < 12:
                width += 1
            nxt += 1
            if nxt == 4096 and clear_when_full:
                codes.append(clear)
                widths.append(width)
                table, nxt, width = {}, end + 1, min_size + 1
    if prefix >= 0:
        codes.append(prefix)
        widths.append(width)
        if nxt < 4096 and nxt == (1 << width) and width < 12:
            width += 1
    codes.append(end)
    widths.append(width)
    codes, widths = np.array(codes, np.int64), np.array(widths)
    bits = (codes[:, None] >> np.arange(12)) & 1  # least significant first
    stream = bits[np.arange(12) < widths[:, None]].astype(np.uint8)
    return np.packbits(stream, bitorder="little").tobytes()


_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def _table(palette) -> tuple:
    """(size field, the colour table padded to a power of two)."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    size = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    out = np.zeros((1 << size, 3), np.uint8)
    out[:len(pal)] = pal
    return size - 1, out.tobytes()


def gif_bytes(frames, palette=None, size=None, background: int = 0, min_size: int = None,
              clear_when_full: bool = True) -> bytes:
    """A GIF89a of ``frames``, each an (h, w) uint8 array of indices or a
    dict ``{"pixels", "x", "y", "palette" (a local table), "interlace",
    "transparency", "disposal"}``; ``palette`` the global table ((N, 3)
    RGB, none when None), ``size`` the screen (W, H; default the first
    frame's)."""
    frames = [f if isinstance(f, dict) else {"pixels": f} for f in frames]
    h0, w0 = frames[0]["pixels"].shape
    sw, sh = size or (w0, h0)
    flags, table = 0, b""
    if palette is not None:
        bits, table = _table(palette)
        flags = 0x80 | 0x70 | bits
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, background, 0) + table)
    for f in frames:
        px = np.asarray(f["pixels"], np.uint8)
        h, w = px.shape
        if "transparency" in f or "disposal" in f:
            t = f.get("transparency")
            out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4,
                               (f.get("disposal", 0) << 2) | (t is not None), 0, t or 0, 0)
        lflags, local = 0, b""
        if f.get("palette") is not None:
            bits, local = _table(f["palette"])
            lflags = 0x80 | bits
        if f.get("interlace"):
            lflags |= 0x40
            px = np.concatenate([px[s::d] for s, d in _INTERLACE])
        out += struct.pack("<BHHHHB", 0x2C, f.get("x", 0), f.get("y", 0), w, h, lflags) + local
        ms = min_size or max(2, int(px.max()).bit_length())
        data = gif_lzw_encode(px.tobytes(), ms, clear_when_full)
        out.append(ms)
        for k in range(0, len(data), 255):
            out.append(len(data[k:k + 255]))
            out += data[k:k + 255]
        out.append(0)
    return bytes(out + b";")


# ----- SPIDER ------------------------------------------------------------------


def _spider_header(h: int, w: int, big: bool, istack: float = 0, maxim: float = 0,
                   imgnum: float = 0, iform: float = 1) -> bytes:
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    hdr = np.zeros(labrec * lenbyt // 4, np.float32)
    for i, v in {1: 1, 2: h, 5: iform, 12: w, 13: labrec, 22: labrec * lenbyt, 23: lenbyt,
                 24: istack, 26: maxim, 27: imgnum}.items():
        hdr[i - 1] = v
    return hdr.astype(">f4" if big else "<f4").tobytes()


def spider_bytes(pages, big: bool = True, stack: bool = None, iform: int = 1) -> bytes:
    """A SPIDER image of one (H, W) float32 page, or a stack (an overall
    header, then each image's header and samples) of several; big-endian
    or little-endian."""
    pages = [np.asarray(p, np.float32) for p in (pages if isinstance(pages, list) else [pages])]
    stack = len(pages) > 1 if stack is None else stack
    h, w = pages[0].shape
    f4 = ">f4" if big else "<f4"
    if not stack:
        return _spider_header(h, w, big, iform=iform) + pages[0].astype(f4).tobytes()
    out = _spider_header(h, w, big, istack=2, maxim=len(pages), iform=iform)
    for k, p in enumerate(pages):
        out += _spider_header(h, w, big, imgnum=k + 1, iform=iform) + p.astype(f4).tobytes()
    return out


# ----- TGA ---------------------------------------------------------------------


def tga_rle(raw: np.ndarray) -> bytes:
    """TGA RLE of (rows, pixels, bytes a pixel), row by row: runs of 2 or
    more equal pixels as repeat packets, the rest as raw packets, each of
    at most 128 pixels."""
    out = bytearray()
    for row in raw:
        keys = row.view(np.dtype((np.void, row.shape[1]))).ravel() if row.shape[1] > 1 \
            else row[:, 0]
        eq = np.concatenate([keys[1:] != keys[:-1], [True]])
        ends = np.flatnonzero(eq) + 1
        starts = np.concatenate([[0], ends[:-1]])
        lit = []
        for s, e in zip(starts.tolist(), ends.tolist()):
            if e - s == 1:
                lit.append(s)
                if len(lit) == 128 or s == len(keys) - 1:
                    out.append(len(lit) - 1)
                    out += row[lit[0]:lit[-1] + 1].tobytes()
                    lit = []
                continue
            if lit:
                out.append(len(lit) - 1)
                out += row[lit[0]:lit[-1] + 1].tobytes()
                lit = []
            while s < e:
                n = min(e - s, 128)
                out.append(0x80 | (n - 1))
                out += row[s].tobytes()
                s += n
    return bytes(out)


def tga_bytes(pixels: np.ndarray, image_type: int, palette=None,
              map_depth: int = 24, map_first: int = 0, top: bool = False, right: bool = False,
              ident: bytes = b"") -> bytes:
    """A TGA of ``image_type`` 1, 2, 3 (raw) or 9, 10, 11 (RLE): (H, W)
    indices (1, 9; ``palette`` (N, 3) RGB, entries of ``map_depth`` 15,
    16, 24 or 32 bits from ``map_first``), (H, W) grey or (H, W, 2) grey
    and alpha (3, 11), (H, W, 3) RGB, (H, W, 4) RGBA or (H, W) uint16
    words of 5-5-5 (2, 10); ``top``/``right``: the origin's corner."""
    h, w = pixels.shape[:2]
    kind = image_type & 7
    depth = {1: 8, 3: 8 * (1 if pixels.ndim == 2 else 2)}.get(
        kind, 16 if pixels.dtype == np.uint16 else 8 * pixels.shape[-1])
    cmap = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if map_depth == 24:
            cmap = pal[:, ::-1].tobytes()
        elif map_depth == 32:
            cmap = np.concatenate([pal[:, ::-1], np.full((len(pal), 1), 255, np.uint8)],
                                  1).tobytes()
        else:
            p = pal.astype(np.uint16) >> 3
            cmap = ((p[:, 0] << 10) | (p[:, 1] << 5) | p[:, 2]).astype("<u2").tobytes()
    head = struct.pack("<BBBHHBHHHHBB", len(ident), palette is not None, image_type,
                       map_first, 0 if palette is None else len(cmap) * 8 // map_depth,
                       map_depth if palette is not None else 0, 0, 0, w, h, depth,
                       (0x20 if top else 0) | (0x10 if right else 0))
    rows = pixels if top else pixels[::-1]
    if right:
        rows = rows[:, ::-1]
    if depth == 16 and kind == 2:
        raw = rows.astype("<u2").view(np.uint8).reshape(h, w, 2)
    elif pixels.ndim == 3 and kind == 2:
        raw = rows[..., [2, 1, 0, 3][:pixels.shape[2]]]
    else:
        raw = rows.reshape(h, w, -1)
    raw = np.ascontiguousarray(raw, np.uint8)
    body = tga_rle(raw) if image_type & 8 else raw.tobytes()
    return head + ident + cmap + body + b"\x00" * 8 + b"TRUEVISION-XFILE.\x00"


# ----- Sun raster --------------------------------------------------------------


def sun_rle(data: bytes) -> bytes:
    """Sun raster's byte encoding: runs of 3 or more bytes (and any 0x80)
    as 0x80 n v, a single 0x80 as 0x80 0x00, other bytes as they stand."""
    arr = np.frombuffer(data, np.uint8)
    out = bytearray()
    for s, n in _rle_runs(arr):
        v = int(arr[s])
        while n:
            k = min(n, 256)
            if k >= 3 or v == 0x80:
                out += bytes((0x80, k - 1, v)) if (k > 1 or v != 0x80) else b"\x80\x00"
            else:
                out += bytes((v,)) * k
            n -= k
    return bytes(out)


def sun_bytes(pixels: np.ndarray, depth: int = None, palette=None, rle: bool = False,
              rgb_order: bool = False) -> bytes:
    """A Sun raster of (H, W) bits 0/1 (depth 1), (H, W) uint8 (depth 8,
    ``palette`` (N, 3) RGB optional), (H, W, 3) RGB (24) or (H, W, 4)
    bytes in the file's order (32); rows padded to 16 bits; ``rle``: type 2
    (byte-encoded), ``rgb_order``: type 3 (RGB, not BGR)."""
    h, w = pixels.shape[:2]
    if depth is None:
        depth = 8 if pixels.ndim == 2 else 8 * pixels.shape[2]
    stride = ((w * depth + 15) // 16) * 2
    if depth == 1:
        raw = np.packbits(pixels.astype(np.uint8), axis=1)
    elif depth == 24:
        raw = (pixels if rgb_order else pixels[..., ::-1]).reshape(h, -1)
    else:
        raw = pixels.reshape(h, -1)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :raw.shape[1]] = raw
    body = rows.tobytes()
    if rle:
        body = sun_rle(body)
    cmap = b""
    if palette is not None:
        cmap = np.asarray(palette, np.uint8).reshape(-1, 3).T.tobytes()
    ftype = 2 if rle else (3 if rgb_order else 1)
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if cmap else 0, len(cmap)) + cmap + body
