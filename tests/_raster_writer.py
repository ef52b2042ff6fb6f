"""Writers of the raster formats ``data/raster.py`` reads, for the port's
raster tests and for phase 19 of chip_smoke.py (the card's machine has no
PIL): BMP and DIB (core, info, V4 and V5 headers; palettes, 16-, 24- and
32-bit pixels, bitfields, RLE8 and RLE4), PNM (P1-P6 plain and raw at any
maxval, comments in the header), PFM, PAM, GIF (global and local colour
tables, interlaced frames, transparency, disposal; an LZW encoder of its
own), SPIDER images and stacks in either byte order, TGA (colour-mapped,
true-colour and grey, raw or RLE, either origin) and Sun raster (raw or
byte-encoded, colour maps); for ``data/plugins.py`` SGI, PCX, DCX, QOI,
IM (with ``im_bits`` for its samples of 2 to 31 bits), XBM, MSP, HDR and
MPO; for ``data/icons.py`` (and phase 23) XPM, ICO and CUR (PNG or DIB
members, ``ico_dib`` with its AND mask), PSD (raw or PackBits, layers)
and ICNS (``icns_rle`` for its RGB runs).  numpy and the standard library
only; every file is a pure function of its arguments."""

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


# ----- SGI ---------------------------------------------------------------------


def _packets(values: np.ndarray, min_run: int, max_run: int, max_lit: int):
    """(run, start, length) of the packets of an RLE of ``values``: each
    run of ``min_run`` or more equal values in pieces of at most
    ``max_run``, the values between them in literals of at most
    ``max_lit``; found in vectors, so that only packets are looped over."""
    n = len(values)
    if not n:
        return
    starts = np.flatnonzero(np.r_[True, values[1:] != values[:-1]])
    lens = np.diff(np.r_[starts, n])
    is_run = lens >= min_run
    # a literal stretch starts at a short run after a long one (or first)
    opens = ~is_run & np.r_[True, is_run[:-1]]
    keep = is_run | opens
    ends = np.r_[starts[keep][1:], n]
    for run, start, end in zip(is_run[keep].tolist(), starts[keep].tolist(), ends.tolist()):
        step = max_run if run else max_lit
        for at in range(start, end, step):
            yield run, at, min(step, end - at)


def sgi_rle_row(values: np.ndarray, bpc: int = 1) -> bytes:
    """One row of one channel as SGI RLE: runs of 3 or more as run packets
    (count, value), the rest as copy packets (0x80 | count, values), at
    most 127 samples a packet, then a 0 packet; with ``bpc`` 2 each packet
    header is a 16-bit word and each value 16 bits, big-endian."""
    values = np.asarray(values).astype(">u2" if bpc == 2 else np.uint8)
    word = (lambda v: struct.pack(">H", int(v))) if bpc == 2 else (lambda v: bytes((int(v),)))
    out = bytearray()
    for run, at, n in _packets(values, 3, 127, 127):
        out += word(n) + values[at:at + 1].tobytes() if run else \
            word(0x80 | n) + values[at:at + n].tobytes()
    return bytes(out + word(0))


def sgi_bytes(pixels: np.ndarray, bpc: int = 1, rle: bool = False, dimension: int = None,
              rows=None) -> bytes:
    """An SGI image of (H, W) or (H, W, C) ``pixels`` (C 3 or 4; uint8 at
    ``bpc`` 1, uint16 at 2): a 512-byte header, then each channel's rows
    bottom-up, raw (big-endian samples) or RLE (``rle``: the start and
    length tables, row by row of each channel, then the rows);
    ``dimension`` defaults to 1 for one row of grey, 2 for grey, 3 for
    colour; ``rows`` (RLE): {(file row, channel): bytes} replacing those
    rows' packets, for crafted ones."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    z = 1 if px.ndim == 2 else px.shape[2]
    planes = px.reshape(h, w, z)[::-1].transpose(2, 0, 1)  # (channel, file row, column)
    if dimension is None:
        dimension = 3 if z > 1 else (1 if h == 1 else 2)
    head = struct.pack(">hBBHHHHll4s80sl404s", 474, int(rle), bpc, dimension, w, h, z, 0,
                       255 if bpc == 1 else 65535, b"", b"sgi", 0, b"")
    dtype = ">u2" if bpc == 2 else np.uint8
    if not rle:
        return head + planes.astype(dtype).tobytes()
    rows = rows or {}
    data = [rows.get((r, c)) or sgi_rle_row(planes[c, r], bpc) for c in range(z)
            for r in range(h)]
    at = 512 + 8 * z * h
    starts = np.cumsum([at] + [len(d) for d in data[:-1]])
    return (head + np.asarray(starts, ">u4").tobytes()
            + np.asarray([len(d) for d in data], ">u4").tobytes() + b"".join(data))


# ----- PCX and DCX -------------------------------------------------------------


def pcx_rle(line: bytes) -> bytes:
    """PCX RLE of one scanline: runs of 2 or more (and any byte of the top
    two bits set) as (0xC0 | count, value), at most 63 a run; other bytes
    as they stand."""
    return _pcx_rle_lines(np.frombuffer(line, np.uint8)[None])


def _pcx_rle_lines(lines: np.ndarray) -> bytes:
    """``pcx_rle`` of each row of (rows, bytes) ``lines``, in vectors: runs
    break at each row's end."""
    flat = lines.ravel()
    cut = np.r_[True, flat[1:] != flat[:-1]]
    cut[::lines.shape[1]] = True
    starts = np.flatnonzero(cut)
    lens = np.diff(np.r_[starts, len(flat)])
    pieces = (lens + 62) // 63
    run = np.repeat(np.arange(len(lens)), pieces)
    k = np.arange(len(run)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    size = np.where(k == pieces[run] - 1, lens[run] - 63 * (pieces[run] - 1), 63)
    v = flat[starts][run]
    single = (size == 1) & (v < 0xC0)
    out = np.stack([np.where(single, v, 0xC0 | size), v], -1).astype(np.uint8)
    return out[np.arange(2) < np.where(single, 1, 2)[:, None]].tobytes()


def pcx_bytes(pixels: np.ndarray, planes: int = None, palette=None, version: int = 5,
              stride: int = None, body: bytes = None) -> bytes:
    """A PCX of (H, W) bool (1 bit, 1 plane), (H, W) indices in ``planes``
    2 or 4 bit planes (``palette`` (16, 3) in the header), (H, W) uint8
    (8 bits, 1 plane; ``palette`` (256, 3) appended after a 12 byte) or (H,
    W, 3) RGB (3 planes of 8 bits); each scanline (every plane's ``stride``
    bytes, by default the row's bytes rounded up to even) RLE-encoded;
    ``body``: the encoded data as given, for crafted ones."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    if px.dtype == bool:
        bits, planes, raw = 1, 1, np.packbits(px, axis=1)[None]
    elif planes in (2, 4):
        bits = 1
        raw = np.stack([np.packbits((px >> p) & 1, axis=1) for p in range(planes)])
    else:
        bits, planes = 8, 1 if px.ndim == 2 else 3
        raw = px.reshape(h, w, planes).transpose(2, 0, 1)
    if stride is None:
        stride = (w * bits + 7) // 8
        stride += stride % 2
    lines = np.zeros((h, planes, stride), np.uint8)
    lines[:, :, :raw.shape[2]] = raw.transpose(1, 0, 2)[:, :, :stride]
    if body is None:
        body = _pcx_rle_lines(lines.reshape(h, -1))
    head_pal = np.zeros((16, 3), np.uint8)
    if palette is not None and bits == 1:
        head_pal[:len(palette)] = np.asarray(palette, np.uint8).reshape(-1, 3)[:16]
    head = struct.pack("<BBBBHHHHHH48sBBHHHH54s", 10, version, 1, bits, 0, 0, w - 1, h - 1,
                       72, 72, head_pal.tobytes(), 0, planes, stride, 1, 0, 0, b"")
    tail = b""
    if palette is not None and bits == 8:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = np.asarray(palette, np.uint8).reshape(-1, 3)
        tail = b"\x0c" + pal.tobytes()
    return head + body + tail


def dcx_bytes(pages) -> bytes:
    """A DCX of the PCX files ``pages``: its magic, the pages' offsets (a
    0 after the last, 1024 entries in all), then the pages."""
    at = 4 + 4 * 1024
    offsets = np.zeros(1024, "<u4")
    for k, page in enumerate(pages):
        offsets[k] = at
        at += len(page)
    return struct.pack("<I", 0x3ADE68B1) + offsets.tobytes() + b"".join(pages)


# ----- QOI ---------------------------------------------------------------------


def qoi_ops(pixels: np.ndarray) -> bytes:
    """The QOI op stream of (H, W, 3 or 4) uint8 ``pixels``, as the
    format's reference encoder writes it, in vectors: a run of pixels equal
    to the one before as RUN ops (at most 62 each), a pixel found at its
    hash in the table of the 64 last seen as INDEX, else DIFF, LUMA or RGB
    when its alpha is the one before's, else RGBA."""
    h, w, c = pixels.shape
    px = np.full((h * w, 4), 255, np.uint8)
    px[:, :c] = pixels.reshape(-1, c)
    prev = np.concatenate([[[0, 0, 0, 255]], px[:-1]]).astype(np.uint8)
    same = (px == prev).all(1)
    n = len(px)
    # each op: (pixel position, order within it, up to 5 bytes, length)
    keys, sub, body, size = [], [], [], []
    # runs: maximal spans of pixels equal to the one before
    edges = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    for s, e in zip(np.flatnonzero(edges == 1).tolist(), np.flatnonzero(edges == -1).tolist()):
        for k, at in enumerate(range(s, e, 62)):
            keys.append(s)
            sub.append(k)
            body.append([0xC0 | (min(62, e - at) - 1), 0, 0, 0, 0])
            size.append(1)
    t = np.flatnonzero(~same)
    v = px[t].astype(np.int64)
    hv = (v[:, 0] * 3 + v[:, 1] * 5 + v[:, 2] * 7 + v[:, 3] * 11) % 64
    # the table slot's pixel: the last pixel before of the same hash that
    # was not a run's, or (0, 0, 0, 0)
    order = np.argsort(hv, kind="stable")
    before = np.full(len(t), -1)
    same_slot = hv[order][1:] == hv[order][:-1]
    before[order[1:][same_slot]] = order[:-1][same_slot]
    slot = np.where(before[:, None] >= 0, v[np.maximum(before, 0)], 0)
    index = (slot == v).all(1)
    p = prev[t].astype(np.int64)
    d = ((v - p + 128) % 256) - 128
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    alpha_same = d[:, 3] == 0
    diff = alpha_same & (np.abs(d[:, :3] + 0.5) < 2).all(1)
    luma = alpha_same & (dg >= -32) & (dg <= 31) & (np.abs(dr - dg + 0.5) < 8) \
        & (np.abs(db - dg + 0.5) < 8)
    ops = np.zeros((len(t), 5), np.int64)
    lens = np.zeros(len(t), np.int64)
    rgba = ~index & ~alpha_same
    rgb = ~index & alpha_same & ~diff & ~luma
    lu = ~index & luma & ~diff
    di = ~index & diff
    ops[index, 0], lens[index] = hv[index], 1
    ops[di, 0] = 0x40 | (dr[di] + 2) << 4 | (dg[di] + 2) << 2 | (db[di] + 2)
    lens[di] = 1
    ops[lu, 0], ops[lu, 1] = 0x80 | (dg[lu] + 32), (dr[lu] - dg[lu] + 8) << 4 | (
        db[lu] - dg[lu] + 8)
    lens[lu] = 2
    ops[rgb, 0], ops[rgb, 1:4], lens[rgb] = 0xFE, v[rgb, :3], 4
    ops[rgba, 0], ops[rgba, 1:5], lens[rgba] = 0xFF, v[rgba], 5
    keys = np.concatenate([np.asarray(keys, np.int64), t])
    sub = np.concatenate([np.asarray(sub, np.int64), np.zeros(len(t), np.int64)])
    body = np.concatenate([np.asarray(body, np.int64).reshape(-1, 5), ops])
    size = np.concatenate([np.asarray(size, np.int64), lens])
    order = np.lexsort((sub, keys))
    body, size = body[order], size[order]
    return body[np.arange(5) < size[:, None]].astype(np.uint8).tobytes() if n else b""


def qoi_bytes(pixels: np.ndarray = None, ops: bytes = None, size=None, channels: int = None,
              colorspace: int = 0) -> bytes:
    """A QOI of (H, W, 3 or 4) uint8 ``pixels`` (``qoi_ops``), or of the op
    stream ``ops`` as given for an image of ``size`` (W, H) and
    ``channels``; the 8-byte end marker last."""
    if ops is None:
        h, w, channels = pixels.shape
        size, ops = (w, h), qoi_ops(pixels)
    return b"qoif" + struct.pack(">IIBB", size[0], size[1], channels, colorspace) + ops \
        + b"\x00" * 7 + b"\x01"


# ----- IM (LabEye IFUNC) ---------------------------------------------------------


def im_pack(pixels: np.ndarray, rawmode: str) -> np.ndarray:
    """The (H, row bytes) rows of an IM image in the image's row order for
    PIL's raw mode ``rawmode``: "1" (bits, most significant first), "L",
    "P", "P;2", "P;4" (indices packed), "RGB" (interleaved), "<bands>;L"
    (each band's row in turn: "LA;L", "RGB;L", "RGBA;L", ...), "I;16",
    "I;16L", "I;16B", "I;32S", "F;8", "F;8S", "F;16", "F;16S", "F;32",
    "F;32S", "F;32F" (the samples in their type, little-endian but B)."""
    px = np.asarray(pixels)
    h = px.shape[0]
    if rawmode == "1":
        return np.packbits(px.astype(bool), axis=1)
    if rawmode in ("P;2", "P;4"):
        bits = int(rawmode[2])
        per = 8 // bits
        idx = np.zeros((h, -(-px.shape[1] // per) * per), np.uint8)
        idx[:, :px.shape[1]] = px
        out = np.zeros((h, idx.shape[1] // per), np.uint8)
        for k in range(per):
            out |= idx[:, k::per] << (8 - bits * (k + 1))
        return out
    if rawmode.endswith(";L"):
        return np.ascontiguousarray(px.transpose(0, 2, 1)).astype(np.uint8).reshape(h, -1)
    dtype = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32S": "<i4", "F;8": "u1",
             "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32S": "<i4",
             "F;32F": "<f4"}.get(rawmode, "u1")
    return px.astype(dtype).view(np.uint8).reshape(h, -1)


def im_bytes(frames, image_type: str, size=None, lut=None, n_frames: int = None,
             lines: bytes = b"", rawmode: str = None) -> bytes:
    """An IM file: its text header (``Image type: <image_type> image``, a
    name, ``Image size (x*y)``, ``File size (no of images)`` (``n_frames``,
    by default the frames'), ``Lut: 1`` with a ``lut`` (256, 3), then
    ``lines`` as given), NULs to byte 511 and a 0x1A; the LUT's three
    planes; then each frame's rows bottom-up, packed for ``rawmode`` by
    ``im_pack`` (a frame of bytes as given)."""
    frames = frames if isinstance(frames, list) else [frames]
    first = frames[0]
    if size is None:
        size = (first.shape[1], first.shape[0])
    head = (f"Image type: {image_type} image\r\nName: x.im\r\n"
            f"Image size (x*y): {size[0]}*{size[1]}\r\n"
            f"File size (no of images): {len(frames) if n_frames is None else n_frames}\r\n"
            ).encode()
    if lut is not None:
        head += b"Lut: 1\r\n"
    head += lines
    head += b"\x00" * (511 - len(head)) + b"\x1a"
    if lut is not None:
        head += np.asarray(lut, np.uint8).reshape(256, 3).T.tobytes()
    body = b"".join(f if isinstance(f, bytes) else im_pack(f, rawmode)[::-1].tobytes()
                    for f in frames)
    return head + body


# ----- XBM and MSP -------------------------------------------------------------


def xbm_bytes(bits: np.ndarray, hotspot=None, name: str = "im", per_line: int = 12,
              upper: bool = False) -> bytes:
    """An X11 bitmap of (H, W) bool ``bits``: its width and height (and
    ``hotspot`` (x, y)) #defines, then the rows' bytes, least significant
    bit first, as C hex literals, ``per_line`` to a line."""
    h, w = bits.shape
    head = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot is not None:
        head += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n"
    data = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").ravel()
    fmt = "0x{:02X}" if upper else "0x{:02x}"
    cells = [fmt.format(v) for v in data.tolist()]
    rows = [", ".join(cells[k:k + per_line]) for k in range(0, len(cells), per_line)]
    return (head + f"static char {name}_bits[] = {{\n" + ",\n".join(rows) + "\n};\n").encode()


def msp_rle_row(row: bytes) -> bytes:
    """One MSP version 2 row: runs of 3 or more bytes as (0, count,
    value), the rest as (count, bytes), at most 255 a packet."""
    arr = np.frombuffer(row, np.uint8)
    out = bytearray()
    for run, at, n in _packets(arr, 3, 255, 255):
        out += bytes((0, n, arr[at])) if run else bytes((n,)) + arr[at:at + n].tobytes()
    return bytes(out)


def msp_bytes(bits: np.ndarray, version: int = 1, rows=None) -> bytes:
    """A Windows Paint file of (H, W) bool ``bits`` (True a set bit):
    version 1 (``DanM``, the rows as they stand) or 2 (``LinS``: a map of
    each row's encoded length, then the rows, ``msp_rle_row``; a row of
    set bits alone as length 0); its header's 16 words XOR to 0; ``rows``:
    {row: encoded bytes} replacing those rows, for crafted ones."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1)
    header = [0] * 16
    header[0:2] = struct.unpack("<HH", b"DanM" if version == 1 else b"LinS")
    header[2:10] = [w, h, 1, 1, 1, 1, w, h]
    for v in header[:12]:
        header[12] ^= v
    head = struct.pack("<16H", *header)
    if version == 1:
        return head + packed.tobytes()
    rows = rows or {}
    data = [rows.get(r, b"" if (packed[r] == 255).all() else msp_rle_row(packed[r].tobytes()))
            for r in range(h)]
    return head + struct.pack(f"<{h}H", *map(len, data)) + b"".join(data)


# ----- Radiance HDR ------------------------------------------------------------


def rgbe_of(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 4) RGBE bytes of (H, W, 3) float RGB: the largest sample's
    binary exponent e, each sample's mantissa v * 256 / 2^e truncated; 0
    where the largest is under 1e-32."""
    rgb = np.asarray(rgb, np.float64)
    top = rgb.max(-1)
    mant, exp = np.frexp(top)
    scale = np.where(top < 1e-32, 0, mant * 256 / np.where(top < 1e-32, 1, top))
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(top < 1e-32, 0, exp + 128)
    return out


def hdr_scanline(line: np.ndarray) -> bytes:
    """One scanline of (W, 4) RGBE in Radiance's new RLE: 2, 2, W high
    and low byte, then each of the four channels in turn as runs of 4 or
    more (128 + count, value; at most 127) and literals (count, values; at
    most 128)."""
    w = len(line)
    out = bytearray((2, 2, w >> 8, w & 255))
    for c in range(4):
        v = np.ascontiguousarray(line[:, c], np.uint8)
        for run, at, n in _packets(v, 4, 127, 128):
            out += bytes((128 + n, v[at])) if run else bytes((n,)) + v[at:at + n].tobytes()
    return bytes(out)


def hdr_bytes(rgbe: np.ndarray, rle: str = "new", header: bytes = None,
              resolution: bytes = None) -> bytes:
    """A Radiance HDR of (H, W, 4) RGBE bytes: ``header`` (default
    ``#?RADIANCE`` and ``FORMAT=32-bit_rle_rgbe``, then the blank line),
    the ``resolution`` line (default ``-Y H +X W``), then the scanlines:
    ``rle`` "new" (``hdr_scanline``), "flat" (the bytes as they stand) or
    "old" (Radiance's old RLE: a pixel, then 1, 1, 1, count for each run
    of it, counts of later bytes shifted 8 bits more)."""
    h, w = rgbe.shape[:2]
    if header is None:
        header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    if resolution is None:
        resolution = b"-Y %d +X %d\n" % (h, w)
    if rle == "new":
        body = b"".join(hdr_scanline(line) for line in rgbe)
    elif rle == "flat":
        body = np.ascontiguousarray(rgbe, np.uint8).tobytes()
    else:
        out = bytearray()
        flat = np.ascontiguousarray(rgbe, np.uint8).reshape(-1, 4)
        keys = flat.view(">u4").ravel()
        for s, n in _rle_runs(keys):
            out += flat[s].tobytes()
            n -= 1
            while n:
                out += bytes((1, 1, 1, n & 255))
                n >>= 8
        body = bytes(out)
    return header + resolution + body


# ----- MPO ---------------------------------------------------------------------


def mpo_bytes(jpegs, big: bool = False, formats=None, count: int = None,
              ultra_hdr: bool = False, offsets=None) -> bytes:
    """A multi-picture JPEG of the JPEG files ``jpegs``: the first with an
    APP2 ``MPF`` segment after its SOI (a TIFF header, little-endian or
    ``big``, and an IFD of MPFVersion, NumberOfImages (``count``, by
    default the pictures') and MPEntry: each picture's attribute (its
    ``formats`` (ImageDataFormat) in bits 24-26, 0 JPEG), size and offset
    from the byte after ``MPF\\0``, 0 for the first; ``offsets`` as given),
    then the others after it; ``ultra_hdr``: an APP1 with an
    ``hdrgm:Version`` attribute before it."""
    end = ">" if big else "<"
    n = len(jpegs)
    count = n if count is None else count
    formats = formats or [0] * n
    ifd_at = 8
    entries_at = ifd_at + 2 + 3 * 12 + 4
    mp_len = entries_at + 16 * n
    xmp = b""
    if ultra_hdr:
        body = (b"http://ns.adobe.com/xap/1.0/\x00<x:xmpmeta>"
                b'<rdf:Description hdrgm:Version="1.0"/></x:xmpmeta>')
        xmp = struct.pack(">HH", 0xFFE1, len(body) + 2) + body
    app2_len = 2 + 4 + mp_len
    base = 2 + len(xmp) + 2 + 2 + 4  # the byte after MPF\0 in the first picture
    first_size = len(jpegs[0]) + 2 + app2_len + len(xmp)
    at, entries = first_size, b""
    for k, jpeg in enumerate(jpegs):
        attr = (formats[k] << 24) | (0x030000 if k == 0 else 0x020002)
        size = first_size if k == 0 else len(jpeg)
        offset = 0 if k == 0 else at - base
        if offsets is not None:
            offset = offsets[k]
        entries += struct.pack(end + "IIIHH", attr, size, offset, 0, 0)
        if k:
            at += len(jpeg)
    ifd = struct.pack(end + "H", 3)
    ifd += struct.pack(end + "HHI4s", 0xB000, 7, 4, b"0100")
    ifd += struct.pack(end + "HHII", 0xB001, 4, 1, count)
    ifd += struct.pack(end + "HHII", 0xB002, 7, 16 * n, entries_at)
    ifd += struct.pack(end + "I", 0)
    tiff = (b"MM\x00*" if big else b"II*\x00") + struct.pack(end + "I", ifd_at) + ifd + entries
    app2 = struct.pack(">HH", 0xFFE2, app2_len) + b"MPF\x00" + tiff
    return b"\xff\xd8" + xmp + app2 + jpegs[0][2:] + b"".join(jpegs[1:])


def im_bits(pixels: np.ndarray, bits: int) -> bytes:
    """An IM frame of ``bits``-bit samples (2-31, ``L*<bits>``): each row,
    bottom-up, least significant bit first, padded to a byte."""
    px = np.asarray(pixels, np.uint64)[::-1]
    h, w = px.shape
    bit = ((px[..., None] >> np.arange(bits, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
    rows = np.zeros((h, -(-w * bits // 8) * 8), np.uint8)
    rows[:, :w * bits] = bit.reshape(h, -1)
    return np.packbits(rows, axis=1, bitorder="little").tobytes()


# ----- XPM, ICO and CUR, PSD, ICNS ------------------------------------------------

_XPM_KEYS = bytes(c for c in range(35, 127) if c != 92)  # printable, no quote or backslash


def xpm_bytes(indices: np.ndarray, colours, cpp: int = 1, comments: bool = True,
              header: bytes = None) -> bytes:
    """An XPM of (H, W) ``indices`` into ``colours`` (each "#RRGGBB",
    "None", or a whole colour line's value part such as "c red" or
    "s name c #808080"), keys of ``cpp`` characters; ``header`` replaces
    the values line (``"W H N cpp``)."""
    h, w = indices.shape
    n = len(colours)
    keys = [bytes(_XPM_KEYS[(i // len(_XPM_KEYS) ** j) % len(_XPM_KEYS)] for j in range(cpp))
            for i in range(n)]
    out = [b"/* XPM */", b"static char *image[] = {"]
    if comments:
        out.append(b"/* columns rows colors chars-per-pixel */")
    out.append(header if header is not None else f'"{w} {h} {n} {cpp} ",'.encode())
    for k, c in zip(keys, colours):
        c = c.encode() if isinstance(c, str) else c
        out.append(b'"' + k + b" " + (c if b" " in c else b"c " + c) + b'",')
    if comments:
        out.append(b"/* pixels */")
    for r in range(h):
        out.append(b'"' + b"".join(keys[i] for i in indices[r]) + (b'",' if r < h - 1 else b'"'))
    out.append(b"};")
    return b"\n".join(out) + b"\n"


def ico_dib(pixels: np.ndarray, bits: int = None, palette=None, and_mask=None,
            top_down: bool = False) -> bytes:
    """An ICO or CUR member in DIB form: ``bmp_bytes(dib=True)`` of
    ``pixels`` (indices, or (H, W, 4) BGRA bytes at 32 bits) with its height
    doubled, then the AND mask (``and_mask`` (H, W), 1 transparent; zeros
    by default), rows bottom-up, padded to 32 bits."""
    h, w = pixels.shape[:2]
    dib = bytearray(bmp_bytes(pixels, bits, palette, dib=True, top_down=top_down))
    struct.pack_into("<i", dib, 8, -2 * h if top_down else 2 * h)
    mask = np.zeros((h, w), bool) if and_mask is None else np.asarray(and_mask, bool)
    packed = np.packbits(mask[::-1], axis=1)
    stride = (w + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :packed.shape[1]] = packed
    return bytes(dib) + rows.tobytes()


def ico_bytes(members, cursor: bool = False, hotspots=None) -> bytes:
    """An ICO (a CUR with ``cursor``) of ``members``: each (width, height,
    colours, bpp, payload) for its directory entry (a width or height of
    256 written as 0; a CUR writes each ``hotspots`` (x, y) where an ICO
    has planes and bpp), then the payloads (PNG or ``ico_dib``) in order."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(members))
    at = 6 + 16 * len(members)
    for k, (w, h, colours, bpp, payload) in enumerate(members):
        a, b = hotspots[k] if cursor and hotspots else (1, bpp)
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, a, b, len(payload), at)
        at += len(payload)
    return out + b"".join(m[4] for m in members)


def packbits_rows(rows: np.ndarray) -> list:
    """Each row of ``rows`` PackBits-coded (runs of 3-128 equal bytes,
    literals of up to 128), for PSD."""
    out = []
    for row in np.asarray(rows, np.uint8):
        enc, i, n = bytearray(), 0, len(row)
        while i < n:
            j = i
            while j + 1 < n and row[j + 1] == row[i] and j + 1 - i < 127:
                j += 1
            if j - i >= 2:
                enc += bytes([257 - (j - i + 1), row[i]])
                i = j + 1
                continue
            j = i
            while j < n and j - i < 128 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            enc += bytes([j - i - 1]) + row[i:j].tobytes()
            i = j
        out.append(bytes(enc))
    return out


def _psd_channels(planes: np.ndarray, rle: bool) -> bytes:
    """Image data of (C, H, row bytes) planes: compression, then raw planes
    or the byte counts of every row and the PackBits rows."""
    if not rle:
        return struct.pack(">H", 0) + np.ascontiguousarray(planes, np.uint8).tobytes()
    rows = [r for p in planes for r in packbits_rows(p)]
    return struct.pack(">H", 1) + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows)


def psd_bytes(planes: np.ndarray, mode: int = 3, bits: int = 8, rle: bool = False,
              layers=(), palette=None, resources=(), channels: int = None) -> bytes:
    """A PSD of the composite ``planes`` (C, H, W) uint8 (mode 0 at 1 bit:
    (1, H, ceil(W / 8)) bytes of bits), colour ``mode`` (0 bitmap, 1 grey,
    2 indexed, 3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 Lab), ``rle``
    PackBits or raw, ``layers`` each (top, left, planes (C, h, w)) as
    R, G, B (and A) channels, raw, ``palette`` (256, 3) for mode 2, and
    image ``resources`` (id, data); ``channels`` overrides the header's."""
    c, h = planes.shape[:2]
    w = planes.shape[2] * 8 if mode == 0 and bits == 1 else planes.shape[2]
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits, mode)
    cmd = np.asarray(palette, np.uint8).T.tobytes() if palette is not None else b""
    out += struct.pack(">I", len(cmd)) + cmd
    res = b""
    for rid, data in resources:
        res += b"8BIM" + struct.pack(">HBxI", rid, 0, len(data)) + data + b"\0" * (len(data) & 1)
    out += struct.pack(">I", len(res)) + res
    if layers:
        records, data = b"", b""
        for top, left, lp in layers:
            lc, lh, lw = lp.shape
            records += struct.pack(">iiiiH", top, left, top + lh, left + lw, lc)
            for k in range(lc):
                records += struct.pack(">hI", 65535 if k == 3 else k, 2 + lh * lw)
            extra = struct.pack(">II", 0, 0) + b"\x03abc"
            records += b"8BIMnorm" + bytes([255, 0, 0, 0]) + struct.pack(">I", len(extra)) + extra
            data += b"".join(struct.pack(">H", 0) + p.tobytes() for p in lp)
        info = struct.pack(">h", len(layers)) + records + data
        info += b"\0" * (len(info) & 1)
        section = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
        out += struct.pack(">I", len(section)) + section
    else:
        out += struct.pack(">I", 0)
    return out + _psd_channels(planes, rle)


def icns_rle(plane: np.ndarray) -> bytes:
    """One ICNS RGB plane run-length coded: runs of 3-130 equal bytes
    (0x80 + count - 3, the byte) and literals of up to 128 (count - 1)."""
    v, enc, i, n = np.asarray(plane, np.uint8).ravel(), bytearray(), 0, plane.size
    while i < n:
        j = i
        while j + 1 < n and v[j + 1] == v[i] and j + 1 - i < 129:
            j += 1
        if j - i >= 2:
            enc += bytes([0x80 + j - i + 1 - 3, v[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        enc += bytes([j - i - 1]) + v[i:j].tobytes()
        i = j
    return bytes(enc)


def icns_bytes(blocks) -> bytes:
    """An ICNS of ``blocks``, each (type, payload): an ``it32`` payload
    gets its four zero bytes first."""
    body = b""
    for kind, payload in blocks:
        if kind == b"it32":
            payload = b"\0\0\0\0" + payload
        body += kind + struct.pack(">I", 8 + len(payload)) + payload
    return b"icns" + struct.pack(">I", 8 + len(body)) + body
