"""A TIFF writer for the port's input tests and for phase 18 of
chip_smoke.py: the port writes no compressed file (the JAX package's
``_save_labels`` writes uncompressed ones), so the files it must read are
encoded here, with zlib for Deflate and the LZW and PackBits encoders
below."""

import struct
import zlib

import numpy as np


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW of ``data`` as libtiff writes it: a clear code first, codes
    of 9 to 12 bits, most significant bit first, the width growing when the
    next free entry needs it, a clear code when the table fills, an end
    code last."""
    codes, widths = [256], [9]
    table, nxt, width, prefix = {}, 258, 9, -1

    def emit(code):
        codes.append(code)
        widths.append(width)
    for b in data:
        if prefix < 0:
            prefix = b
            continue
        key = prefix << 8 | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        prefix = b
        table[key] = nxt
        nxt += 1
        if nxt == 4094:
            emit(256)
            table, nxt, width = {}, 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
    if prefix >= 0:
        emit(prefix)
        nxt += 1
        if nxt == 4094:
            emit(256)
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
    emit(257)
    codes, widths = np.array(codes, np.int64), np.array(widths)
    bits = (codes[:, None] >> np.arange(11, -1, -1)) & 1
    return np.packbits(bits[np.arange(12) >= 12 - widths[:, None]].astype(np.uint8)).tobytes()


def packbits_encode(data: bytes, row_bytes: int) -> bytes:
    """PackBits of ``data``, row by row: runs of 3 or more equal bytes as
    repeat packets, the rest as literal packets of at most 128 bytes."""
    out = bytearray()

    def literal(row, a, b):
        for i in range(a, b, 128):
            chunk = row[i:min(i + 128, b)]
            out.append(len(chunk) - 1)
            out.extend(chunk.tobytes())
    for row in np.frombuffer(data, np.uint8).reshape(-1, row_bytes):
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        lengths = np.diff(np.r_[starts, row_bytes])
        at = 0
        for s, n in zip(starts[lengths >= 3].tolist(), lengths[lengths >= 3].tolist()):
            literal(row, at, s)
            for i in range(0, n, 128):
                m = min(128, n - i)
                out.extend((257 - m, int(row[s])) if m > 1 else (0, int(row[s])))
            at = s + n
        literal(row, at, row_bytes)
    return bytes(out)


def encode_chunk(args) -> bytes:
    """One strip or tile of ``tiff_bytes``: (compression, raw bytes, bytes a
    row) -> the bytes written."""
    compression, raw, row_bytes = args
    if compression == 5:
        return lzw_encode(raw)
    if compression == 8:
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits_encode(raw, row_bytes)
    return raw


def tiff_bytes(pages, compression=1, predictor=1, tile=None, rows_per_strip=None,
               big=False, order="<", extra_samples=None, colormap=None, photometric=None,
               map_fn=map):
    """A TIFF of ``pages`` ((H, W) or (H, W, C) arrays of one dtype): classic
    or BigTIFF (``big``), byte order ``order``, in strips of
    ``rows_per_strip`` rows (all by default) or ``tile`` (w, h) tiles
    (zero-padded at the edges), uncompressed (1), LZW (5), Deflate (8) or
    PackBits (32773), with horizontal differencing (``predictor`` 2, LZW
    and Deflate only) or without;
    grey, RGB, RGBA (``extra_samples`` the ExtraSamples value) or a palette
    (``colormap``, 3 x 2^bits uint16); ``photometric`` overrides the
    Photometric tag those imply.  ``map_fn`` maps ``encode_chunk``
    over the strips or tiles (a process pool's ``map`` spreads them)."""
    fmt = {"u": 1, "i": 2, "f": 3}
    off = "Q" if big else "I"
    out = bytearray((b"II" if order == "<" else b"MM")
                    + struct.pack(order + ("HHHQ" if big else "HI"), *(
                        (43, 8, 0, 0) if big else (42, 0))))
    link = len(out) - (8 if big else 4)  # where the next IFD's offset goes
    pages = [np.asarray(p) for p in pages]
    blocks_of, jobs = [], []
    for page in pages:
        h, w = page.shape[:2]
        spp = page.shape[2] if page.ndim == 3 else 1
        px = page.reshape(h, w, spp)
        item = px.dtype.itemsize
        if tile:
            tw, th = tile
            ny, nx = -(-h // th), -(-w // tw)
            padded = np.zeros((ny * th, nx * tw, spp), px.dtype)
            padded[:h, :w] = px
            blocks = [padded[y * th:(y + 1) * th, x * tw:(x + 1) * tw]
                      for y in range(ny) for x in range(nx)]
        else:
            rps = rows_per_strip or h
            blocks = [px[y:y + rps] for y in range(0, h, rps)]
        blocks_of.append(len(blocks))
        for block in blocks:
            if predictor == 2 and compression in (5, 8):  # as libtiff applies it
                u = np.ascontiguousarray(block).view(f"u{item}")
                block = np.concatenate([u[:, :1], u[:, 1:] - u[:, :-1]], axis=1)
            raw = np.ascontiguousarray(block).astype(block.dtype.newbyteorder(order)).tobytes()
            jobs.append((compression, raw, block.shape[1] * spp * item))
    encoded = iter(list(map_fn(encode_chunk, jobs)))
    for page, n_blocks in zip(pages, blocks_of):
        h, w = page.shape[:2]
        spp = page.shape[2] if page.ndim == 3 else 1
        item = page.dtype.itemsize
        rps = rows_per_strip or h
        chunks = [next(encoded) for _ in range(n_blocks)]
        offsets = []
        for raw in chunks:
            offsets.append(len(out))
            out += raw
            out += b"\0" * (len(out) % 2)
        tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [item * 8] * spp), (259, 3, [compression]),
                (262, 3, [photometric if photometric is not None
                          else 3 if colormap is not None else 2 if spp >= 3 else 1]),
                (277, 3, [spp]), (284, 3, [1]),
                (339, 3, [fmt[page.dtype.kind]] * spp)]
        counts = [len(c) for c in chunks]
        if tile:
            tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 16 if big else 4, offsets),
                     (325, 16 if big else 4, counts)]
        else:
            tags += [(273, 16 if big else 4, offsets), (278, 4, [rps]),
                     (279, 16 if big else 4, counts)]
        if predictor != 1:
            tags.append((317, 3, [predictor]))
        if colormap is not None:
            tags.append((320, 3, np.asarray(colormap).reshape(-1).tolist()))
        if extra_samples is not None:
            tags.append((338, 3, [extra_samples]))
        tags.sort()
        codes = {3: "H", 4: "I", 16: "Q"}
        inline = 8 if big else 4
        entries = b""
        values = bytearray()
        n_entry = 20 if big else 12
        head = struct.calcsize(order + ("Q" if big else "H"))
        ifd = len(out) + len(out) % 2
        out += b"\0" * (ifd - len(out))
        spill = ifd + head + n_entry * len(tags) + inline
        for tag, typ, vals in tags:
            raw = struct.pack(order + codes[typ] * len(vals), *vals)
            if len(raw) <= inline:
                field = raw.ljust(inline, b"\0")
            else:
                field = struct.pack(order + off, spill + len(values))
                values += raw + b"\0" * (len(raw) % 2)
            entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, len(vals)) + field
        struct.pack_into(order + off, out, link, ifd)
        out += struct.pack(order + ("Q" if big else "H"), len(tags)) + entries
        link = len(out)
        out += b"\0" * inline + values
    return bytes(out)
