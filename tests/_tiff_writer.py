"""A TIFF writer for the port's input tests and for phase 18 of
chip_smoke.py: the port writes no compressed file (the JAX package's
``_save_labels`` writes uncompressed ones), so the files it must read are
encoded here, with zlib for Deflate, ``lzma`` for LZMA, ``zstandard`` (the
tests' machine only) for ZSTD, ``_jpeg_writer`` for JPEG and the LZW and
PackBits encoders below."""

import lzma
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


# the compressions libtiff applies a predictor with
_PREDICTED = (5, 8, 32946, 34925, 50000)


def float_difference(block: np.ndarray) -> np.ndarray:
    """Predictor 3 of (rows, w, spp) float samples, as libtiff's ``fpDiff``
    writes it: each row's bytes as planes, most significant first whatever
    the file's byte order, then differenced bytewise with stride spp."""
    rows, w, spp = block.shape
    item = block.dtype.itemsize
    planes = np.ascontiguousarray(block).astype(block.dtype.newbyteorder(">")).view(
        np.uint8).reshape(rows, w * spp, item).transpose(0, 2, 1).reshape(rows, -1)
    out = planes.copy()
    out[:, spp:] -= planes[:, :-spp]
    return out


def encode_chunk(args) -> bytes:
    """One strip or tile of ``tiff_bytes``: (compression, raw bytes, bytes a
    row, JPEG quality) -> the bytes written.  A JPEG strip (7) is an
    abbreviated stream of one grey (rows, bytes a row) block: its tables are
    the page's JPEGTables."""
    compression, raw, row_bytes, quality = args
    if compression == 5:
        return lzw_encode(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits_encode(raw, row_bytes)
    if compression == 34925:  # an .xz stream a strip, as libtiff writes it
        return lzma.compress(raw, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
    if compression == 50000:
        import zstandard

        return zstandard.ZstdCompressor(level=quality or 3).compress(raw)
    if compression == 7:
        from _jpeg_writer import jpeg_bytes

        grey = np.frombuffer(raw, np.uint8).reshape(-1, row_bytes)
        return jpeg_bytes(grey, quality or 75, tables=False)
    return raw


def pack_rows(block: np.ndarray, bits: int) -> np.ndarray:
    """(rows, w, spp) levels of ``bits`` (1, 2 or 4) bits as TIFF rows:
    most significant first, each row padded to a whole byte."""
    rows = block.shape[0]
    levels = np.ascontiguousarray(block, np.uint8).reshape(rows, -1)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint8)
    return np.packbits(((levels[..., None] >> shifts) & 1).reshape(rows, -1), axis=1)


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits in reverse order (FillOrder 2)."""
    return np.packbits(np.unpackbits(np.frombuffer(data, np.uint8)), bitorder="little").tobytes()


def tiff_bytes(pages, compression=1, predictor=1, tile=None, rows_per_strip=None,
               big=False, order="<", extra_samples=None, colormap=None, photometric=None,
               map_fn=map, planar=1, subsampling=None, quality=None, extra_tags=(),
               jpeg_fn=None, bits=None, fill_order=1, encode_fn=None):
    """A TIFF of ``pages`` ((H, W) or (H, W, C) arrays of one dtype): classic
    or BigTIFF (``big``), byte order ``order``, in strips of
    ``rows_per_strip`` rows (all by default) or ``tile`` (w, h) tiles
    (zero-padded at the edges), uncompressed (1), LZW (5), Deflate (8),
    PackBits (32773), LZMA (34925), ZSTD (50000, at level ``quality``) or
    JPEG (7: grey uint8 pages at ``quality``, the tables in JPEGTables),
    with horizontal differencing (``predictor`` 2) or floating-point
    differencing (3, float samples), LZW, Deflate, LZMA and ZSTD only, or
    without; samples together (``planar`` 1) or each plane in strips or
    tiles of its own (2); grey, RGB, RGBA (``extra_samples`` the
    ExtraSamples value) or a palette (``colormap``, 3 x 2^bits uint16);
    ``photometric`` overrides the Photometric tag those imply.  YCbCr
    pages (photometric 6) of ``subsampling`` (h, v) are written in its data
    units (h x v Y samples, then Cb and Cr: the page's channels 1 and 2 at
    the unit's top-left pixel; strips only), with the YCbCrSubsampling
    tag.  ``extra_tags`` adds (tag, type, values) entries (types 3, 4, 5 as (num, den) pairs,
    7, 16).  ``map_fn`` maps ``encode_chunk`` over the strips or tiles (a
    process pool's ``map`` spreads them).  ``jpeg_fn`` (compression 7)
    encodes each (rows, w, samples) uint8 strip or tile as a whole JPEG
    stream instead, tables included (no JPEGTables tag): colour JPEG from
    another encoder.  ``bits`` (1, 2 or 4) writes pages of levels packed
    that many bits a sample, each row of a strip or tile padded to a
    byte; ``encode_fn`` then encodes each (rows, w) block of levels
    itself (CCITT: ``_ccitt_writer``).  ``fill_order`` 2 reverses the bits
    of every byte written for a strip or tile, with the FillOrder tag."""
    fmt = {"b": 1, "u": 1, "i": 2, "f": 3}
    off = "Q" if big else "I"
    out = bytearray((b"II" if order == "<" else b"MM")
                    + struct.pack(order + ("HHHQ" if big else "HI"), *(
                        (43, 8, 0, 0) if big else (42, 0))))
    link = len(out) - (8 if big else 4)  # where the next IFD's offset goes
    pages = [np.asarray(p) for p in pages]
    blocks_of, jobs, raw_blocks = [], [], []
    for page in pages:
        h, w = page.shape[:2]
        spp = page.shape[2] if page.ndim == 3 else 1
        px = page.reshape(h, w, spp)
        item = px.dtype.itemsize
        if subsampling and compression != 7:
            # YCbCr data units: (h/v rows, w/h units a row, h*v + 2 samples a unit)
            sh, sv = subsampling
            ny, nx = -(-h // sv), -(-w // sh)
            full = np.zeros((ny * sv, nx * sh, 3), px.dtype)
            full[:h, :w] = px
            full[h:] = full[h - 1:h]
            full[:, w:] = full[:, w - 1:w]
            luma = full[..., 0].reshape(ny, sv, nx, sh).transpose(0, 2, 1, 3).reshape(ny, nx, -1)
            px = np.concatenate([luma, full[::sv, ::sh, 1:]], -1).reshape(ny, -1, 1)
        planes = [px] if planar == 1 else [px[..., c:c + 1] for c in range(spp)]
        blocks = []
        for plane in planes:
            if tile:
                tw, th = tile
                ny, nx = -(-h // th), -(-w // tw)
                padded = np.zeros((ny * th, nx * tw, plane.shape[2]), px.dtype)
                padded[:h, :w] = plane
                blocks += [padded[y * th:(y + 1) * th, x * tw:(x + 1) * tw]
                           for y in range(ny) for x in range(nx)]
            else:
                rps = rows_per_strip or h
                step = rps // subsampling[1] if subsampling and compression != 7 else rps
                blocks += [plane[y:y + step] for y in range(0, plane.shape[0], step)]
        blocks_of.append(len(blocks))
        raw_blocks += blocks
        for block in blocks:
            row_bytes = block.shape[1] * block.shape[2] * item
            if bits:
                packed = pack_rows(block, bits)
                jobs.append((compression, packed.tobytes(), packed.shape[1], quality))
                continue
            if predictor == 3 and compression in _PREDICTED:
                jobs.append((compression, float_difference(block).tobytes(), row_bytes, quality))
                continue
            if predictor == 2 and compression in _PREDICTED:  # as libtiff applies it
                u = np.ascontiguousarray(block).view(f"u{item}")
                block = np.concatenate([u[:, :1], u[:, 1:] - u[:, :-1]], axis=1)
            raw = np.ascontiguousarray(block).astype(block.dtype.newbyteorder(order)).tobytes()
            jobs.append((compression, raw, row_bytes, quality))
    if encode_fn:
        encoded = [encode_fn(b[..., 0]) for b in raw_blocks]
    else:
        encoded = [jpeg_fn(b) for b in raw_blocks] if jpeg_fn else list(map_fn(encode_chunk, jobs))
    if fill_order == 2:
        encoded = [reverse_bits(c) for c in encoded]
    encoded = iter(encoded)
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
        tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits or item * 8] * spp),
                (259, 3, [compression]),
                (262, 3, [photometric if photometric is not None
                          else 3 if colormap is not None else 2 if spp >= 3 else 1]),
                (277, 3, [spp]), (284, 3, [planar]),
                (339, 3, [fmt[page.dtype.kind]] * spp)] + list(extra_tags)
        counts = [len(c) for c in chunks]
        if tile:
            tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 16 if big else 4, offsets),
                     (325, 16 if big else 4, counts)]
        else:
            tags += [(273, 16 if big else 4, offsets), (278, 4, [rps]),
                     (279, 16 if big else 4, counts)]
        if predictor != 1:
            tags.append((317, 3, [predictor]))
        if fill_order != 1:
            tags.append((266, 3, [fill_order]))
        if colormap is not None:
            tags.append((320, 3, np.asarray(colormap).reshape(-1).tolist()))
        if extra_samples is not None:
            tags.append((338, 3, [extra_samples]))
        if subsampling:
            tags.append((530, 3, list(subsampling)))
        if compression == 7 and jpeg_fn is None:
            from _jpeg_writer import jpeg_tables

            tags.append((347, 7, list(jpeg_tables(quality or 75))))
        tags.sort()
        codes = {3: "H", 4: "I", 5: "II", 7: "B", 16: "Q"}
        inline = 8 if big else 4
        entries = b""
        values = bytearray()
        n_entry = 20 if big else 12
        head = struct.calcsize(order + ("Q" if big else "H"))
        ifd = len(out) + len(out) % 2
        out += b"\0" * (ifd - len(out))
        spill = ifd + head + n_entry * len(tags) + inline
        for tag, typ, vals in tags:
            flat = [v for pair in vals for v in pair] if typ == 5 else vals
            raw = struct.pack(order + codes[typ] * len(vals), *flat)
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


# ---- editing a written file's IFDs (damaged and minimal pages) ---------------

_TYPE_CODES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q", 17: "q"}
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
               13: 4, 16: 8, 17: 8, 18: 8}


def _layout(data):
    """(byte order, BigTIFF, count format, entry size, value size)."""
    order = "<" if data[:2] == b"II" else ">"
    big = struct.unpack_from(order + "H", data, 2)[0] == 43
    return order, big, ("Q", 20, 8) if big else ("H", 12, 4)


def ifd_offsets(data) -> list:
    """The offsets of a TIFF's IFDs, following the chain (to a loop or the
    file's end)."""
    order, big, (count, entry, value) = _layout(data)
    (ifd,) = struct.unpack_from(order + ("Q" if big else "I"), data, 8 if big else 4)
    out = []
    while ifd and ifd not in out and ifd + struct.calcsize(count) <= len(data):
        out.append(ifd)
        (n,) = struct.unpack_from(order + count, data, ifd)
        at = ifd + struct.calcsize(count) + entry * n
        if at + value > len(data):
            break
        (ifd,) = struct.unpack_from(order + ("Q" if big else "I"), data, at)
    return out


def ifd_entries(data, ifd) -> dict:
    """{tag: (where the entry is, type, count, where its values are)} of the
    IFD at ``ifd``."""
    order, big, (count, entry, value) = _layout(data)
    (n,) = struct.unpack_from(order + count, data, ifd)
    base = ifd + struct.calcsize(count)
    out = {}
    for i in range(n):
        at = base + entry * i
        tag, typ, cnt = struct.unpack_from(order + ("HHQ" if big else "HHI"), data, at)
        where = at + entry - value
        if _TYPE_SIZES.get(typ, 1) * cnt > value:
            (where,) = struct.unpack_from(order + ("Q" if big else "I"), data, where)
        out[tag] = (at, typ, cnt, where)
    return out


def tag_values(data, ifd, tag) -> list:
    """The integer values of ``tag`` in the IFD at ``ifd``."""
    order = _layout(data)[0]
    _, typ, cnt, where = ifd_entries(data, ifd)[tag]
    return list(struct.unpack_from(order + _TYPE_CODES[typ] * cnt, data, where))


def set_tag(data: bytearray, ifd, tag, values) -> None:
    """Overwrite ``tag``'s integer values in place (as many as it holds)."""
    order = _layout(data)[0]
    _, typ, cnt, where = ifd_entries(data, ifd)[tag]
    struct.pack_into(order + _TYPE_CODES[typ] * len(values), data, where, *values)


def drop_tag(data: bytearray, ifd, tag) -> None:
    """Remove ``tag``'s entry from the IFD at ``ifd`` (the entries after it
    and the next-IFD offset move up; the count drops by one)."""
    order, big, (count, entry, value) = _layout(data)
    (n,) = struct.unpack_from(order + count, data, ifd)
    end = ifd + struct.calcsize(count) + entry * n + value
    at = ifd_entries(data, ifd)[tag][0]
    data[at:end - entry] = data[at + entry:end]
    struct.pack_into(order + count, data, ifd, n - 1)


def set_entry_count(data: bytearray, ifd, n) -> None:
    """Overwrite the IFD's count of entries."""
    order, _, (count, _, _) = _layout(data)
    struct.pack_into(order + count, data, ifd, n)


def set_next_ifd(data: bytearray, ifd, target) -> None:
    """Point the IFD's next-IFD offset at ``target``."""
    order, big, (count, entry, value) = _layout(data)
    (n,) = struct.unpack_from(order + count, data, ifd)
    struct.pack_into(order + ("Q" if big else "I"), data,
                     ifd + struct.calcsize(count) + entry * n, target)
