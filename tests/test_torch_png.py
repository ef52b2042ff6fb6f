"""Damaged PNG streams (C16), read by the port on the CPU: each reader
follows its own oracle, exactly (tolerance 0).  ``imread`` reads as the
JAX package's ``cli._load_array`` (PIL's ``PngImagePlugin``: the CRC of
every chunk before the first IDAT checked, none after; the image data
inflated piece by piece only until its last row; a file that ends after
its image data read), ``imread_gray`` as its ``datasets._imread_gray``
(cv2's libpng: a critical chunk failing its CRC, a chunk cut short or a
missing IEND read nothing, an ancillary chunk failing its CRC dropped;
then PIL's default image).  Each case holds both readers to the oracle's
array, or to a ValueError naming the file where the oracle raises; no
``struct.error`` or ``zlib.error`` escapes.
"""

import io
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.data.imread import imread, imread_gray

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL's own Image.MAX_IMAGE_PIXELS, the limit the port keeps; the JAX
# package's curation.tiles lifts it when imported, as another test in the
# same process may do
PIL_MAX_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append([data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]])
        pos += 12 + n
    return out


def _png(chunks, flip=()):
    """A PNG of (type, data) ``chunks``, the CRC of those at ``flip``
    broken."""
    out = SIGNATURE
    for i, (cid, body) in enumerate(chunks):
        crc = zlib.crc32(body, zlib.crc32(cid)) ^ (1 if i in flip else 0)
        out += struct.pack(">I", len(body)) + cid + body + struct.pack(">I", crc)
    return out


def _pil_png(arr, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", **kw)
    return buf.getvalue()


def _ihdr(w, h, depth=8, color=0):
    return [b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)]


def _stored(rows):
    """A zlib stream of stored blocks (its bytes where we put them)."""
    co = zlib.compressobj(0)
    return co.compress(rows) + co.flush()


def _cases():
    rng = np.random.default_rng(0)
    grey = rng.integers(0, 256, (30, 40), np.uint8)
    base = _chunks(_pil_png(grey))
    ihdr, idat, iend = base
    raw = zlib.decompress(idat[1])
    text = [b"tEXt", b"k\0v"]
    bad_adler = bytearray(idat[1])
    bad_adler[-1] ^= 1
    idx = rng.integers(0, 16, (30, 40), np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 48, np.uint8).tobytes())
    buf = io.BytesIO()
    im.save(buf, "PNG")
    pal = _chunks(buf.getvalue())
    frames = [Image.fromarray(rng.integers(0, 256, (30, 40), np.uint8)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:])
    apng = _chunks(buf.getvalue())

    def at(chunks, cid, k=0):
        return [i for i, c in enumerate(chunks) if c[0] == cid][k]
    fdat = bytearray(apng[at(apng, b"fdAT")][1])
    fdat[-1] ^= 1
    apng_adler = [list(c) for c in apng]
    apng_adler[at(apng, b"fdAT")][1] = bytes(fdat)
    # an APNG whose default image is not a frame: IDAT before the first fcTL
    sep = [ihdr, [b"acTL", struct.pack(">II", 2, 0)], idat]
    for k, f in enumerate(frames[:2]):
        rows = np.hstack([np.zeros((30, 1), np.uint8), np.asarray(f)]).tobytes()
        sep += [[b"fcTL", struct.pack(">IIIIIHHBB", 2 * k, 40, 30, 0, 0, 1, 10, 0, 0)],
                [b"fdAT", struct.pack(">I", 2 * k + 1) + zlib.compress(rows)]]
    sep.append(iend)
    # stored deflate whose last row ends at byte 8192 (libpng's read size)
    # or 16384 of the chunk: a bad Adler-32 after it reaches only PIL, or
    # neither reader

    def zeros(rows, size):
        """A zlib stream of ``rows`` rows of ``size`` zero bytes."""
        co = zlib.compressobj()
        return b"".join(co.compress(bytes(size)) for _ in range(rows)) + co.flush()

    def animated(sizes):
        """An APNG of frames of zeros of (w, h) ``sizes``, the first the
        default image."""
        out = [ihdr, [b"acTL", struct.pack(">II", len(sizes), 0)]]
        for k, (fw, fh) in enumerate(sizes):
            rows = zlib.compress(bytes(max(fh, 1) * (max(fw, 1) + 1)))
            out.append([b"fcTL", struct.pack(">IIIIIHHBB", max(0, 2 * k - 1), fw, fh, 0, 0, 1,
                                             10, 0, 0)])
            out.append([b"IDAT", rows] if k == 0 else [b"fdAT", struct.pack(">I", 2 * k) + rows])
        return out + [iend]
    wide = b"".join(b"\0" + rng.integers(0, 256, 1636, np.uint8).tobytes() for _ in range(5))
    w8192 = bytearray(_stored(wide))
    w8192[-1] ^= 1
    return {
        "ihdr_crc": _png(base, flip=(0,)),
        "text_crc_before_idat": _png([ihdr, text, idat, iend], flip=(1,)),
        "idat_crc": _png(base, flip=(1,)),
        "iend_crc": _png(base, flip=(2,)),
        "short_6_bytes": _png(base)[:-6],
        "no_iend": _png(base)[:-12],
        "iend_without_crc": _png(base)[:-4],
        "cut_in_idat": _png(base)[:33 + 8 + len(idat[1]) // 2],
        "adler32": _png([ihdr, [b"IDAT", bytes(bad_adler)], iend]),
        "adler32_in_its_own_idat": _png([ihdr, [b"IDAT", bytes(bad_adler[:-4])],
                                         [b"IDAT", bytes(bad_adler[-4:])], iend]),
        "junk_after_zlib_end": _png([ihdr, [b"IDAT", idat[1] + b"junkjunk"], iend]),
        "extra_rows": _png([ihdr, [b"IDAT", zlib.compress(raw + raw[:123])], iend]),
        "stream_ends_at_a_row": _png([ihdr, [b"IDAT", zlib.compress(raw[:41 * 20])], iend]),
        "stream_ends_in_a_row": _png([ihdr, [b"IDAT", zlib.compress(raw[:41 * 20 + 7])], iend]),
        "text_crc_after_idat": _png([ihdr, idat, text, iend], flip=(2,)),
        "text_cut_after_idat": _png([ihdr, idat]) + struct.pack(">I", 100) + b"tEXtabc",
        "text_between_idats": _png([ihdr, [b"IDAT", idat[1][:50]], text,
                                    [b"IDAT", idat[1][50:]], iend]),
        "second_idat_crc": _png([ihdr, [b"IDAT", idat[1][:50]], [b"IDAT", idat[1][50:]], iend],
                                flip=(2,)),
        "empty_idat_between": _png([ihdr, [b"IDAT", idat[1][:50]], [b"IDAT", b""],
                                    [b"IDAT", idat[1][50:]], iend]),
        "idat_after_image_cut": _png([ihdr, idat, [b"IDAT", b"x" * 100], iend])[:-60],
        "bad_chunk_type": _png([ihdr, [b"t$Xt", b"abc"], idat, iend]),
        "private_chunk_crc": _png([ihdr, [b"prVt", b"abc"], idat, iend], flip=(1,)),
        "unknown_critical_chunk": _png([ihdr, [b"ABCD", b"xy"], idat, iend]),
        "filter_method": _png([[b"IHDR", ihdr[1][:11] + b"\1" + ihdr[1][12:]], idat, iend]),
        "ihdr_short": _png([[b"IHDR", ihdr[1][:12]], idat, iend]),
        "no_idat": _png([ihdr, iend]),
        "trailing_garbage": _png(base) + b"garbage!",
        "plte_crc": _png(pal, flip=(1,)),
        "trns_crc": _png(pal[:2] + [[b"tRNS", bytes(3)]] + pal[2:], flip=(2,)),
        "apng_actl_crc": _png(apng, flip=(at(apng, b"acTL"),)),
        "apng_first_fctl_crc": _png(apng, flip=(at(apng, b"fcTL"),)),
        "apng_later_fctl_crc": _png(apng, flip=(at(apng, b"fcTL", 1),)),
        "apng_fdat_crc": _png(apng, flip=(at(apng, b"fdAT"),)),
        "apng_idat_crc": _png(apng, flip=(at(apng, b"IDAT"),)),
        "apng_fdat_adler32": _png(apng_adler),
        "apng_cut_in_last_frame": _png(apng)[:-40],
        "apng_default_image_apart": _png(sep),
        "apng_default_image_apart_fdat_crc": _png(sep, flip=(4,)),
        "apng_default_image_apart_fctl_crc": _png(sep, flip=(3,)),
        "adler32_after_8192_bytes": _png([_ihdr(1636, 5), [b"IDAT", bytes(w8192)], iend]),
        # sizes PIL refuses from the header, every CRC right
        "width_0": _png([_ihdr(0, 30), idat, iend]),
        "height_0": _png([_ihdr(40, 0), idat, iend]),
        "height_2_31": _png([_ihdr(40, 2 ** 31 - 1), idat, iend]),
        "width_2_32": _png([_ihdr(2 ** 32 - 1, 1), idat, iend]),
        # a height over libpng's limit (cv2 reads nothing) and under PIL's
        "height_over_libpng": _png([_ihdr(1, 1000001), [b"IDAT", zlib.compress(bytes(2000002))],
                                    iend]),
        # over PIL's pixel limit and under cv2's: cv2 reads it, PIL refuses
        "over_pil_pixels": _png([_ihdr(13380, 13380), [b"IDAT", zeros(13380, 13381)], iend]),
        "apng_frame_width_0": _png(animated([(40, 30), (0, 30)])),
        "apng_frame_height_0": _png(animated([(40, 30), (40, 0)])),
        "apng_first_frame_width_0": _png(animated([(0, 30), (40, 30)])),
        "apng_frames_of_zeros": _png(animated([(40, 30), (20, 10)])),
    }


CASES = _cases()


def _oracle(read, path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return read(path)
        except Exception:  # PIL's SyntaxError, OSError, ValueError; cv2's None then PIL's
            return None


@pytest.mark.parametrize("case", list(CASES))
def test_damaged_png_reads_as_each_oracle(case, tmp_path, monkeypatch):
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", PIL_MAX_PIXELS)
    path = str(tmp_path / f"{case}.png")
    with open(path, "wb") as f:
        f.write(CASES[case])
    for read, oracle in ((imread, jax_load), (imread_gray, jax_gray)):
        want = _oracle(oracle, path)
        if want is None:
            with pytest.raises(ValueError, match=case):
                read(path)
            continue
        got = read(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (read.__name__, got.shape,
                                                                      want.shape)
        np.testing.assert_array_equal(got, want)


def test_cases_part_the_oracles():
    """The corpus reaches each way the two oracles part: PIL raising where
    cv2 reads, cv2 reading nothing where PIL reads, both reading."""
    import cv2

    seen = set()
    for case, data in CASES.items():
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        try:
            Image.open(io.BytesIO(data)).load()
            pil = True
        except Exception:
            pil = False
        seen.add((pil, arr is not None))
    assert seen == {(True, True), (True, False), (False, True), (False, False)}


def _row_by_row(chunks, piece, sizes):
    """PIL's ZipDecode loop as it stands: each chunk in pieces, inflate
    called a row at a time while the piece lasts; (rows' bytes, rows,
    chunk of the last row), or None where it raises."""
    d, rows, row = zlib.decompressobj(), [], bytearray()
    try:
        for k, chunk in enumerate(chunks):
            for s in range(0, len(chunk), piece):
                data = bytes(chunk[s:s + piece])
                while data:
                    row += d.decompress(data, sizes[len(rows)] - len(row))
                    data = d.unconsumed_tail
                    if len(row) < sizes[len(rows)]:
                        break
                    rows.append(bytes(row))
                    row = bytearray()
                    if len(rows) == len(sizes) or d.eof:
                        return b"".join(rows), len(rows), k
    except zlib.error:
        pass
    return None


def test_inflate_takes_pieces_as_the_oracles():
    """``_png_inflate`` (most rows in one call, the last row by row) against
    the oracles' loop literally, on seeded streams: rows of extra, missing
    or cut data, bad Adler-32s, junk after the end, flipped bits, split
    into chunks and pieces of every size."""
    from empanada_tpu_torch.data.imread import _png_inflate

    rng = np.random.default_rng(7)
    for trial in range(1500):
        n, w = int(rng.integers(1, 40)), int(rng.integers(1, 200))
        sizes = [w + 1] * n
        extra = int(rng.choice([0, 0, 5, -w - 1, -3]))
        raw = (rng.integers(0, 256, n * (w + 1) + extra) * (rng.random(n * (w + 1) + extra) < 0.5))
        z = bytearray(zlib.compress(raw.astype(np.uint8).tobytes(), int(rng.choice([0, 1, 6]))))
        kind = trial % 5
        if kind == 1:
            z[-1 - int(rng.integers(0, 4))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            z = z[:int(rng.integers(1, len(z) + 1))]
        elif kind == 3:
            z += rng.integers(0, 256, int(rng.integers(1, 9)), np.uint8).tobytes()
        elif kind == 4 and len(z) > 4:
            z[int(rng.integers(2, len(z)))] ^= 1 << int(rng.integers(0, 8))
        cuts = np.sort(rng.integers(0, len(z) + 1, int(rng.integers(0, 4)))).tolist()
        chunks = [memoryview(bytes(z[a:b])) for a, b in zip([0] + cuts, cuts + [len(z)])]
        piece = int(rng.choice([1, 3, 7, 64, 257, 4096]))
        want = _row_by_row(chunks, piece, sizes)
        try:
            raw_rows, rows, last = _png_inflate(chunks, piece, [(n, w + 1)], "x")
            got = (bytes(raw_rows), rows, last)
        except ValueError:
            got = None
        assert got == want, (trial, piece, [len(c) for c in chunks])
