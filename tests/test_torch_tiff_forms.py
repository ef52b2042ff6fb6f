"""The TIFF forms the port reads since its bilevel slice, held bit for bit
to the JAX package's two readers on the CPU (``cli._load_array``: PIL 12.1;
``datasets._imread_gray``: cv2 5.0, then PIL where cv2 reads nothing):

- 1-, 2- and 4-bit grey, min-is-white and min-is-black, uncompressed,
  LZW, Deflate and PackBits, in strips and tiles, either byte order and
  FillOrder; CCITT RLE (compression 2) and RLEW (32771, rows on 16-bit
  words), Group 3 1D and 2D (with and without fill bits before each EOL)
  and Group 4 (T.6), FillOrder 1 and 2,
  strips and tiles (their streams libtiff's, through PIL), and damaged
  copies of them (bits flipped, counts cut, bytes replaced), every CCITT
  code class counted over the corpus;
- int8 and uint32 samples, grey + alpha of 8 and 16 bits (each
  ExtraSamples value), grey of three samples, 16-bit CMYK and CIELab;
- C17: pages PIL or cv2 reads that the port once refused or misread
  (tags missing, counts cut or wrong, damaged strips, IFD chains that
  loop, files cut short), and the same in tiles, BigTIFF, big-endian
  files, a later page of a stack and SamplesPerPixel against
  BitsPerSample; every such file cut short at every strip, tile and IFD
  field raises ValueError, never another exception.

Every comparison is exact: dtype, shape and samples; "raises" is a
ValueError where the oracle raises.
"""

import itertools

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

import empanada_tpu.data.datasets as JD
from _tiff_writer import (
    drop_tag,
    ifd_entries,
    ifd_offsets,
    set_entry_count,
    set_next_ifd,
    set_tag,
    tag_values,
    tiff_bytes,
)
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import imread as R
from empanada_tpu_torch.data.imread import imread, imread_gray

jax_gray = JD._imread_gray
# the reason the port's imread refuses a Group 4 strip that ends early:
# libtiff reads it without error, and PIL's rows after it are memory it
# never set (two processes' arrays differ)
NEVER_SET = "memory it never set"


def _held(path, never_set_ok=False):
    """``imread`` equals ``cli._load_array`` and ``imread_gray`` equals
    ``datasets._imread_gray`` (dtype, shape, samples), or raises ValueError
    where the oracle raises.  ``never_set_ok``: ``imread`` may refuse a
    Group 4 strip that ends early (PIL's array is then memory it never
    set)."""
    for ours, oracle in ((imread, jax_load), (imread_gray, jax_gray)):
        try:
            want = oracle(path)
        except Exception:
            with pytest.raises(ValueError):
                ours(path)
            continue
        if never_set_ok and ours is imread:
            try:
                got = ours(path)
            except ValueError as exc:
                assert NEVER_SET in str(exc), exc
                continue
        else:
            got = ours(path)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), (ours.__name__, path)
        np.testing.assert_array_equal(got, want, err_msg=f"{ours.__name__} {path}")


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def test_pil_modes_are_pils():
    """The port's table of the pages PIL opens is PIL's OPEN_INFO over the
    forms the port reads: every key it holds maps to PIL's mode, and every
    key of PIL's within those forms is in it."""
    order = {b"II": "<", b"MM": ">"}
    read_bits = {(1,), (2,), (4,), (8,), (16,), (32,), (8, 8), (8,) * 3, (8,) * 4, (16,) * 3,
                 (16,) * 4}
    seen = 0
    for (prefix, photo, fmt, fill, bits, extra), (mode, _) in TiffImagePlugin.OPEN_INFO.items():
        key = (order[prefix], photo, fmt, fill, bits, extra)
        ours = R._PIL_TIFF_MODES.get(key)
        if ours is not None:
            assert ours == mode, key
            seen += 1
        elif photo in (0, 1, 2, 3, 5, 6, 8) and bits in read_bits:
            # PIL's forms the port does not read: a palette with a second
            # sample, one-sample YCbCr
            assert (photo, bits) in ((3, (8, 8)), (6, (8,))), key
    assert seen == len(R._PIL_TIFF_MODES)


# ---- 1-, 2- and 4-bit grey -------------------------------------------------------

SUB_BYTE = list(itertools.product((1, 2, 4), (0, 1), (1, 5, 8, 32773)))


@pytest.mark.parametrize("tile", [None, (16, 16)], ids=["strips", "tiles"])
@pytest.mark.parametrize("bits,photometric,compression", SUB_BYTE,
                         ids=[f"b{b}-p{p}-c{c}" for b, p, c in SUB_BYTE])
def test_sub_byte_grey(bits, photometric, compression, tile, tmp_path):
    """Levels packed most significant first, each row from a byte; PIL gives
    1 bit as bool (inverted for min-is-white) and 2 and 4 bits scaled to 8;
    cv2 scales 1 bit to 0/255 and reads no 2- or 4-bit page (the JAX
    package then takes PIL's array).  Both byte orders and FillOrders."""
    rng = np.random.default_rng(bits * 100 + photometric * 10 + compression % 7)
    levels = rng.integers(0, 1 << bits, (19, 37)).astype(np.uint8)
    for order, fill in itertools.product("<>", (1, 2)):
        path = _write(tmp_path, f"s{order == '>'}{fill}.tif", tiff_bytes(
            [levels, levels[::-1]], compression, tile=tile, rows_per_strip=None if tile else 5,
            order=order, bits=bits, photometric=photometric, fill_order=fill))
        _held(path)
        want = (levels * (255 // ((1 << bits) - 1))).astype(np.uint8)
        if photometric == 0:
            want = 255 - want
        np.testing.assert_array_equal(imread(path)[0], want.astype(bool) if bits == 1 else want)


def test_eight_bit_fill_order_2(tmp_path):
    """FillOrder 2 at 8 and 16 bits: each byte's bits reversed, as libtiff
    reverses a strip's bytes; PIL has no unpacker for uncompressed 8-bit
    min-is-white of FillOrder 2 and opens no such page, and cv2 reads no
    uncompressed tile of it (libtiff refuses its byte counts)."""
    rng = np.random.default_rng(2)
    page8 = rng.integers(0, 256, (11, 19)).astype(np.uint8)
    page16 = rng.integers(0, 65536, (11, 19)).astype(np.uint16)
    for page, compression, tile, photometric in itertools.product(
            (page8, page16), (1, 5), (None, (16, 16)), (0, 1)):
        if page.dtype == np.uint16 and photometric == 0:
            continue
        path = _write(tmp_path, "f2.tif", tiff_bytes([page], compression, tile=tile,
                                                     fill_order=2, photometric=photometric))
        _held(path)


def test_predictor_with_sub_byte_samples_is_refused(tmp_path):
    """libtiff applies no horizontal differencing to 2-bit samples: both
    oracles raise, and so does the port."""
    levels = np.random.default_rng(3).integers(0, 4, (11, 19)).astype(np.uint8)
    path = _write(tmp_path, "p.tif", tiff_bytes([levels], 8, predictor=2, bits=2))
    _held(path)
    with pytest.raises(ValueError, match="predictor 2, bits"):
        imread(path)


# ---- CCITT -------------------------------------------------------------------

# (PIL's compression, tiffinfo, TIFF compression, T4Options)
CCITT = [("tiff_ccitt", {}, 2, 0), ("group3", {}, 3, 0), ("group3", {292: 1}, 3, 1),
         ("group3", {292: 4}, 3, 4), ("group3", {292: 5}, 3, 5), ("group4", {}, 4, 0),
         ("group3", {292: 1, 266: 2}, 3, 1), ("group4", {266: 2}, 4, 0),
         ("tiff_ccitt", {266: 2}, 2, 0), ("tiff_raw_16", {}, 32771, 0),
         ("tiff_raw_16", {266: 2}, 32771, 0)]
CCITT_IDS = [f"c{c}-t4_{t}-f{info.get(266, 1)}" for _, info, c, t in CCITT]


def _masks(seed):
    """Bilevel pages that reach every code: noise, sparse dots, stripes,
    and rows of 2700 pixels whose runs pass 2560 (the extended make-up
    codes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:24, :2700]
    wide = ((xx // 1900 + yy // 7) % 2 == 0) ^ (rng.random((24, 2700)) > 0.999)
    blob = np.hypot(yy - 12, xx - 1400) < 1300
    return {"noise": rng.random((23, 37)) > 0.5, "sparse": rng.random((19, 300)) > 0.97,
            "stripes": np.repeat((np.arange(61) % 3 == 0)[None], 17, 0),
            "wide": wide, "blob": blob, "one": np.ones((5, 1), bool)}


def _pil_ccitt(tmp_path, mask, pil_compression, info, name="pil.tif"):
    path = tmp_path / name
    Image.fromarray(mask).save(path, compression=pil_compression, tiffinfo=info)
    return str(path)


def _ccitt_block(tmp_path, pil_compression, info):
    """A tile's CCITT stream as libtiff writes it (through PIL): the one
    strip of a page of the tile's size, bits as the tile holds them."""
    def encode(block):
        path = _pil_ccitt(tmp_path, block.astype(bool), pil_compression,
                          {**info, 278: block.shape[0]}, "block.tif")
        data = open(path, "rb").read()
        ifd = ifd_offsets(data)[0]
        (offset,), (count,) = tag_values(data, ifd, 273), tag_values(data, ifd, 279)
        return data[offset:offset + count]
    return encode


@pytest.mark.parametrize("pil_compression,info,compression,t4", CCITT, ids=CCITT_IDS)
def test_ccitt_pil_written(pil_compression, info, compression, t4, tmp_path):
    """Each mask as libtiff encodes it, in strips of 7 rows; and each page
    made min-is-white (the same bits, both readers invert them).  libtiff
    does not read its own RLEW rows back as it wrote them (its decoder
    aligns each row to a word of the strip): held to the oracles alone."""
    for name, mask in _masks(compression + t4).items():
        path = _pil_ccitt(tmp_path, mask, pil_compression, {**info, 278: 7}, f"{name}.tif")
        _held(path)
        if compression != 32771:
            np.testing.assert_array_equal(imread(path), mask)
        data = bytearray(open(path, "rb").read())
        set_tag(data, ifd_offsets(data)[0], 262, [0])
        _held(_write(tmp_path, f"{name}-white.tif", data))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("pil_compression,info,compression,t4", CCITT[:-1:2],
                         ids=CCITT_IDS[:-1:2])
def test_ccitt_tiles(pil_compression, info, compression, t4, order, tmp_path):
    """CCITT tiles (libtiff's streams of each tile, the edge tiles padded),
    in either byte order."""
    mask = _masks(9)["noise"]
    extra = [(292, 4, [t4])] if compression == 3 else []
    path = _write(tmp_path, "t.tif", tiff_bytes(
        [mask.astype(np.uint8)], compression, tile=(16, 16), order=order, bits=1,
        extra_tags=extra, fill_order=info.get(266, 1),
        encode_fn=_ccitt_block(tmp_path, pil_compression, {k: v for k, v in info.items()
                                                             if k != 266})))
    _held(path)
    if compression != 32771:
        np.testing.assert_array_equal(imread(path), mask)


def test_ccitt_rlew_tiles(tmp_path):
    """CCITT RLEW tiles: cv2's libtiff reads them as the port's
    ``imread_gray`` does; PIL's reads their rows otherwise, by no rule
    found, and ``imread`` refuses them by name."""
    mask = _masks(9)["noise"]
    path = _write(tmp_path, "t.tif", tiff_bytes(
        [mask.astype(np.uint8)], 32771, tile=(16, 16), bits=1,
        encode_fn=_ccitt_block(tmp_path, "tiff_raw_16", {})))
    got, want = imread_gray(path), jax_gray(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="CCITT RLEW tiles"):
        imread(path)


def test_ccitt_code_classes_are_reached(tmp_path):
    """Over the corpus (every mask in every CCITT form), the decoder reads
    every code class: pass, horizontal, V0, VR1-3, VL1-3, terminating,
    make-up and extended make-up codes (runs of 1792 and more) and EOLs."""
    stats = np.zeros(len(native.CCITT_STATS), np.int64)
    for (pil_compression, info, compression, t4), (name, mask) in itertools.product(
            [form for form in CCITT if form[2] != 32771], _masks(5).items()):
        path = _pil_ccitt(tmp_path, mask, pil_compression, info)
        data = open(path, "rb").read()
        ifd = ifd_offsets(data)[0]
        h, w = mask.shape
        fill = info.get(266, 1)
        runs = native.ccitt_runs(w, compression, t4)
        state = np.zeros(1, np.int32)
        rps = tag_values(data, ifd, 278)[0]
        for k, (offset, count) in enumerate(zip(tag_values(data, ifd, 273),
                                                tag_values(data, ifd, 279))):
            src = R._reverse_bits(data[offset:offset + count]) if fill == 2 else \
                data[offset:offset + count]
            rows = min(rps, h - k * rps)
            out, got = native.ccitt_decode(src, compression, w, rows, t4, state, runs, stats)
            assert got == rows * ((w + 7) // 8), (name, compression, t4)
    counts = dict(zip(native.CCITT_STATS, stats.tolist()))
    assert counts.pop("bad code") == 0, counts
    assert min(counts.values()) > 0, counts


def _damaged(data, rng, kind):
    """``data`` with one strip damaged: bits flipped, its count cut, or a
    span of its bytes replaced."""
    data = bytearray(data)
    ifd = ifd_offsets(data)[0]
    offsets, counts = tag_values(data, ifd, 273), tag_values(data, ifd, 279)
    s = int(rng.integers(len(offsets)))
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            data[offsets[s] + int(rng.integers(counts[s]))] ^= 1 << int(rng.integers(8))
    elif kind == 1:
        counts[s] = int(rng.integers(0, counts[s]))
        set_tag(data, ifd, 279, counts)
    else:
        at = offsets[s] + int(rng.integers(counts[s]))
        end = min(offsets[s] + counts[s], at + int(rng.integers(1, 20)))
        data[at:end] = rng.integers(0, 256, end - at).astype(np.uint8).tobytes()
    return data


@pytest.mark.parametrize("pil_compression,info,compression,t4", CCITT, ids=CCITT_IDS)
def test_ccitt_damaged(pil_compression, info, compression, t4, tmp_path):
    """Damaged CCITT strips as libtiff reads them: a code no table holds
    ends its row (cleaned up to the row's width) and decoding goes on; an
    end of data fills the row and fails the strip (PIL raises; cv2's RGBA
    path leaves the rest 0), except that Group 3 data whose EOL is cut
    reads again from the strip's start without EOLs, and that a Group 4
    strip that ends early reads without error (cv2's rows after it 0,
    PIL's memory it never set: the port's ``imread`` refuses it)."""
    rng = np.random.default_rng(compression * 10 + t4 + 100 * info.get(266, 1))
    for (name, mask), kind in itertools.product(list(_masks(3).items())[:5], range(3)):
        path = _pil_ccitt(tmp_path, mask, pil_compression, {**info, 278: 9 if kind else 24})
        damaged = _damaged(open(path, "rb").read(), rng, kind)
        _held(_write(tmp_path, f"{name}-{kind}.tif", damaged), never_set_ok=compression == 4)


def test_ccitt_decoder_rules(tmp_path):
    """Hand-made Group 3 1D streams pin libtiff's rules where PIL's writer
    never goes: after the last row the data ends (later rows white), and a
    strip whose next EOL is cut reads again from its start without EOLs,
    so that the rows after it repeat the stream's codes."""
    def bits(s):
        s = s.replace(" ", "")
        s += "0" * (-len(s) % 8)
        return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))
    eol, white8, black8, white0 = "000000000001", "10011", "000101", "00110101"
    for stream, h in ((eol + white8, 4), (eol + white8 + eol + white8, 6),
                      (eol + white0 + black8 + eol + white8, 5), (eol + "0100111" + "0011", 5)):
        w = 24 if stream.endswith("0011") else 8
        data = bytearray(tiff_bytes([np.zeros((h, w), np.uint8)], 1, bits=1,
                                    encode_fn=lambda block, b=bits(stream): b,
                                    extra_tags=[(292, 4, [0])]))
        set_tag(data, ifd_offsets(data)[0], 259, [3])
        _held(_write(tmp_path, "g3.tif", data))


# ---- int8, uint32, grey + alpha and the other sample forms ---------------------

CODECS = [(1, 1), (5, 2), (8, 2), (32773, 1), (34925, 1)]


@pytest.mark.parametrize("tile", [None, (16, 16)], ids=["strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression,predictor", CODECS, ids=[f"c{c}-p{p}" for c, p in CODECS])
def test_int8_and_uint32(compression, predictor, order, tile, tmp_path):
    """int8 (PIL: the same bits as uint8; cv2: int8) with negative values,
    and uint32 with ids past 2^31 (PIL: the same bits as int32, and no
    big-endian page; cv2: uint32)."""
    rng = np.random.default_rng(compression + predictor)
    i8 = rng.integers(-128, 128, (19, 37)).astype(np.int8)
    u32 = rng.integers(0, 1 << 32, (19, 37), dtype=np.uint64).astype(np.uint32)
    u32[0, :3] = (1 << 31, (1 << 32) - 1, 65536)
    for page in (i8, u32):
        path = _write(tmp_path, f"{page.dtype}.tif", tiff_bytes(
            [page, page[::-1]], compression, predictor, tile, None if tile else 8, order=order))
        _held(path)
        if compression != 34925:
            np.testing.assert_array_equal(imread_gray(path), page)


GREY_ALPHA = list(itertools.product((np.uint8, np.uint16), (None, 0, 1, 2), (0, 1)))


@pytest.mark.parametrize("dtype,extra,photometric", GREY_ALPHA,
                         ids=[f"{np.dtype(d).name}-e{e}-p{p}" for d, e, p in GREY_ALPHA])
def test_grey_alpha(dtype, extra, photometric, tmp_path):
    """Grey + alpha: PIL opens 8-bit min-is-black of unassociated alpha
    alone, as (H, W, 2); cv2 gives the grey plane (its high byte at 16 bits,
    inverted for min-is-white) whatever the ExtraSamples value.  Each in
    LZW with differencing and in PackBits tiles, both byte orders."""
    rng = np.random.default_rng(photometric + (extra or 0) * 3)
    page = rng.integers(0, np.iinfo(dtype).max, (19, 37, 2), endpoint=True).astype(dtype)
    for (compression, predictor, tile), order in itertools.product(
            ((5, 2, None), (32773, 1, (16, 16)), (1, 1, None)), "<>"):
        path = _write(tmp_path, "ga.tif", tiff_bytes(
            [page], compression, predictor, tile, None if tile else 6, order=order,
            extra_samples=extra, photometric=photometric))
        _held(path)


def test_cielab_as_libtiff_converts(tmp_path):
    """CIELab: PIL's stored bytes, and cv2's libtiff RGBA of them
    (TIFFCIELab16ToXYZ against D50 or the WhitePoint tag, TIFFXYZToRGB's
    sRGB table) for every L and a spread of a and b."""
    rng = np.random.default_rng(8)
    lab = np.stack([np.repeat(np.arange(256, dtype=np.uint8), 64),
                    rng.integers(0, 256, 256 * 64), rng.integers(0, 256, 256 * 64)],
                   -1).astype(np.uint8).reshape(128, 128, 3)
    for tags in ((), ((318, 5, [(3127, 10000), (3290, 10000)]),)):
        path = _write(tmp_path, "lab.tif", tiff_bytes([lab], 8, photometric=8,
                                                      rows_per_strip=32, extra_tags=tags))
        _held(path)
        np.testing.assert_array_equal(imread(path), lab)


# ---- C17: damaged and minimal pages --------------------------------------------

def _pil_page(tmp_path, compression, dtype=np.uint8):
    """The 30 x 40 page of 8-row strips PIL writes (its IFD after the
    strips when compressed)."""
    rng = np.random.default_rng(0)
    page = np.cumsum(rng.integers(0, 256, (30, 40)) // 32, 1).astype(dtype)
    if dtype != np.uint8:
        page = (page.astype(np.uint32) * 997).astype(dtype)
    path = tmp_path / "src.tif"
    Image.fromarray(page).save(path, compression=compression, tiffinfo={278: 8})
    return bytearray(path.read_bytes())


def _short_counts(data, ifd, by, tag=279):
    set_tag(data, ifd, tag, [c - by for c in tag_values(data, ifd, tag)])


def _damage_strip(data, ifd, k, fill):
    offsets, counts = tag_values(data, ifd, 273), tag_values(data, ifd, 279)
    data[offsets[k] + 2:offsets[k] + counts[k]] = fill * (counts[k] - 2)


def _c17(kind, compression):
    """The Motivation's table: one change to PIL's 30 x 40 page."""
    def make(data):
        ifd = ifd_offsets(data)[0]
        if kind.startswith("no"):
            drop_tag(data, ifd, int(kind[2:]))
        elif kind == "short5":
            _short_counts(data, ifd, 5)
        elif kind in ("damaged0", "damagedff"):
            _damage_strip(data, ifd, 1, b"\0" if kind == "damaged0" else b"\xff")
        elif kind == "loop":
            set_next_ifd(data, ifd, ifd)
        elif kind == "cut10":
            del data[-10:]
        elif kind == "count+3":
            set_entry_count(data, ifd, len(ifd_entries(data, ifd)) + 3)
        return data
    return make


C17 = [(kind, c) for c in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits")
       for kind in ("no262", "no279", "no258", "short5", "loop", "cut10", "count+3")] + [
    (kind, c) for c in ("tiff_lzw", "tiff_adobe_deflate") for kind in ("damaged0", "damagedff")]


@pytest.mark.parametrize("kind,compression", C17, ids=[f"{k}-{c or 'raw'}" for k, c in C17])
def test_c17_pil_page(kind, compression, tmp_path):
    """A page without Photometric reads min-is-white (inverted) as PIL
    reads it (cv2 refuses it: PIL's too); without StripByteCounts PIL reads
    the uncompressed rows from each offset (libtiff refuses a page of
    several strips); without BitsPerSample both read 1 bit; a short count
    leaves uncompressed rows as they are for PIL (libtiff's RGBA path, 0)
    and compressed strips decoded as far as their data goes, then 0 (cv2;
    PIL raises); damaged LZW and Deflate strips likewise; an IFD chain that
    loops ends at the loop; a file cut short or an IFD count past its
    entries raises where the oracles raise."""
    data = _c17(kind, compression)(_pil_page(tmp_path, compression))
    path = _write(tmp_path, "c17.tif", data)
    _held(path)
    if kind == "no262":
        page = imread(path)
        np.testing.assert_array_equal(page, 255 - np.asarray(Image.open(tmp_path / "src.tif")))


def _writer_page(rng, dtype=np.uint8, shape=(37, 45), n=1, **kw):
    pages = [np.cumsum(rng.integers(0, 9, shape), 1).astype(dtype) for _ in range(n)]
    return bytearray(tiff_bytes(pages, **kw))


def _more(kind):
    """The cases the Motivation's table leaves out: (file bytes maker)."""
    def make(rng):
        if kind.startswith("tile"):  # 16 x 16 tiles of LZW or uncompressed
            comp = 1 if kind.endswith("raw") else 5
            data = _writer_page(rng, compression=comp, tile=(16, 16))
            ifd = ifd_offsets(data)[0]
            if kind.startswith("tile-short"):
                _short_counts(data, ifd, 7, 325)
            elif kind.startswith("tile-no325"):
                drop_tag(data, ifd, 325)
            elif kind.startswith("tile-damaged"):
                offsets, counts = tag_values(data, ifd, 324), tag_values(data, ifd, 325)
                data[offsets[2] + 1:offsets[2] + counts[2]] = b"\xff" * (counts[2] - 1)
            return data
        if kind.startswith("big"):  # BigTIFF, Deflate strips
            data = _writer_page(rng, np.uint16, compression=8, rows_per_strip=8, big=True)
            ifd = ifd_offsets(data)[0]
            if kind == "big-short":
                _short_counts(data, ifd, 4)
            elif kind == "big-no262":
                drop_tag(data, ifd, 262)
            elif kind == "big-cut":
                del data[-30:]
            return data
        if kind.startswith("be"):  # big-endian classic, uncompressed uint8
            data = _writer_page(rng, rows_per_strip=8, order=">")
            ifd = ifd_offsets(data)[0]
            if kind == "be-no279":
                drop_tag(data, ifd, 279)
            elif kind == "be-short":
                _short_counts(data, ifd, 3)
            return data
        if kind.startswith("stack"):  # a later page of three
            data = _writer_page(rng, n=3, compression=5, rows_per_strip=8)
            ifd = ifd_offsets(data)[2]
            if kind == "stack-damaged":
                offsets, counts = tag_values(data, ifd, 273), tag_values(data, ifd, 279)
                data[offsets[1]:offsets[1] + counts[1]] = b"\xff" * counts[1]
            elif kind == "stack-no262":
                drop_tag(data, ifd, 262)
            elif kind == "stack-loop":
                set_next_ifd(data, ifd, ifd_offsets(data)[1])
            return data
        if kind.startswith("spp"):  # SamplesPerPixel against BitsPerSample's count
            spp, bits = {"spp1-bits3": (1, 3), "spp3-bits2": (3, 2), "spp3-bits1": (3, 1),
                         "spp4-bits3": (4, 3)}[kind]
            page = rng.integers(0, 256, (21, 33, bits)).astype(np.uint8)
            data = bytearray(tiff_bytes([page[..., 0] if bits == 1 else page], 5,
                                        rows_per_strip=8, photometric=1 if spp == 1 else 2))
            set_tag(data, ifd_offsets(data)[0], 277, [spp])
            return data
        if kind.startswith("single"):  # one strip: libtiff's estimates
            comp = {"single-raw-short": 1, "single-lzw-no279": 5,
                    "single-raw-zero": 1, "single-deflate-no279": 8}[kind]
            data = _writer_page(rng, compression=comp)
            ifd = ifd_offsets(data)[0]
            if kind.endswith("no279"):
                drop_tag(data, ifd, 279)
            else:
                set_tag(data, ifd, 279, [0 if kind.endswith("zero") else 100])
            return data
        if kind == "first-count":  # uncompressed, the first of 5 counts wrong
            data = _writer_page(rng, rows_per_strip=8)
            ifd = ifd_offsets(data)[0]
            counts = tag_values(data, ifd, 279)
            set_tag(data, ifd, 279, [counts[0] - 3] + counts[1:])
            return data
        if kind == "zero-count":  # an LZW strip of 0 bytes
            data = _writer_page(rng, compression=5, rows_per_strip=8)
            ifd = ifd_offsets(data)[0]
            counts = tag_values(data, ifd, 279)
            set_tag(data, ifd, 279, counts[:1] + [0] + counts[2:])
            return data
        if kind == "u16-raw-short":  # 16 bits: cv2 reads nothing, PIL every row
            data = _writer_page(rng, np.uint16, rows_per_strip=8)
            _short_counts(data, ifd_offsets(data)[0], 5)
            return data
        raise AssertionError(kind)
    return make


MORE = ["tile-short", "tile-short-raw", "tile-no325", "tile-no325-raw", "tile-damaged",
        "big-short", "big-no262", "big-cut", "be-no279", "be-short", "stack-damaged",
        "stack-no262", "stack-loop", "spp1-bits3", "spp3-bits2", "spp3-bits1", "spp4-bits3",
        "single-raw-short", "single-lzw-no279", "single-raw-zero", "single-deflate-no279",
        "first-count", "zero-count", "u16-raw-short"]


@pytest.mark.parametrize("kind", MORE)
def test_c17_more_pages(kind, tmp_path):
    """Tiles, BigTIFF, big-endian files, a later page of a stack,
    SamplesPerPixel against BitsPerSample's count, libtiff's byte-count
    estimates (one strip: a count of 0, one short of its rows, none; five
    strips whose first two counts differ) and a strip of 0 bytes."""
    data = _more(kind)(np.random.default_rng(len(kind)))
    _held(_write(tmp_path, f"{kind}.tif", data))


def test_a_huge_page_is_refused_before_allocating(tmp_path):
    """A page over PIL's decompression-bomb limit (and cv2's 2^30 pixels)
    raises before anything of its size is allocated (no oracle is asked:
    the JAX package lifts PIL's limit when its curation module loads)."""
    data = bytearray(tiff_bytes([np.zeros((4, 4), np.uint8)]))
    for tag in (256, 257):
        set_tag(data, ifd_offsets(data)[0], tag, [1 << 20])
    path = _write(tmp_path, "huge.tif", data)
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match="over PIL's decompression-bomb limit"):
            read(path)


CUT_BASES = ["lzw-strips", "deflate-tiles-big-be", "g4-strips", "raw-stack"]


@pytest.mark.parametrize("base", CUT_BASES)
def test_every_field_cut_short_raises_value_error(base, tmp_path):
    """The file cut at the middle of every strip and tile, inside the
    header, at every IFD entry and inside each, at every next-IFD offset
    and inside every value array: each reader gives an array or raises
    ValueError (never struct.error, KeyError or IndexError), and equals
    its oracle where the oracle reads."""
    rng = np.random.default_rng(4)
    if base == "g4-strips":
        path = _pil_ccitt(tmp_path, _masks(4)["noise"], "group4", {278: 6})
        data = open(path, "rb").read()
    elif base == "raw-stack":
        data = bytes(_writer_page(rng, n=2, rows_per_strip=9))
    elif base == "lzw-strips":
        data = bytes(_writer_page(rng, compression=5, rows_per_strip=9))
    else:
        data = bytes(_writer_page(rng, np.uint16, compression=8, tile=(16, 16), big=True,
                                  order=">"))
    cuts = {1, 4, 6, 7, 9, 15}
    for ifd in ifd_offsets(data):
        entries = ifd_entries(data, ifd)
        big = data[2:4] in (b"\0+", b"+\0")
        head, size = (8, 20) if big else (2, 12)
        cuts |= {ifd + 1, ifd + head, ifd + head + size * len(entries) + 2}
        for at, typ, count, where in entries.values():
            cuts |= {at, at + 5, where + 1}
        for chunk_tag, count_tag in ((273, 279), (324, 325)):
            if chunk_tag in entries:
                for offset, count in zip(tag_values(data, ifd, chunk_tag),
                                         tag_values(data, ifd, count_tag)):
                    cuts.add(offset + count // 2)
    for cut in sorted(c for c in cuts if c < len(data)):
        path = _write(tmp_path, "cut.tif", data[:cut])
        for read in (imread, imread_gray):
            try:
                read(path)
            except ValueError:
                pass
        _held(path, never_set_ok=True)


# ---- phase 25's files ------------------------------------------------------------

def test_phase_25_files_read_as_the_oracles(tmp_path):
    """Every file phase 25 of chip_smoke.py reads on the card (the tests'
    writer's and the committed CCITT fixtures, which are PIL's files of
    their seeded pages) read by the JAX package's readers to the digests
    in ``chip_smoke.TIFF_SHA256``, and by the port's to the same."""
    import chip_smoke
    from make_tiff_fixtures import fixtures

    for name, data in fixtures().items():
        with open(tmp_path / name, "wb") as f:
            f.write(data)
        assert (tmp_path / name).read_bytes() == open(
            f"{chip_smoke.HERE}/tests/fixtures/{name}", "rb").read(), name
    vol = chip_smoke.input_volume(chip_smoke.TIFF_SHAPE, chip_smoke.TIFF_SEED)
    files = chip_smoke.tiff_files(vol, (vol >> 8).astype(np.uint8))
    assert files.keys() == chip_smoke.TIFF_SHA256.keys()
    for form, (name, data) in files.items():
        path = _write(tmp_path, name, data)
        for k, read in enumerate((jax_load, jax_gray)):
            try:
                got = list(chip_smoke.raster_digest(read(path)))
            except Exception:
                got = None
            want = chip_smoke.TIFF_SHA256[form][k]
            assert got == (None if want is None else list(want)), (form, read)
    chip_smoke.plugins_reads(files, lambda name: str(tmp_path / name), chip_smoke.TIFF_SHA256,
                             "tiff")
