"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through
``data/imread.py``) against the JAX package's readers, on the CPU at small
sizes, every comparison exact (tolerance 0):

- ``.jpg`` files PIL writes (libjpeg-turbo) at qualities 50, 75 and 95,
  subsampling 4:4:4, 4:2:2 and 4:2:0, baseline and progressive, with and
  without restart markers, at 1 x 1, 7 x 9, 37 x 53 and 17 x 520, grey
  and RGB; cv2's 4:1:1 and 4:4:0 files; an Adobe RGB file; an EXIF
  orientation that neither reader applies: ``imread`` equals
  ``cli._load_array`` and ``curation.tiles._load_image`` (PIL),
  ``imread_gray`` the JAX ``_imread_gray`` (cv2: channel 0 of BGR, blue);
- the tests' numpy JPEG writer (``_jpeg_writer``, the one phase 18 of
  chip_smoke.py uses on the card): PIL, cv2 and the port decode its files
  to the same samples;
- JPEG inside TIFF (compression 7): the writer's grey strips and tiles
  with a JPEGTables tag (whole, or holding only the Huffman tables), and
  PIL's grey, RGB and YCbCr pages; YCbCr strips and tiles of 4:4:4, 4:2:2
  and 4:2:0 JPEG (libjpeg's RGB in both readers) and RGB ones of Adobe
  RGB JPEG; an RGB page of subsampled JPEG, which libtiff refuses, is
  refused; a strip's or tile's stream larger than its strip or tile is
  refused as libtiff refuses it, but for a last strip that is too tall,
  which reads;
- C15: files whose patched quantisation tables send the coefficients
  past 16 bits (grey and colour, baseline, progressive and restart
  intervals, a JPEG TIFF's JPEGTables), read as libjpeg-turbo's SIMD IDCT
  reads them; and damaged files (``_damages``: marker segments, fill and
  stray bytes, EOI missing or doubled, cut scans, restart markers), each
  read as each oracle reads it: the same array, or a raise naming the file
  where the JAX reader raises.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import empanada_tpu.data.datasets as JD
from _jpeg_writer import jpeg_bytes, jpeg_tables, patched_dqt
from _tiff_writer import tiff_bytes
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.curation.tiles import _load_image as jax_tile
from empanada_tpu_torch.curation.tiles import _load_image as port_tile
from empanada_tpu_torch.data.imread import imread, imread_gray

jax_gray = JD._imread_gray
SIZES = [(1, 1), (7, 9), (37, 53), (17, 520)]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                  want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def _image(rng, shape):
    """Smooth-ish content with edges (what JPEG holds), uint8."""
    noise = rng.integers(0, 24, shape)
    return np.clip(np.cumsum(noise - 11, axis=1) + 128, 0, 255).astype(np.uint8)


def _check(path, pages=1):
    """Both readers on one file, and the curation tile reader (which reads
    a file's first image: PIL's array) on a file of one page."""
    got = imread(path)
    _same(got, jax_load(path))
    if pages == 1:
        _same(port_tile(path), np.asarray(jax_tile(path)))
    _same(imread_gray(path), jax_gray(path))
    return got


@pytest.mark.parametrize("restart", [0, 2], ids=["no-rst", "rst2"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_jpeg_read_as_pil_and_cv2(quality, subsampling, progressive, restart, tmp_path):
    rng = np.random.default_rng(quality + 7 * subsampling)
    for h, w in SIZES:
        for colour in (False, True):
            if not colour and subsampling:
                continue  # grey has one component: nothing to subsample
            img = _image(rng, (h, w, 3) if colour else (h, w))
            kw = dict(quality=quality, progressive=progressive, subsampling=subsampling)
            if restart:
                kw["restart_marker_blocks"] = restart
            path = str(tmp_path / f"{h}x{w}{'c' if colour else 'g'}.jpg")
            Image.fromarray(img).save(path, **kw)
            got = _check(path)
            assert got.shape == img.shape


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("factor", ["411", "440", "420", "422", "444"])
def test_cv2_sampling_factors(factor, progressive, tmp_path):
    """cv2's encoder writes the factors PIL's does not (4:1:1: box
    replication; 4:4:0: libjpeg-turbo's h1v2 fancy upsampling), with a
    restart interval of 3 MCUs, at odd sizes."""
    import cv2

    rng = np.random.default_rng(int(factor))
    for h, w in SIZES + [(5, 2), (2, 5), (33, 3)]:
        img = _image(rng, (h, w, 3))
        sampling = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        assert ok
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(buf.tobytes())
        _check(str(path))


def test_adobe_rgb_and_exif_orientation(tmp_path):
    """An Adobe APP14 of transform 0 (PIL's ``keep_rgb``) holds RGB, which
    neither reader converts; an EXIF orientation of 6 (rotate 90) is
    applied by neither (PIL's ``Image.open``, cv2 under
    ``IMREAD_UNCHANGED``)."""
    rng = np.random.default_rng(5)
    img = _image(rng, (20, 30, 3))
    Image.fromarray(img).save(tmp_path / "rgb.jpg", keep_rgb=True, quality=90)
    _check(str(tmp_path / "rgb.jpg"))
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(img).save(tmp_path / "exif.jpg", exif=exif)
    assert _check(str(tmp_path / "exif.jpg")).shape == (20, 30, 3)


@pytest.mark.parametrize("quality", [50, 90])
def test_numpy_writer_decodes_as_pil_and_cv2(quality, tmp_path):
    """The tests' baseline writer: its files decode to the same samples in
    PIL, cv2 and the port, near the image written (a lossy code's error:
    a sanity bound, not a tolerance of the comparison)."""
    rng = np.random.default_rng(quality)
    for h, w in SIZES + [(64, 64), (9, 130)]:
        img = _image(rng, (h, w))
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(jpeg_bytes(img, quality))
        got = _check(str(path))
        err = np.abs(got.astype(int) - img)
        assert err.max() <= (16 if quality == 90 else 48) and err.mean() <= (3 if quality == 90
                                                                             else 8)


def _segments(stream):
    """The marker segments of a JPEG stream up to its SOS, as
    (marker, whole segment) pairs."""
    pos, out = 2, []
    while stream[pos + 1] != 0xDA:
        (n,) = struct.unpack_from(">H", stream, pos + 2)
        out.append((stream[pos + 1], stream[pos:pos + 2 + n]))
        pos += 2 + n
    return out, stream[pos:]


# (id, tiff_bytes keywords) of grey JPEG pages written by the numpy writer
WRITER_TIFF = [("strips", dict(rows_per_strip=16)), ("one-strip", {}),
               ("odd-strips", dict(rows_per_strip=24)), ("tiles", dict(tile=(16, 16))),
               ("bigtiff-tiles", dict(tile=(32, 16), big=True))]


@pytest.mark.parametrize("kw", [k for _, k in WRITER_TIFF], ids=[i for i, _ in WRITER_TIFF])
def test_jpeg_in_tiff_from_the_writer(kw, tmp_path):
    """Grey pages of abbreviated JPEG strips or tiles with a JPEGTables tag
    (the last strip's stream cut at the image's height, the edge tiles
    whole), three pages."""
    rng = np.random.default_rng(len(kw))
    pages = [_image(rng, (37, 53)) for _ in range(3)]
    path = str(tmp_path / "j.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(pages, 7, quality=85, **kw))
    got = _check(path, 3)
    assert got.shape == (3, 37, 53)


def test_jpeg_tables_holding_some_of_the_tables(tmp_path):
    """A JPEGTables of the Huffman tables alone, each strip carrying its own
    quantisation table: the decoder loads the tables' stream, then the
    strip's."""
    rng = np.random.default_rng(9)
    page = _image(rng, (40, 24))
    quality = 80
    segs, _ = _segments(jpeg_tables(quality)[:-2] + b"\xff\xda")
    dht = b"".join(s for m, s in segs if m == 0xC4)
    dqt = b"".join(s for m, s in segs if m == 0xDB)

    def strip(block):
        stream = jpeg_bytes(block[..., 0], quality, tables=False)
        return stream[:2] + dqt + stream[2:]
    path = str(tmp_path / "t.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], 7, rows_per_strip=16, jpeg_fn=strip,
                           extra_tags=[(347, 7, list(b"\xff\xd8" + dht + b"\xff\xd9"))]))
    _check(path)


def _grown(index, rows, cols):
    """A ``jpeg_fn`` that writes strip or tile ``index`` as a whole JPEG
    stream of ``rows`` more rows and ``cols`` more columns (edge samples
    repeated) and the others as they are."""
    seen = []

    def encode(block):
        grey = block[..., 0]
        if len(seen) == index:
            grey = np.pad(grey, ((0, rows), (0, cols)), mode="edge")
        seen.append(index)
        return jpeg_bytes(grey, 85)
    return encode


# (id, tiff_bytes keywords, strip or tile, (rows, columns) added) of JPEG
# streams larger than their 37 x 53 page's strip or tile
OVERSIZE = [("wide-strip", dict(rows_per_strip=16), 0, (0, 8)),
            ("tall-strip", dict(rows_per_strip=16), 0, (8, 0)),
            ("tall-wide-last-strip", dict(rows_per_strip=16), 2, (11, 8)),
            ("wide-tile", dict(tile=(16, 16)), 0, (0, 8)),
            ("tall-tile", dict(tile=(16, 16)), 0, (8, 0)),
            ("tall-last-tile", dict(tile=(16, 16)), 11, (8, 0))]


@pytest.mark.parametrize("kw,index,grow", [o[1:] for o in OVERSIZE],
                         ids=[o[0] for o in OVERSIZE])
def test_jpeg_larger_than_its_strip_or_tile_is_refused(kw, index, grow, tmp_path):
    """libtiff's JPEGPreDecode refuses a stream wider or taller than its
    strip or tile ("JPEG strip/tile size exceeds expected dimensions"), so
    both readers fail; the port refuses it from the stream's headers,
    before any sample is allocated, naming the file, page and strip or
    tile."""
    page = _image(np.random.default_rng(index), (37, 53))
    path = str(tmp_path / "o.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], 7, jpeg_fn=_grown(index, *grow), **kw))
    for read in (jax_load, jax_gray):
        with pytest.raises(Exception):
            read(path)
    label = "tile" if "tile" in kw else "strip"
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=rf"o\.tif: TIFF page 0, {label} {index}: a JPEG "
                                             rf"of \d+ x \d+ exceeds"):
            read(path)


@pytest.mark.parametrize("rows", [11, 40])
def test_last_strip_taller_than_the_page(rows, tmp_path):
    """libtiff's one exception: a last strip of the page's width whose
    stream holds more rows than the page has left reads, cut at the
    page's height."""
    page = _image(np.random.default_rng(rows), (37, 53))
    path = str(tmp_path / "t.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], 7, rows_per_strip=16, jpeg_fn=_grown(2, rows, 0)))
    assert _check(path).shape == (37, 53)


def _pil_jpeg(subsampling, quality=85, **kw):
    def encode(block):
        img = block if block.shape[2] > 1 else block[..., 0]
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img)).save(buf, "JPEG", quality=quality,
                                                        subsampling=subsampling, **kw)
        return buf.getvalue()
    return encode


# (photometric, PIL's subsampling, the TIFF's YCbCrSubsampling) of colour
# JPEG pages: YCbCr of 4:4:4, 4:2:2 and 4:2:0; RGB of Adobe RGB 4:4:4
COLOUR_JPEG = [(6, 0, (1, 1)), (6, 1, (2, 1)), (6, 2, (2, 2)), (2, 0, None)]


@pytest.mark.parametrize("tile", [None, (16, 16)], ids=["strips", "tiles"])
@pytest.mark.parametrize("photometric,subsampling,factors", COLOUR_JPEG,
                         ids=["444", "422", "420", "rgb"])
def test_colour_jpeg_in_tiff(photometric, subsampling, factors, tile, tmp_path):
    """Colour pages of JPEG (whole streams, no JPEGTables): YCbCr pages
    whose first component's sampling factors are the YCbCrSubsampling
    tag's, which both readers give as libjpeg's RGB (libtiff's
    JPEGCOLORMODE_RGB), and RGB pages of Adobe RGB JPEG, which neither
    converts."""
    rng = np.random.default_rng(subsampling + photometric)
    pages = [_image(rng, (37, 53, 3)) for _ in range(2)]
    encode = (_pil_jpeg(subsampling) if photometric == 6
              else _pil_jpeg(subsampling, keep_rgb=True))
    path = str(tmp_path / "y.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(pages, 7, tile=tile, rows_per_strip=None if tile else 16,
                           photometric=photometric, subsampling=factors, jpeg_fn=encode))
    _check(path, 2)


def test_pil_written_jpeg_tiff_and_refused_sampling(tmp_path):
    """PIL's own JPEG TIFF of each mode reads as PIL and cv2 read it; an
    RGB page whose JPEG is subsampled (libtiff: "improper JPEG sampling
    factors") is refused by both readers and by the port."""
    rng = np.random.default_rng(4)
    img = _image(rng, (29, 41, 3))
    for mode in ("L", "RGB", "YCbCr"):
        Image.fromarray(img).convert(mode).save(tmp_path / f"{mode}.tif", compression="jpeg",
                                                quality=70)
        _check(str(tmp_path / f"{mode}.tif"))
    path = str(tmp_path / "bad.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([img], 7, photometric=2, jpeg_fn=_pil_jpeg(2)))
    with pytest.raises(Exception):
        jax_load(path)
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=r"bad\.tif: TIFF page 0, strip 0: JPEG sampling"):
            read(path)


def _oracle(read, path):
    """The JAX reader's array, or None where it raises."""
    try:
        return read(path)
    except OSError:  # PIL's truncated or broken stream, UnidentifiedImageError
        return None


def _as_oracles(path, refusals=()):
    """``imread`` and ``imread_gray`` of ``path`` against the JAX readers:
    the same array, or a ValueError naming the file where the JAX reader
    raises; a refusal the port names (``refusals``: the block smoothing of
    a progressive file whose later scans are lost) where it reads.
    Returns whether each reader read."""
    out = []
    for read, oracle in ((imread, jax_load), (imread_gray, jax_gray)):
        want = _oracle(oracle, path)
        if want is None:
            with pytest.raises(ValueError, match=path.split("/")[-1]):
                read(path)
            out.append(False)
            continue
        try:
            got = read(path)
        except ValueError as exc:
            assert any(r in str(exc) for r in refusals), exc
            out.append(False)
            continue
        _same(got, want)
        out.append(True)
    return out


@pytest.mark.parametrize("damage", ["cut", "zeros", "marker"])
def test_damaged_jpeg_names_the_file(damage, tmp_path):
    """A cut scan, FF 00 pairs where the scan's data goes on (Huffman codes
    no table holds, read as 0) and an EOI inside the scan (the rest of it
    zero): read as the oracles read them, or a raise naming the file where
    they raise (PIL's truncated stream)."""
    rng = np.random.default_rng(3)
    Image.fromarray(_image(rng, (64, 80, 3))).save(tmp_path / "src.jpg", quality=90)
    data = bytearray((tmp_path / "src.jpg").read_bytes())
    _, scan = _segments(bytes(data))
    start = len(data) - len(scan) + 20
    if damage == "cut":
        data = data[:start + 40]
    elif damage == "zeros":
        data[start:start + 200] = b"\xff\x00" * 100
    else:  # a marker inside the entropy-coded data
        data[start:start + 2] = b"\xff\xd9"
    path = tmp_path / "bad.jpg"
    path.write_bytes(bytes(data))
    assert _as_oracles(str(path)) == ([False, True] if damage == "cut" else [True, True])


# ----- C15: libjpeg-turbo's SIMD IDCT on out-of-range coefficients ---------------

# (id, colour, PIL keywords) of quality-100 files: an all-1 table, so that
# a patched table sends the dequantised coefficients past 16 bits
PATCHED = [("grey", False, {}), ("grey-progressive", False, dict(progressive=True)),
           ("grey-rst", False, dict(restart_marker_blocks=2)),
           ("rgb-420", True, dict(subsampling=2)),
           ("rgb-422-progressive", True, dict(subsampling=1, progressive=True)),
           ("rgb-444-rst", True, dict(subsampling=0, restart_marker_blocks=1))]


@pytest.mark.parametrize("value", [60, 128, 237, 1000])
@pytest.mark.parametrize("colour,kw", [p[1:] for p in PATCHED], ids=[p[0] for p in PATCHED])
def test_patched_quantisation_tables_read_as_libjpeg_turbo(colour, kw, value, tmp_path):
    """Both oracles run libjpeg-turbo's SIMD islow IDCT here (16-bit lanes:
    wrapped products and sums, saturated passes); the port computes the
    same.  Before it did, these files differed by 255."""
    img = (np.random.default_rng(0).random((64, 64, 3) if colour else (64, 64)) * 255).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=100, **kw)
    path = tmp_path / "q.jpg"
    path.write_bytes(patched_dqt(buf.getvalue(), value))
    _check(str(path))


@pytest.mark.parametrize("value", [237, 1000])
@pytest.mark.parametrize("colour", [False, True], ids=["grey", "rgb"])
def test_patched_tables_on_blocks_of_one_row(colour, value, tmp_path):
    """An image constant down each column: every block's coefficients
    rows 1-7 are zero, where the SIMD IDCT's first pass takes its DC
    shortcut (a 16-bit left shift that wraps, where the full pass
    saturates)."""
    rng = np.random.default_rng(value)
    row = (rng.random((1, 64) + ((3,) if colour else ())) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.repeat(row, 48, 0)).save(buf, "JPEG", quality=100)
    path = tmp_path / "c.jpg"
    path.write_bytes(patched_dqt(buf.getvalue(), value))
    _check(str(path))


@pytest.mark.parametrize("value", [60, 128, 237])
def test_patched_tables_in_tiff(value, tmp_path):
    """A JPEG TIFF whose JPEGTables hold a patched table: the strips'
    abbreviated streams go through the same IDCT (libtiff's libjpeg)."""
    page = (np.random.default_rng(1).random((40, 24)) * 255).astype(np.uint8)
    path = str(tmp_path / "t.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], 7, rows_per_strip=16,
                           jpeg_fn=lambda b: jpeg_bytes(b[..., 0], 100, tables=False),
                           extra_tags=[(347, 7, list(patched_dqt(jpeg_tables(100), value)))]))
    _check(path)


# ----- C15: damaged marker segments, read as each oracle's libjpeg source reads them --

def _damages(d, restart):
    """(id, bytes) of damaged copies of the JPEG ``d``."""
    segs, scan = _segments(d)
    sos = len(d) - len(scan)
    dqt = sum(len(s) for _, s in segs[:[m for m, _ in segs].index(0xDB)]) + 2
    half = sos + (len(d) - sos) // 2
    out = [("com-past-the-end", d[:sos] + b"\xff\xfe\xff\xf0" + d[sos:]),
           ("com-past-the-end-after-scan", d[:-2] + b"\xff\xfe\x01\x00abc"),
           ("dqt-length-short", d[:dqt + 2] + struct.pack(">H", struct.unpack_from(
               ">H", d, dqt + 2)[0] - 1) + d[dqt + 4:]),
           ("fill-before-dqt", d[:dqt] + b"\xff\xff\xff" + d[dqt:]),
           ("stray-before-dqt", d[:dqt] + b"\x12\x34" + d[dqt:]),
           ("stray-before-sos", d[:sos] + b"\x00\x01\x02" + d[sos:]),
           ("ff00-before-sos", d[:sos] + b"\xff\x00" + d[sos:]),
           ("tem-before-sos", d[:sos] + b"\xff\x01" + d[sos:]),
           ("rst-before-sos", d[:sos] + b"\xff\xd3" + d[sos:]),
           ("reserved-marker", d[:sos] + b"\xff\x02\x00\x04ab" + d[sos:]),
           ("jpg2-marker", d[:sos] + b"\xff\xf2\x00\x04ab" + d[sos:]),
           ("second-soi", d[:sos] + b"\xff\xd8" + d[sos:]),
           ("junk-after-soi", d[:2] + b"\x12\x34" + d[2:]),  # neither oracle's signature
           ("app-length-1", d[:sos] + b"\xff\xe5\x00\x01" + d[sos:]),
           ("no-dht", d[:2] + b"".join(s for m, s in segs if m != 0xC4) + scan),
           ("stray-before-eoi", d[:-2] + b"\x01\x02\x03" + d[-2:]),
           ("fill-before-eoi", d[:-2] + b"\xff\xff" + d[-2:]),
           ("reserved-after-scan", d[:-2] + b"\xff\x05\xff\xd9"),
           ("sos-after-scan", d[:-2] + b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00\x12\xff\xd9"),
           ("no-eoi", d[:-2]), ("after-eoi", d + b"garbage\xff\xd8\xff"), ("two-jpegs", d + d),
           ("cut-scan", d[:half]), ("cut-scan-eoi", d[:half] + b"\xff\xd9"),
           ("cut-end", d[:-6]), ("cut-end-eoi", d[:-6] + b"\xff\xd9"),
           ("eoi-in-scan", d[:sos + 20] + b"\xff\xd9" + d[sos + 22:]),
           ("ff00-in-scan", d[:sos + 20] + b"\xff\x00" * 30 + d[sos + 80:])]
    if restart:
        at = [i for i in range(sos, len(d) - 1) if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]
        i, j = at[1], at[2]

        def renumber(k, by):
            b = bytearray(d)
            b[k + 1] = 0xD0 + ((b[k + 1] - 0xD0 + by) & 7)
            return bytes(b)
        swapped = bytearray(d)
        swapped[i + 1], swapped[j + 1] = d[j + 1], d[i + 1]
        out += [("rst-missing", d[:i] + d[i + 2:]), ("rst-repeated", d[:i + 2] + d[i:]),
                ("rst-far", renumber(i, 3)), ("rst-next", renumber(i, 1)),
                ("rst-prior", renumber(j, -1)), ("rst-swapped", bytes(swapped)),
                ("rst-stray-bytes", d[:i] + b"\x11\x22" + d[i:]),
                ("rst-cut-before", d[:i - 3] + d[i:]),
                ("rst-all-missing", bytes(b for k, b in enumerate(d)
                                          if not any(k in (a, a + 1) for a in at)))]
    return out


# (id, colour, PIL keywords) of the files the damages are made from
DAMAGED = [("grey", False, {}), ("rgb", True, {}), ("progressive", False, dict(progressive=True)),
           ("grey-rst", False, dict(restart_marker_blocks=2)),
           ("rgb-rst", True, dict(restart_marker_blocks=1)),
           ("rgb-progressive-rst", True, dict(progressive=True, restart_marker_blocks=1))]


@pytest.mark.parametrize("colour,kw", [p[1:] for p in DAMAGED], ids=[p[0] for p in DAMAGED])
def test_damaged_markers_read_as_the_oracles(colour, kw, tmp_path):
    """Each damage of ``_damages`` (segments past the end or of a bad
    length, fill and stray bytes, markers libjpeg or PIL refuse, a missing
    or duplicated EOI, cut scans, markers inside the scan, restart markers
    missing, repeated, renumbered or cut): ``imread`` reads what PIL reads
    (its marker walk, then libjpeg from its suspending source), and
    ``imread_gray`` cv2's array (libjpeg with a fake EOI at the end, its
    finish's errors ignored), PIL's where cv2 reads nothing.  A progressive
    file whose later scans are lost is one libjpeg smooths, which the port
    refuses by name."""
    rng = np.random.default_rng(len(kw) + colour)
    buf = io.BytesIO()
    Image.fromarray(_image(rng, (32, 48, 3) if colour else (32, 48))).save(buf, "JPEG",
                                                                           quality=90, **kw)
    reads = {}
    for name, data in _damages(buf.getvalue(), "restart_marker_blocks" in kw):
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        reads[name] = _as_oracles(str(path), ["block smoothing"] if "progressive" in kw else [])
    assert reads["eoi-in-scan"] == [True, True] or "progressive" in kw
    assert reads["no-dht"] == ([False, False] if "progressive" in kw else [True, True])
    assert reads["tem-before-sos"][0] is False  # PIL's marker walk refuses it, libjpeg not


@pytest.mark.parametrize("colour,kw", [(False, {}), (True, {}),
                                       (False, dict(restart_marker_blocks=3))],
                         ids=["grey", "rgb", "grey-rst"])
def test_cut_files_read_as_the_oracles(colour, kw, tmp_path):
    """The last 12 cuts of each file, with and without an EOI after them:
    where the data ends decides PIL's outcome by libjpeg-turbo's bit buffer
    (decode_mcu_fast's 6-byte fills while 512 bytes a block are buffered,
    then 57-bit fills that wait for bytes past the end); grey seed 3 cut by
    its EOI is one that the fast path's fills decide."""
    for seed in range(6):
        rng = np.random.default_rng(seed)
        buf = io.BytesIO()
        Image.fromarray(_image(rng, (48, 64, 3) if colour else (48, 64))).save(
            buf, "JPEG", quality=90, **kw)
        d = buf.getvalue()
        for cut in range(len(d) - 13, len(d) - 1):
            for tail in (b"", b"\xff\xd9"):
                path = tmp_path / f"c{seed}-{cut}-{len(tail)}.jpg"
                path.write_bytes(d[:cut] + tail)
                _as_oracles(str(path))


def test_cut_file_over_pil_blocks(tmp_path):
    """A 700 x 900 file (about 160 kB): PIL hands libjpeg 65536 bytes at a
    time, and each MCU that waits for more starts again with the larger
    buffer (and the fast path it may then take)."""
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    Image.fromarray(_image(rng, (700, 900))).save(buf, "JPEG", quality=90)
    d = buf.getvalue()
    assert len(d) > 2 * 65536
    for cut in (65536 + 5, 131072 - 3, len(d) - 9, len(d) - 4, len(d) - 2):
        path = tmp_path / f"c{cut}.jpg"
        path.write_bytes(d[:cut])
        _as_oracles(str(path))
