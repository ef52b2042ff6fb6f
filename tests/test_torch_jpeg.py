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
- a damaged ``.jpg`` raises and names the file.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import empanada_tpu.data.datasets as JD
from _jpeg_writer import jpeg_bytes, jpeg_tables
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


@pytest.mark.parametrize("damage", ["cut", "zeros", "marker"])
def test_damaged_jpeg_names_the_file(damage, tmp_path):
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
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=r"bad\.jpg: (damaged JPEG data|.*Huffman)"):
            read(str(path))
