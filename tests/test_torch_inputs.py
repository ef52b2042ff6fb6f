"""The inputs the JAX package reads, read by the port as it reads them, on
the CPU at small sizes; every comparison is exact (tolerance 0):

- TIFF written by ``_tiff_writer.tiff_bytes`` (the writer phase 18 of
  chip_smoke.py uses too: LZW, Deflate and PackBits encoders of its own,
  zlib, lzma and zstandard) at odd sizes: uint8, uint16, int16, int32,
  float32 and float64 pages, uncompressed, LZW, Deflate, PackBits, LZMA
  and ZSTD, with and without horizontal differencing (floating-point
  differencing, predictor 3, for floats), in strips and in tiles cut at
  the edge, classic and BigTIFF, both byte orders; RGB and RGBA of each
  sample type and each ExtraSamples value; planes apart; min-is-white,
  CMYK and YCbCr (each subsampling, ReferenceBlackWhite and
  YCbCrCoefficients); and TIFF written by PIL (libtiff's LZW, Deflate,
  PackBits, LZMA, ZSTD and JPEG, with a predictor; a BigTIFF; RGB, RGBA,
  palette).  ``imread_gray`` equals the JAX package's ``_imread_gray``
  (cv2, or PIL where cv2 reads nothing: LZMA and ZSTD), ``imread`` its
  ``cli._load_array`` (PIL), both the pages written.  PIL 12 misreads
  some forms (it does not open a big-endian BigTIFF, does not swap
  big-endian compressed 16- and 32-bit signed or float samples, and
  reads uncompressed YCbCr with the wrong layout) and opens no float64
  page: there ``imread`` equals the pages written and cv2, or raises
  with PIL; cv2 misreads 16-bit and float planes apart (plane 0 taken
  for the whole pixel): there ``imread_gray`` equals the pages written;
- PNG of every colour type and bit depth (grey 1-16, RGB and RGBA 8 and
  16, palette 1-8, grey + alpha 8 and 16), interlaced or not, every row
  filter, and PIL's own palette, bilevel, grey + alpha and ``tRNS`` files;
- a damaged LZW, Deflate, PackBits, LZMA or ZSTD strip raises naming the
  file, the page and the strip, as PIL raises, and an uncompressed or JPEG
  strip whose count is cut reads as PIL reads it; the forms the port does
  not read (arithmetic, lossless, hierarchical, 12-bit, CMYK and DNL
  JPEG; old-style JPEG TIFF, predictor 3 of integer samples; XVThumb,
  JPEG 2000 and WebP; the photometric forms and sample counts neither
  reader takes) are refused, naming themselves, and the three that one
  reader takes (grey of three samples, 16-bit CMYK, CIELab) read as it
  reads them; ``imread_gray`` reads a
  TIFF's first page alone, as cv2 does; the ZSTD decoder equals
  zstandard's frames at levels 1 to 19, with and without checksums, and
  reads the committed ZSTD stack phase 18 reads on the card
  (``chip_smoke.label_volume``) as PIL does;
- uint16 volumes and images at ``inference_scale`` 2 through the port's
  ``Engine3d``, ``MultiChipEngine3d`` and ``Engine2d`` equal the JAX
  package's maps and stacks (small widths, seeded weights carried by the
  weight bridge), and a seeded ``create_dataset`` over a folder of uint16
  LZW TIFFs with RandomScale, Rotate and GaussianBlur yields the JAX
  dataset's batches.
"""

import itertools
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import empanada_tpu.data.augment as JA
import empanada_tpu.data.datasets as JD
from _jp2_writer import box, codestream_of, jp2
from _tiff_writer import lzw_encode, packbits_encode, tiff_bytes
from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from empanada_tpu import api as jax_api
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu_torch import api
from empanada_tpu_torch.data import augment as A
from empanada_tpu_torch.data import datasets as D
from empanada_tpu_torch.data.imread import imread, imread_gray
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from test_torch_ortho import CFG, _volume, assert_same_trackers

jax_gray = JD._imread_gray
DTYPES = (np.uint8, np.uint16, np.int16, np.int32, np.float32, np.float64)


def _pages(rng, dtype, shape, n=2):
    if np.dtype(dtype).kind == "f":
        return [rng.random(shape).astype(dtype) for _ in range(n)]
    info = np.iinfo(dtype)
    return [rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)
            for _ in range(n)]


def _same(got, want):
    """Equal values and dtypes (either byte order)."""
    assert got.dtype.newbyteorder("=") == want.dtype.newbyteorder("="), (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pil_dtype(dtype):
    return np.dtype(np.int32) if dtype == np.int16 else np.dtype(dtype)  # PIL's mode I


# ---- TIFF ----------------------------------------------------------------------

CODECS = [(1, 1), (5, 1), (5, 2), (8, 1), (8, 2), (32773, 1), (34925, 1), (34925, 2),
          (50000, 1), (50000, 2)]


def _raises_with_pil(read, path, want=ValueError, match="which PIL does not open"):
    with pytest.raises(Exception):
        jax_load(path)
    with pytest.raises(want, match=match):
        read(path)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("big", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("tile", [None, (16, 32)], ids=["strips", "tiles"])
@pytest.mark.parametrize("compression,predictor", CODECS,
                         ids=[f"c{c}-p{p}" for c, p in CODECS])
def test_tiff_forms_read_as_pil_and_cv2(compression, predictor, tile, big, order, tmp_path):
    """Each dtype; floats take predictor 3 where the others take 2.  cv2
    decodes no LZMA or ZSTD: ``imread_gray`` then equals PIL's array."""
    rng = np.random.default_rng(compression + predictor)
    cv2_reads = compression not in (34925, 50000)
    for dtype in DTYPES:
        floats = np.dtype(dtype).kind == "f"
        pages = _pages(rng, dtype, (37, 53))
        path = str(tmp_path / f"{np.dtype(dtype).name}.tif")
        with open(path, "wb") as f:
            f.write(tiff_bytes(pages, compression, 3 if predictor == 2 and floats else predictor,
                               tile, None if tile else 8, big, order))
        pil_misreads = order == ">" and (big or (compression != 1 and dtype in (
            np.int16, np.int32, np.float32)))
        if dtype == np.float64:  # PIL opens no float64 page
            _raises_with_pil(imread, path)
        else:
            got = imread(path)
            np.testing.assert_array_equal(got, np.stack(pages))
            assert got.dtype == _pil_dtype(dtype)
            if not pil_misreads:
                _same(got, jax_load(path))
        if cv2_reads:
            gray = imread_gray(path)
            _same(gray, jax_gray(path))
            _same(gray, pages[0])
        elif dtype == np.float64:
            _raises_with_pil(imread_gray, path)
        else:  # the JAX package's PIL fallback
            gray = imread_gray(path)
            _same(gray, pages[0].astype(_pil_dtype(dtype)))
            if not pil_misreads:
                _same(gray, jax_gray(path))


def test_big_endian_float_differencing_as_pil_misreads_it(tmp_path):
    """Predictor 3's byte planes are most significant first in either byte
    order: a big-endian float32 page reads as written (cv2 agrees), where
    PIL swaps its bytes once more."""
    page = _pages(np.random.default_rng(7), np.float32, (13, 21), 1)[0]
    path = str(tmp_path / "be.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], 8, 3, order=">"))
    _same(imread(path), page)
    _same(imread_gray(path), jax_gray(path))
    np.testing.assert_array_equal(jax_load(path).view(np.uint32),
                                  page.byteswap().view(np.uint32))


PIL_TIFF = ([(comp, mode) for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits",
                                        "lzma", "zstd")
             for mode in ("L", "I;16", "I", "F", "RGB", "RGBA", "P")]
            + [("jpeg", mode) for mode in ("L", "RGB", "YCbCr")])


@pytest.mark.parametrize("compression,mode", PIL_TIFF, ids=[f"{c}-{m}" for c, m in PIL_TIFF])
def test_pil_written_tiff(compression, mode, tmp_path):
    """libtiff's own encoders (a predictor where it takes one: 3 for
    floats), three pages; RGBA as cv2 premultiplies it, a palette as cv2
    looks it up; JPEG of grey, RGB and YCbCr (libjpeg's RGB)."""
    rng = np.random.default_rng(len(mode))
    shape = {"RGB": (29, 41, 3), "RGBA": (29, 41, 4), "YCbCr": (29, 41, 3)}.get(mode, (29, 41))
    dtype = {"I;16": np.uint16, "I": np.int32, "F": np.float32}.get(mode, np.uint8)
    frames = []
    for arr in _pages(rng, dtype, shape, 3):
        if compression == "jpeg":  # smooth, as images are
            arr = np.cumsum(np.cumsum(arr // 16, 0), 1).astype(np.uint8)
        im = Image.fromarray(arr)
        frames.append(im.convert(mode) if mode in ("P", "YCbCr") else im)
    info = {}
    if compression in ("tiff_lzw", "tiff_adobe_deflate", "lzma", "zstd"):
        info = {317: 3 if mode == "F" else 2}
    path = str(tmp_path / "pil.tif")
    frames[0].save(path, compression=compression, save_all=True, append_images=frames[1:],
                   tiffinfo=info)
    _same(imread(path), jax_load(path))
    _same(imread_gray(path), jax_gray(path))


def test_pil_bigtiff_and_big_endian(tmp_path):
    rng = np.random.default_rng(3)
    arr = _pages(rng, np.uint16, (31, 47), 1)[0]
    Image.fromarray(arr).save(tmp_path / "big.tif", big_tiff=True)
    Image.frombytes("I;16B", (47, 31), arr.astype(">u2").tobytes()).save(tmp_path / "mm.tif")
    for name in ("big.tif", "mm.tif"):
        path = str(tmp_path / name)
        _same(imread(path), jax_load(path))
        _same(imread_gray(path), jax_gray(path))
        _same(imread_gray(path), arr)


def test_lzw_table_resets_and_repeats(tmp_path):
    """Strips long enough to fill the LZW table (clear codes mid-strip),
    runs that reuse the code being defined, and PackBits runs, through
    both encoders (the script's and libtiff's)."""
    rng = np.random.default_rng(8)
    noisy = rng.integers(0, 256, (300, 257)).astype(np.uint8)
    runs = np.repeat(rng.integers(0, 4, (300, 9)), 29, axis=1)[:, :257].astype(np.uint8)
    for arr in (noisy, runs, np.zeros((300, 257), np.uint8)):
        for compression in (5, 32773):
            path = str(tmp_path / f"s{compression}.tif")
            with open(path, "wb") as f:
                f.write(tiff_bytes([arr], compression))
            _same(imread(path), jax_load(path))
            _same(imread(path), arr)
        Image.fromarray(arr).save(tmp_path / "pil.tif", compression="tiff_lzw")
        _same(imread(str(tmp_path / "pil.tif")), arr)


def _page_chunks(data):
    """(offset, byte count, where the count is) of each strip of the first
    two pages of a little-endian classic TIFF."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    out = []
    for _ in range(2):
        (n,) = struct.unpack_from("<H", data, ifd)
        where = {}
        for i in range(n):
            tag, typ, count, value = struct.unpack_from("<HHII", data, ifd + 2 + 12 * i)
            at = ifd + 10 + 12 * i if count == 1 else value
            where[tag] = [at + 4 * k for k in range(count)]
        offsets = [struct.unpack_from("<I", data, a)[0] for a in where[273]]
        counts = [struct.unpack_from("<I", data, a)[0] for a in where[279]]
        out.append(list(zip(offsets, counts, where[279])))
        (ifd,) = struct.unpack_from("<I", data, ifd + 2 + 12 * n)
    return out


@pytest.mark.parametrize("compression", [1, 5, 7, 8, 32773, 34925, 50000])
def test_damaged_strip_names_file_page_and_strip(compression, tmp_path):
    """A damaged strip of page 1 raises, naming the file, the page and the
    strip, where PIL raises; a count cut short reads on where PIL reads
    (uncompressed: PIL reads the rows from the offset, whatever the count;
    JPEG: libjpeg reads on through libtiff's fake EOI markers)."""
    rng = np.random.default_rng(compression)
    dtype = np.uint8 if compression == 7 else np.uint16
    pages = _pages(rng, dtype, (40, 23))
    data = bytearray(tiff_bytes(pages, compression, rows_per_strip=8 if compression == 7 else 10))
    offset, count, at = _page_chunks(bytes(data))[1][2]  # page 1, strip 2
    if compression in (1, 7, 32773):
        struct.pack_into("<I", data, at, count // 3)  # a strip cut short
    elif compression == 5:
        data[offset:offset + count] = b"\xff" * count  # codes past the table
    else:
        data[offset + 2:offset + count] = bytes(count - 2)
    path = tmp_path / "bad.tif"
    path.write_bytes(bytes(data))
    if compression in (1, 7):
        _same(imread(str(path)), jax_load(str(path)))
        if compression == 1:
            np.testing.assert_array_equal(imread(str(path)), np.stack(pages))
        return
    with pytest.raises(Exception):
        jax_load(str(path))
    with pytest.raises(ValueError, match=r"bad\.tif: TIFF page 1, strip 2"):
        imread(str(path))


def _jpeg(tmp_path, **kw):
    """A small baseline JPEG's bytes (PIL's), to damage."""
    img = np.cumsum(np.random.default_rng(2).integers(0, 9, (16, 24)), 1).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "src.jpg", **kw)
    return bytearray((tmp_path / "src.jpg").read_bytes())


def _sof(data):
    """The offset of the frame header's marker."""
    return next(i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] in (
        0xC0, 0xC1, 0xC2))


def _refused(kind, tmp_path):
    """(file name, bytes) of a form the port refuses."""
    if kind.startswith("jpeg-sof"):  # the frame marker of another process
        data = _jpeg(tmp_path)
        data[_sof(data) + 1] = int(kind[8:], 16)
        return "x.jpg", data
    if kind == "jpeg-12bit":
        data = _jpeg(tmp_path)
        data[_sof(data) + 4] = 12
        return "x.jpg", data
    if kind == "jpeg-dnl":  # height 0: a DNL marker would give it
        data = _jpeg(tmp_path)
        struct.pack_into(">H", data, _sof(data) + 5, 0)
        return "x.jpg", data
    if kind == "jpeg-cmyk":
        Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(tmp_path / "c.jpg")
        return "x.jpg", (tmp_path / "c.jpg").read_bytes()
    if kind == "tiff-old-jpeg":
        data = bytearray(tiff_bytes([np.zeros((8, 8), np.uint8)]))
        (ifd,) = struct.unpack_from("<I", data, 4)
        (n,) = struct.unpack_from("<H", data, ifd)
        for i in range(n):
            if struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0] == 259:
                struct.pack_into("<H", data, ifd + 2 + 12 * i + 8, 6)
        return "x.tif", data
    if kind == "tiff-predictor3-uint16":
        return "x.tif", tiff_bytes([np.zeros((8, 8), np.uint16)], 8, predictor=3)
    if kind == "jp2":  # the port reads JPEG 2000: a JP2 of a palette, which it refuses
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "p.jp2")
        palette = (box(b"pclr", struct.pack(">HB", 2, 3) + bytes([7, 7, 7]) + bytes(6))
                   + box(b"cmap", struct.pack(">HBB", 0, 1, 0) * 3))
        return "x.jp2", jp2(codestream_of((tmp_path / "p.jp2").read_bytes()), 8, 8, 3, 7, 16,
                            header_extra=palette)
    if kind.startswith("webp-"):  # a VP8 frame tag libwebp refuses: an inter frame, profile 4
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "v.webp", quality=80)
        data = bytearray((tmp_path / "v.webp").read_bytes())
        data[20] |= 1 if kind == "webp-inter" else 4 << 1
        return "x.webp", data
    if kind == "xvthumb":  # XV's thumbnails: PIL reads them, the port does not
        return "x.xv", b"P7 332\n#END_OF_COMMENTS\n8 8 255\n" + bytes(64)
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / f"x.{kind}")
    return f"x.{kind}", (tmp_path / f"x.{kind}").read_bytes()


# (form, what the error names)
REFUSED = [("jpeg-sofc9", r"arithmetic-coded JPEG \(SOF9\)"),
           ("jpeg-sofca", r"arithmetic-coded JPEG \(SOF10\)"),
           ("jpeg-sofc3", r"lossless JPEG \(SOF3\)"),
           ("jpeg-sofc5", r"hierarchical JPEG \(SOF5\)"),
           ("jpeg-12bit", "12-bit JPEG"), ("jpeg-dnl", "DNL"),
           ("jpeg-cmyk", r"4-component JPEG \(CMYK or YCCK\)"),
           ("tiff-old-jpeg", r"old-style JPEG \(compression 6\)"),
           ("jp2", r"a palette \(pclr and cmap boxes\), which the port does not read"),
           ("webp-inter", "VP8 inter frame"), ("webp-profile4", "VP8 frame of profile 4")]


def _assert_refused(kind, match, tmp_path):
    name, data = _refused(kind, tmp_path)
    path = tmp_path / name
    path.write_bytes(bytes(data))
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=match):
            read(str(path))


def test_refusals_name_the_format(tmp_path):
    """A format the port does not read (XVThumb), and predictor 3 of integer
    samples (libtiff's floating-point differencing takes floats only)."""
    _assert_refused("xvthumb", "a XVTHUMB file, which the port does not read", tmp_path)
    _assert_refused("tiff-predictor3-uint16", "predictor 3, bits", tmp_path)


@pytest.mark.parametrize("kind,match", REFUSED, ids=[k for k, _ in REFUSED])
def test_forms_that_stay_refused(kind, match, tmp_path):
    _assert_refused(kind, match, tmp_path)


@pytest.mark.parametrize("kind", ["gif", "bmp", "sgi", "pcx", "ico", "icns", "xpm", "psd",
                                  "cur", "im"])
def test_forms_once_refused_now_read(kind, tmp_path):
    """GIF and BMP, refused before ``data/raster.py``, SGI and PCX, refused
    before ``data/plugins.py``, and ICO, ICNS, XPM, PSD, CUR and IM's 12-bit
    samples, refused before ``data/icons.py``, read as the JAX package
    reads them (``tests/test_torch_raster.py``,
    ``tests/test_torch_plugins.py`` and ``tests/test_torch_icons.py`` hold
    every form)."""
    arr = np.random.default_rng(11).integers(0, 256, (9, 14)).astype(np.uint8)
    path = str(tmp_path / f"x.{kind}")
    if kind in ("ico", "icns"):  # PIL writes sizes of 16 and more
        Image.fromarray(np.kron(arr, np.ones((4, 3), np.uint8))).convert("RGBA").save(path)
    elif kind in ("xpm", "psd", "cur", "im"):  # formats PIL does not write
        from _raster_writer import ico_bytes, ico_dib, im_bits, im_bytes, psd_bytes, xpm_bytes
        pal = np.random.default_rng(12).integers(0, 256, (256, 3))
        data = {"xpm": lambda: xpm_bytes(arr % 7, [f"#{v:06x}" for v in range(0, 7 * 99, 99)]),
                "psd": lambda: psd_bytes(arr[None], mode=1, rle=True),
                "cur": lambda: ico_bytes([(14, 9, 0, 8, ico_dib(arr, 8, pal))], cursor=True),
                "im": lambda: im_bytes(im_bits(arr.astype(np.uint64) * 16, 12), "L*12",
                                       size=(14, 9))}[kind]()
        open(path, "wb").write(data)
    else:
        Image.fromarray(arr).save(path)
    for got, want in ((imread(path), jax_load(path)), (imread_gray(path), jax_gray(path))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_gray_reads_the_first_page_alone(tmp_path):
    """cv2 decodes the first page of a TIFF: a later page in a form the
    port refuses (predictor 3 of integer samples) does not stop
    ``imread_gray``, and stops ``imread``, which reads every page as PIL
    does."""
    rng = np.random.default_rng(4)
    first = _pages(rng, np.uint16, (21, 33), 1)[0]
    data = bytearray(tiff_bytes([first, np.zeros((21, 33), np.uint16)], 8, predictor=2))
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    (ifd,) = struct.unpack_from("<I", data, ifd + 2 + 12 * n)  # page 1's IFD
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        if struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0] == 317:
            struct.pack_into("<H", data, ifd + 2 + 12 * i + 8, 3)
    path = tmp_path / "two.tif"
    path.write_bytes(bytes(data))
    _same(imread_gray(str(path)), jax_gray(str(path)))
    _same(imread_gray(str(path)), first)
    with pytest.raises(ValueError, match="TIFF page 1 with compression 8, predictor 3"):
        imread(str(path))


# (samples a pixel, ExtraSamples) of the colour TIFFs
COLOUR = [(3, None), (4, None), (4, 0), (4, 1), (4, 2)]


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("spp,extra", COLOUR, ids=[f"s{s}-e{e}" for s, e in COLOUR])
def test_colour_tiff_samples_and_alpha(spp, extra, dtype, order, tmp_path):
    """RGB and RGBA TIFF of each sample type and each ExtraSamples value:
    PIL keeps 8 bits of 16-bit colour, drops an RGBX sample, divides
    associated alpha out and opens no int16 or float colour (``imread``
    raises with it); cv2 reads every one (premultiplying 8-bit
    unassociated alpha), and ``imread_gray`` with it."""
    rng = np.random.default_rng(spp + (extra or 0))
    page = _pages(rng, dtype, (19, 27, spp), 1)[0]
    if spp == 4 and np.dtype(dtype).kind == "u":
        page[0, :4, 3] = 0  # a transparent pixel and an opaque one
        page[0, 4, 3] = np.iinfo(dtype).max
    path = str(tmp_path / "c.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], extra_samples=extra, order=order))
    _same(imread_gray(path), jax_gray(path))
    if dtype in (np.uint8, np.uint16):
        _same(imread(path), jax_load(path))
    else:
        with pytest.raises(Exception):
            jax_load(path)
        with pytest.raises(ValueError, match=f"RGBA? of {np.dtype(dtype).name} samples"):
            imread(path)


# (photometric, dtype) of the grey and CMYK forms read: both readers invert
# 8-bit min-is-white (and no other depth); PIL gives CMYK's 4 samples, cv2
# libtiff's RGBA of them
PHOTOMETRIC = [(0, np.uint8), (0, np.uint16), (0, np.int16), (0, np.float32), (0, np.float64),
               (5, np.uint8)]


@pytest.mark.parametrize("compression", [1, 34925], ids=["raw", "lzma"])
@pytest.mark.parametrize("photometric,dtype", PHOTOMETRIC,
                         ids=[f"p{p}-{np.dtype(d).name}" for p, d in PHOTOMETRIC])
def test_photometric_forms_read_as_pil_and_cv2(photometric, dtype, compression, tmp_path):
    rng = np.random.default_rng(photometric)
    pages = _pages(rng, dtype, (9, 13, 4) if photometric == 5 else (9, 13))
    path = str(tmp_path / "p.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(pages, compression, photometric=photometric))
    if dtype in (np.int16, np.float64):  # PIL opens neither
        _raises_with_pil(imread, path)
        if compression == 1:
            _same(imread_gray(path), jax_gray(path))
        else:
            _raises_with_pil(imread_gray, path)
        return
    _same(imread(path), jax_load(path))
    _same(imread_gray(path), jax_gray(path))
    if photometric == 0:
        want = 255 - np.stack(pages) if dtype == np.uint8 else np.stack(pages)
        np.testing.assert_array_equal(imread(path), want)
    if photometric == 5 and compression == 1:  # cv2: (255 - K)(255 - Y) / 255
        k, y = pages[0][..., 3].astype(int), pages[0][..., 2].astype(int)
        _same(imread_gray(path), ((255 - k) * (255 - y) // 255).astype(np.uint8))


# YCbCr (h, v) subsamplings in data units, and the tags that set the
# conversion
YCBCR = [((1, 1), ()), ((2, 1), ()), ((2, 2), ()), ((1, 2), ()), ((4, 1), ()), ((4, 2), ()),
         ((4, 4), ()), ((2, 2), ((532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                                             (240, 1)]),)),
         ((1, 1), ((529, 5, [(2126, 10000), (7152, 10000), (722, 10000)]),))]


@pytest.mark.parametrize("sub,tags", YCBCR, ids=[f"{h}x{v}-{len(t)}tags" if not t else
                                                 f"{h}x{v}-tag{t[0][0]}"
                                                 for (h, v), t in YCBCR])
def test_ycbcr_tiff_as_libtiff_converts(sub, tags, tmp_path):
    """Uncompressed YCbCr in data units, converted by libtiff's
    ``TIFFYCbCrToRGB`` (cv2's RGBA path); PIL misreads the units (its
    array is not the converted image, or it raises), so ``imread`` gives
    cv2's RGB too.  The page's 29 columns cut the last unit and make an
    even number of 4 x 4 units a row: libtiff's scanline size, rounded
    down, leaves the last unit of an odd-length 4 x 4 row unread."""
    import cv2

    rng = np.random.default_rng(sub[0] * 5 + sub[1])
    page = rng.integers(0, 256, (19, 29, 3)).astype(np.uint8)
    path = str(tmp_path / "y.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes([page], photometric=6, subsampling=sub, rows_per_strip=8,
                           extra_tags=tags))
    _same(imread_gray(path), jax_gray(path))
    _same(imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1])
    try:
        pil = jax_load(path)
    except Exception:
        return
    assert not np.array_equal(pil, imread(path))


# (photometric, samples a pixel, dtype) of the other forms: RGB of one
# sample, CMYK with an extra sample, 16-bit YCbCr and a transparency mask,
# which neither reader takes; grey of three samples (cv2 reads the first,
# PIL nothing), 16-bit CMYK (PIL keeps 8 bits; cv2 reads nothing, so the
# JAX package takes PIL's array) and CIELab (PIL's stored bytes, cv2's
# libtiff RGBA of them)
PHOTOMETRIC_REFUSED = [(2, 1, np.uint8), (1, 3, np.uint8), (5, 5, np.uint8), (5, 4, np.uint16),
                       (6, 3, np.uint16), (4, 1, np.uint8), (8, 3, np.uint8)]
PHOTOMETRIC_READ = ((1, 3), (5, 4), (8, 3))


@pytest.mark.parametrize("photometric,spp,dtype", PHOTOMETRIC_REFUSED,
                         ids=[f"p{p}-s{s}" + (f"-{np.dtype(d).name}" if (p, s) in ((5, 4), (6, 3))
                                               else "") for p, s, d in PHOTOMETRIC_REFUSED])
def test_other_photometric_forms_are_refused(photometric, spp, dtype, tmp_path):
    """Forms neither PIL nor cv2 reads: the port refuses them, naming the
    form; the three that one of them reads read as it does."""
    rng = np.random.default_rng(photometric)
    page = _pages(rng, dtype, (9, 13, spp) if spp > 1 else (9, 13), 1)[0]
    path = tmp_path / "p.tif"
    path.write_bytes(tiff_bytes([page], photometric=photometric))
    if (photometric, spp) in PHOTOMETRIC_READ:
        _same(imread_gray(str(path)), jax_gray(str(path)))
        if photometric == 1:
            _raises_with_pil(imread, str(path))
            _same(imread_gray(str(path)), page[..., 0])
        else:
            _same(imread(str(path)), jax_load(str(path)))
        if photometric == 8:
            _same(imread(str(path)), page)
        return
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=f"{spp} samples.*photometric {photometric} is not"):
            read(str(path))


PLANAR = [(np.uint8, 1, 1), (np.uint8, 8, 2), (np.uint16, 8, 2), (np.uint16, 34925, 2),
          (np.float32, 8, 3), (np.float32, 50000, 3)]


@pytest.mark.parametrize("tile", [None, (16, 16)], ids=["strips", "tiles"])
@pytest.mark.parametrize("spp", [3, 4])
@pytest.mark.parametrize("dtype,compression,predictor", PLANAR,
                         ids=[f"{np.dtype(d).name}-c{c}-p{p}" for d, c, p in PLANAR])
def test_planes_apart(dtype, compression, predictor, spp, tile, tmp_path):
    """PlanarConfiguration 2: the strips or tiles of each sample plane in
    turn, a predictor along each plane's rows.  PIL reads them (8 bits of
    16-bit colour; no float colour); cv2 reads 8-bit ones through its RGBA
    path and misreads wider ones (plane 0 taken for the whole pixel):
    ``imread_gray`` then gives the file's blue plane."""
    rng = np.random.default_rng(spp)
    pages = _pages(rng, dtype, (19, 37, spp))
    path = str(tmp_path / "pl.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(pages, compression, predictor, tile, None if tile else 5, planar=2,
                           extra_samples=2 if spp == 4 else None))
    same_as_contiguous = str(tmp_path / "c.tif")
    with open(same_as_contiguous, "wb") as f:
        f.write(tiff_bytes(pages, extra_samples=2 if spp == 4 else None))
    if dtype == np.float32:
        _raises_with_pil(imread, path, match="RGBA? of float32 samples")
    else:
        _same(imread(path), jax_load(path))
    if dtype == np.uint8 and compression != 34925:
        _same(imread_gray(path), jax_gray(path))
    if compression not in (34925, 50000):
        _same(imread_gray(path), jax_gray(same_as_contiguous))
        _same(imread_gray(path), imread_gray(same_as_contiguous))


@pytest.mark.parametrize("compression", [34925, 50000])
def test_lzma_and_zstd_gray_is_pils_channel_0(compression, tmp_path):
    """cv2 reads no LZMA or ZSTD TIFF, so the JAX package's
    ``_imread_gray`` takes PIL's array: channel 0 of a colour page is red
    there, where a Deflate copy's is blue."""
    page = np.random.default_rng(3).integers(0, 256, (11, 17, 3)).astype(np.uint8)
    for comp, channel in ((compression, 0), (8, 2)):
        path = str(tmp_path / f"{comp}.tif")
        with open(path, "wb") as f:
            f.write(tiff_bytes([page], comp))
        _same(imread_gray(path), jax_gray(path))
        _same(imread_gray(path), page[..., channel])


def test_zstd_fixture_is_the_seeded_labels():
    """The ZSTD stack phase 18 reads on the card (which has no ZSTD
    encoder): ``chip_smoke.label_volume`` as PIL and the port read it."""
    import os

    import chip_smoke

    path = os.path.join(os.path.dirname(chip_smoke.__file__), chip_smoke.ZSTD_FIXTURE)
    want = chip_smoke.label_volume(chip_smoke.ZSTD_SHAPE, chip_smoke.ZSTD_SEED)
    _same(imread(path), want)
    _same(jax_load(path), want)
    _same(imread_gray(path), want[0])


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_zstd_frames_match_zstandard(level, checksum):
    """The port's ZSTD decoder on zstandard's frames: text, noise, runs and
    an EM-like uint16 walk, single-shot and streamed (window descriptor, no
    content size) with strips over 128 KiB, two frames back to back; a
    frame cut short or with a flipped byte under a checksum does not read
    back."""
    import io

    import zstandard

    from empanada_tpu_torch.core import native

    rng = np.random.default_rng(level)
    walk = np.cumsum(rng.normal(0, 40, 90000)).astype(np.int64).astype(np.uint16).tobytes()
    datas = [b"", bytes(300000), rng.integers(0, 256, 5000).astype(np.uint8).tobytes(), walk,
             (b"the quick brown fox %d jumps; " * 9000)[:200000]]
    for data in datas:
        cctx = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
        one = cctx.compress(data)
        out, got = native.zstd_decode(one, len(data))
        assert got == len(data) and out.tobytes() == data
        buf = io.BytesIO()
        with zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                      write_content_size=False).stream_writer(
                                          buf, closefd=False) as w:
            for i in range(0, len(data), 70000):
                w.write(data[i:i + 70000])
        two = buf.getvalue() + one
        out, got = native.zstd_decode(two, 2 * len(data))
        assert got == 2 * len(data) and out.tobytes() == data + data
        if len(one) > 40:
            out, got = native.zstd_decode(one[:len(one) // 2], len(data))
            assert got < len(data) or out.tobytes() != data
    bad = bytearray(zstandard.ZstdCompressor(level=level, write_checksum=True).compress(walk))
    bad[len(bad) // 2] ^= 0x40
    assert native.zstd_decode(bytes(bad), len(walk))[1] == -1


# ---- PNG -----------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _scanlines(px, depth):
    """Filtered rows of (h, w, c) samples, row r with filter r % 5."""
    h = px.shape[0]
    if depth == 16:
        rows = px.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, -1)
    else:
        v = px.reshape(h, -1).astype(np.uint8)
        rows = np.packbits(((v[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
                           .reshape(h, -1).astype(np.uint8), axis=1)
    bpp = max(1, px.shape[2] * depth // 8)
    out, prior = b"", np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        left = np.r_[np.zeros(bpp, np.int64), row[:-bpp]]
        upleft = np.r_[np.zeros(bpp, np.int64), prior[:-bpp]]
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        pred = (np.zeros_like(row), left, prior, (left + prior) // 2, paeth)[r % 5]
        out += bytes([r % 5]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return out


def _png_bytes(px, color, depth, interlace=False, palette=None, trns=None):
    px = np.asarray(px)
    px = px[..., None] if px.ndim == 2 else px
    h, w = px.shape[:2]
    if interlace:
        raw = b"".join(_scanlines(px[y0::dy, x0::dx], depth) for x0, y0, dx, dy in _ADAM7
                       if w > x0 and h > y0)
    else:
        raw = _scanlines(px, depth)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                              0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


PNG_FORMS = [(c, d) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                  (4, (8, 16)), (6, (8, 16))) for d in ds]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_FORMS, ids=[f"c{c}-d{d}" for c, d in PNG_FORMS])
def test_png_forms_read_as_pil_and_cv2(color, depth, interlace, tmp_path):
    rng = np.random.default_rng(color * 17 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    palette = rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None
    for h, w in ((37, 53), (1, 1), (5, 3), (9, 17)):
        px = rng.integers(0, 1 << depth, (h, w, channels))
        path = str(tmp_path / f"{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(_png_bytes(px, color, depth, interlace, palette))
        _same(imread(path), jax_load(path))
        _same(imread_gray(path), jax_gray(path))


PIL_PNG = ["P1", "P2", "P4", "P8", "1", "LA", "I;16", "RGB", "RGBA"]


@pytest.mark.parametrize("mode", PIL_PNG)
def test_pil_written_png(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    grey = rng.integers(0, 256, (23, 35)).astype(np.uint8)
    if mode.startswith("P"):
        bits = int(mode[1:])
        im = Image.fromarray(grey >> (8 - bits)).convert("P")
        im.putpalette(rng.integers(0, 256, 3 * (1 << bits)).astype(np.uint8).tobytes())
        kw = {"bits": bits}
    elif mode == "1":
        im, kw = Image.fromarray(grey > 127), {}
    elif mode == "LA":
        im, kw = Image.fromarray(np.dstack([grey, grey[::-1]]), "LA"), {}
    elif mode == "I;16":
        im, kw = Image.fromarray(grey.astype(np.uint16) * 257), {}
    else:
        im, kw = Image.fromarray(rng.integers(0, 256, (23, 35, len(mode))).astype(np.uint8)), {}
    path = str(tmp_path / "pil.png")
    im.save(path, **kw)
    _same(imread(path), jax_load(path))
    _same(imread_gray(path), jax_gray(path))


@pytest.mark.parametrize("form", ["palette", "grey16", "rgb"])
def test_png_transparency_chunk(form, tmp_path):
    rng = np.random.default_rng(2)
    if form == "palette":
        data = _png_bytes(rng.integers(0, 16, (9, 11)), 3, 4, palette=rng.integers(0, 256, (16, 3)),
                          trns=bytes(range(0, 160, 10)))
    elif form == "grey16":
        data = _png_bytes(rng.integers(0, 1 << 16, (9, 11)), 0, 16, trns=b"\x00\x05")
    else:
        data = _png_bytes(rng.integers(0, 256, (9, 11, 3)), 2, 8, trns=b"\x00\x05\x00\x06\x00\x07")
    path = tmp_path / "t.png"
    path.write_bytes(data)
    _same(imread(str(path)), jax_load(str(path)))
    _same(imread_gray(str(path)), jax_gray(str(path)))


# ---- uint16 through the engines and the training data ---------------------------

KW3D = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=64,
            confidence_thr=0.5, save_panoptic=True)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def volume16():
    """A uint16 volume of 3D blobs whose low bits differ from the uint8
    volume's scaled levels."""
    vol = _volume((5, 40, 52), seed=90, n_blobs=24).astype(np.uint16) * 257
    return vol + np.random.default_rng(0).integers(0, 200, vol.shape).astype(np.uint16)


@pytest.mark.parametrize("axis", ["xy", "xz"])
def test_uint16_volume_at_scale_2_matches_jax(models, volume16, axis):
    model, variables, tmodel = models
    got = api.Engine3d(CFG, model=tmodel, device="cpu", inference_scale=2,
                       **KW3D).infer_on_axis(volume16, axis)
    want = jax_api.Engine3d(CFG, model_and_variables=(model, variables), inference_scale=2,
                            **KW3D).infer_on_axis(volume16, axis)
    np.testing.assert_array_equal(got[0], want[0])
    assert_same_trackers(got[1], want[1])
    got = MultiChipEngine3d(CFG, tmodel, device="cpu", inference_scale=2, batch_size=2,
                            **KW3D).infer_on_axis(volume16, axis)
    want = JaxEngine3d(CFG, model_and_variables=(model, variables), inference_scale=2,
                       sweep_fused=False, mesh=create_mesh(1), batch_size=2,
                       **KW3D).infer_on_axis(volume16, axis)
    np.testing.assert_array_equal(got[0], want[0])
    assert_same_trackers(got[1], want[1])
    if axis == "xy":
        assert sum(len(t.instances) for t in got[1]) >= 1


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32])
def test_engine2d_at_scale_2_matches_jax(models, volume16, dtype):
    """uint16 and int16 maps equal; both packages' preprocessing refuses a
    float image."""
    model, variables, tmodel = models
    img = volume16[2]
    if dtype == np.int16:
        img = (img.astype(np.int32) - 32768).astype(np.int16)
    elif dtype == np.float32:
        img = (img / 65535.0).astype(np.float32)
    kw = dict(nms_kernel=3, max_centers=32, confidence_thr=0.5, inference_scale=2)
    engines = (api.Engine2d(CFG, model=tmodel, device="cpu", **kw),
               jax_api.Engine2d(CFG, model_and_variables=(model, variables), **kw))
    if dtype == np.float32:
        for eng in engines:
            with pytest.raises(Exception, match="(?i)cannot be float"):
                eng.infer(img)
        return
    got, want = (eng.infer(img) for eng in engines)
    np.testing.assert_array_equal(got, want)


def test_uint16_lzw_dataset_matches_jax(tmp_path):
    """A folder of uint16 LZW TIFF images (int32 masks) through
    ``create_dataset`` and the loader with RandomScale, Rotate and
    GaussianBlur, under one seed."""
    rng = np.random.default_rng(11)
    d = tmp_path / "src"
    (d / "images").mkdir(parents=True)
    (d / "masks").mkdir(parents=True)
    for i in range(6):
        img = _volume((1, 70, 90), seed=i)[0].astype(np.uint16) * 257 + rng.integers(0, 200, (
            70, 90)).astype(np.uint16)
        seg = np.zeros((70, 90), np.int32)
        seg[10:30, 12:40], seg[40:62, 50:80] = 1, 2
        (d / "images" / f"{i}.tif").write_bytes(tiff_bytes([img], 5, 2))
        Image.fromarray(seg).save(d / "masks" / f"{i}.tif", compression="tiff_lzw")
    augs = [{"aug": "RandomScale", "scale_limit": [-0.5, 0.5], "p": 1.0},
            {"aug": "PadIfNeeded", "min_height": 64, "min_width": 64},
            {"aug": "RandomCrop", "height": 64, "width": 64},
            {"aug": "Rotate", "limit": 180},
            {"aug": "GaussianBlur", "blur_limit": [3, 7], "p": 1.0},
            {"aug": "Normalize", "mean": 0.5, "std": 0.2}]
    jset = JD.create_dataset("SingleClassInstanceDataset", str(tmp_path),
                             transforms=JA.create_augmentations(augs, 3))
    tset = D.create_dataset("SingleClassInstanceDataset", str(tmp_path),
                            transforms=A.create_augmentations(augs, 3))
    for want, got in zip(JD.WeightedBatchLoader(jset, 3, seed=1),
                         D.WeightedBatchLoader(tset, 3, seed=1)):
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            if k == "ctr_hmp":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_encoders_round_trip():
    """The smoke run's LZW and PackBits encoders against the port's
    decoders, at the strip sizes it writes, and at edge lengths."""
    from empanada_tpu_torch.core import native

    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 127, 128, 129, 4096, 70000):
        for data in (rng.integers(0, 256, n).astype(np.uint8).tobytes(), bytes(n),
                     bytes(itertools.islice(itertools.cycle(b"abcab"), n))):
            out, got = native.lzw_decode(lzw_encode(data), n)
            assert got == n and out.tobytes() == data
            out, got = native.packbits_decode(packbits_encode(data, n), n)
            assert got == n and out.tobytes() == data
