"""The port's image writer (``data/imwrite.py``) and its multipage reading
(``data/imread.py::imread``) against PIL: what the port writes reads back in
PIL as PIL's own writer's file does (the same pixels and dtypes, every page
of a stack), for every dtype ``curation/export.py::_to_saveable`` yields;
PIL's multipage TIFFs and animated PNGs read back through the port equal,
and so does its LZW TIFF (which the port does not write); other formats
and dtypes raise and name themselves."""

import numpy as np
import pytest
from PIL import Image

from empanada_tpu_torch.data.imread import imread, imread_gray, read_tiff
from empanada_tpu_torch.data.imwrite import imwrite

DTYPES = [np.uint8, np.uint16, np.int32, np.float32]


def _pil_read(path):
    im = Image.open(path)
    frames = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        frames.append(np.asarray(im))
    return np.stack(frames) if len(frames) > 1 else frames[0]


def _pil_write(path, arr):
    if arr.ndim == 2:
        Image.fromarray(arr).save(path)
        return
    frames = [Image.fromarray(a) for a in arr]
    frames[0].save(path, save_all=True, append_images=frames[1:])


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.normal(0, 100, shape).astype(np.float32)
    if dtype == np.int32:  # negatives and values past 2^16: PNG clips them
        return rng.integers(-70000, 200000, shape).astype(np.int32)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


CASES = [(dt, shape, ext) for dt in DTYPES for shape in ((37, 53), (4, 21, 30), (1, 9, 7))
         for ext in ("png", "tif", "tiff") if not (dt == np.float32 and ext == "png")]


@pytest.mark.parametrize("dtype,shape,ext", CASES,
                         ids=[f"{np.dtype(d).name}-{len(s)}d{s[0]}-{e}" for d, s, e in CASES])
def test_written_files_read_back_in_pil_as_pils_own(dtype, shape, ext, tmp_path):
    arr = _array(dtype, shape)
    imwrite(str(tmp_path / f"port.{ext}"), arr)
    _pil_write(str(tmp_path / f"pil.{ext}"), arr)
    got, want = _pil_read(tmp_path / f"port.{ext}"), _pil_read(tmp_path / f"pil.{ext}")
    if ext == "png" and dtype == np.uint16 and len(shape) == 3 and shape[0] > 1:
        # PIL's own animated PNG of uint16 frames reads back every frame as
        # the first: the port writes the frames themselves
        assert not np.array_equal(want[1], np.clip(arr[1], 0, 65535))
        want = np.clip(arr, 0, 65535).astype(np.uint16)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    back = imread(str(tmp_path / f"port.{ext}"))  # and the port reads its own files
    assert back.dtype == want.dtype
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("ext", ["png", "tif"])
def test_pages_of_several_dtypes(ext, tmp_path):
    """_to_saveable picks uint16 or int32 per slice; each page keeps its own
    dtype in TIFF (PNG's frames share one depth)."""
    pages = [_array(np.uint16, (6, 8), 1), np.abs(_array(np.int32, (6, 8), 2)),
             _array(np.uint8, (6, 8), 3)]
    imwrite(str(tmp_path / f"m.{ext}"), pages)
    im = Image.open(tmp_path / f"m.{ext}")
    assert im.n_frames == 3
    for i, page in enumerate(pages):
        im.seek(i)
        got = np.asarray(im)
        if ext == "tif":
            assert got.dtype == page.dtype
            np.testing.assert_array_equal(got, page)
        else:
            np.testing.assert_array_equal(
                got, np.clip(page, 0, 65535) if page.dtype == np.int32 else page)
    np.testing.assert_array_equal(imread(str(tmp_path / f"m.{ext}")), _pil_read(
        tmp_path / f"m.{ext}"))


@pytest.mark.parametrize("dtype", DTYPES + ["rgb"])
def test_pil_multipage_tiffs_read_through_the_port(dtype, tmp_path):
    if dtype == "rgb":
        arr = _array(np.uint8, (3, 10, 12, 3))
    else:
        arr = _array(dtype, (5, 33, 17))
    _pil_write(str(tmp_path / "s.tif"), arr)
    got = imread(str(tmp_path / "s.tif"))
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(read_tiff(open(tmp_path / "s.tif", "rb").read()), arr[0])


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pil_animated_pngs_read_through_the_port(dtype, tmp_path):
    arr = _array(dtype, (4, 19, 23))
    arr[1] = arr[0]  # an unchanged frame
    arr[2, 5:9, 3:7] += 1  # a frame PIL may write as a cropped difference
    _pil_write(str(tmp_path / "a.png"), arr)
    got = imread(str(tmp_path / "a.png"))
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, _pil_read(tmp_path / "a.png"))
    np.testing.assert_array_equal(imread_gray(str(tmp_path / "a.png")), arr[0])


def test_refusals_name_the_format(tmp_path):
    with pytest.raises(ValueError, match="float32 has no PNG form"):
        imwrite(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    for dt in (np.int64, np.bool_, np.float64, np.int16):
        with pytest.raises(ValueError, match=f"dtype {np.dtype(dt).name}"):
            imwrite(str(tmp_path / "x.tif"), np.zeros((4, 4), dt))
    with pytest.raises(ValueError, match="format '.jpg'"):
        imwrite(str(tmp_path / "x.jpg"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="pages of one shape"):
        imwrite(str(tmp_path / "x.tif"), [np.zeros((4, 4), np.uint8), np.zeros((4, 5),
                                                                                np.uint8)])
    (tmp_path / "s.pxr").write_bytes(b"\x80\xe8\0\0" + bytes(508))
    with pytest.raises(ValueError, match="a PIXAR file, which the port does not read"):
        imread(str(tmp_path / "s.pxr"))
    # a compressed TIFF (which the port does not write) reads as PIL reads it
    arr = np.random.default_rng(4).integers(0, 256, (9, 13)).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "lzw.tif", compression="tiff_lzw")
    np.testing.assert_array_equal(imread(str(tmp_path / "lzw.tif")),
                                  _pil_read(tmp_path / "lzw.tif"))
