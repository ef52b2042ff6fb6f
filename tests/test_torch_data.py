"""The port's data layer against the JAX package's (which calls cv2 and
PIL), on seeded numpy inputs:

- cv2's arithmetic reproduced in numpy, against cv2 itself: uint8 resizes
  at any size, nearest resizes, ``warpAffine`` (linear and nearest, every
  border code) and uint8 ``GaussianBlur`` bit for bit, float32 and uint16
  warps bit for bit; the float resize path within one grey level
  (uint16) and 1e-4 (float32 in [0, 1]);
- every transform of ``AUGMENTATIONS`` and the composed default list
  under one seed: the same draws and the same arrays (exact for uint8
  images and int32 masks);
- ``heatmap_and_offsets`` (heatmap within 1e-6, offsets exact) and
  ``seg_to_instance_bd`` (exact);
- the datasets' items and ``WeightedBatchLoader``'s batches from the same
  folder and seed (exact but the heatmaps, 1e-6);
- the image reader against PIL's writer and cv2's reader: PNG (8/16-bit
  grey, RGB, RGBA; each of the five row filters) and uncompressed TIFF
  (uint8, uint16, int32, float32, RGB), and what it refuses.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import empanada_tpu.data.augment as JA
import empanada_tpu.data.datasets as JD
import empanada_tpu.data.targets as JTg
import empanada_tpu_torch.data.augment as A
import empanada_tpu_torch.data.datasets as D
import empanada_tpu_torch.data.targets as Tg
from empanada_tpu_torch.data.imread import imread_gray

HEATMAP_TOL = 1e-6


def _image(rng, shape, dtype=np.uint8):
    if dtype == np.float32:
        return rng.random(shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


# ---- cv2's arithmetic --------------------------------------------------------


def test_resize_matches_cv2():
    rng = np.random.default_rng(0)
    worst = {np.uint16: 0.0, np.float32: 0.0}
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 300, 2))
        s = 1 + rng.uniform(-0.9, 1.0)
        nh, nw = max(1, int(h * s)), max(1, int(w * s))
        for dtype in (np.uint8, np.uint16, np.float32):
            img = _image(rng, (h, w), dtype)
            want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
            got = A.resize_linear(img, (nh, nw))
            assert got.dtype == want.dtype and got.shape == want.shape
            if dtype == np.uint8:
                np.testing.assert_array_equal(got, want)
            else:
                worst[dtype] = max(worst[dtype], np.abs(got.astype(float) - want).max())
        mask = rng.integers(0, 1 << 20, (h, w)).astype(np.int32)
        np.testing.assert_array_equal(
            A.resize_nearest(mask, (nh, nw)),
            cv2.resize(mask, (nw, nh), interpolation=cv2.INTER_NEAREST))
    assert worst[np.uint16] <= 1 and worst[np.float32] <= 1e-4, worst


@pytest.mark.parametrize("border", [0, 1, 2, 4])
def test_warp_affine_matches_cv2(border):
    rng = np.random.default_rng(border)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(2, 200, 2))
        angle = float(rng.uniform(-180, 180))
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        np.testing.assert_array_equal(A.rotation_matrix((w / 2, h / 2), angle), m)
        for dtype in (np.uint8, np.uint16, np.float32):
            img = _image(rng, (h, w), dtype)
            want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                                  borderMode=border, borderValue=0)
            np.testing.assert_array_equal(A.warp_affine(img, m, border_mode=border), want)
        mask = rng.integers(0, 1000, (h, w)).astype(np.int32)
        want = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST, borderMode=border,
                              borderValue=0)
        np.testing.assert_array_equal(
            A.warp_affine(mask, m, nearest=True, border_mode=border), want)


def test_gaussian_blur_matches_cv2():
    rng = np.random.default_rng(1)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(8, 200, 2))
        img = _image(rng, (h, w))
        for k in (3, 5, 7):
            np.testing.assert_array_equal(A.gaussian_blur(img, k),
                                          cv2.GaussianBlur(img, (k, k), 0))
    with pytest.raises(NotImplementedError, match="uint16"):
        A.gaussian_blur(img.astype(np.uint16), 3)


# ---- the transforms ----------------------------------------------------------


TRANSFORMS = [
    ("RandomScale", dict(scale_limit=(-0.9, 1.0), p=1.0)),
    ("RandomScale", {}),
    ("PadIfNeeded", dict(min_height=150, min_width=170)),
    ("PadIfNeeded", dict(min_height=150, min_width=170, border_mode=4)),
    ("RandomCrop", dict(height=40, width=56)),
    ("CenterCrop", dict(height=41, width=30)),
    ("Rotate", dict(limit=180, p=1.0)),
    ("Rotate", dict(limit=45, border_mode=2)),
    ("RandomBrightnessContrast", dict(p=1.0)),
    ("HorizontalFlip", {}),
    ("VerticalFlip", {}),
    ("GaussianBlur", dict(p=1.0)),
    ("GaussNoise", dict(p=1.0)),
    ("FactorPad", dict(factor=32)),
    ("Normalize", dict(mean=0.57, std=0.13)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TRANSFORMS)])
def test_transform_matches_jax(name, kw):
    """Five calls on one shared generator per package, the same seed:
    equal images and masks (uint8 and int32), and the generators end in
    the same state (the same draws in the same order)."""
    rng = np.random.default_rng(7)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    jtf, ttf = JA.AUGMENTATIONS[name](**kw), A.AUGMENTATIONS[name](**kw)
    for _ in range(5):
        img = _image(rng, (97, 131))
        mask = rng.integers(0, 9, (97, 131)).astype(np.int64)
        want = jtf(image=img, mask=mask, rng=jrng)
        got = ttf(image=img, mask=mask, rng=trng)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["image"].dtype == want["image"].dtype
        np.testing.assert_array_equal(got["mask"], want["mask"])
    assert jrng.bit_generator.state == trng.bit_generator.state


def test_float_and_uint16_images_through_the_transforms():
    """RandomScale's float path within the stated tolerance, the rest
    exact, on uint16 and float32 images."""
    for dtype, tol in ((np.uint16, 1), (np.float32, 1e-4)):
        for name, kw in TRANSFORMS:
            if name == "GaussianBlur":
                continue  # uint8 only, as cv2's bit-exact path (raises otherwise)
            rng = np.random.default_rng(1)
            img = _image(rng, (97, 131), dtype)
            want = JA.AUGMENTATIONS[name](**kw)(image=img, rng=np.random.default_rng(4))
            got = A.AUGMENTATIONS[name](**kw)(image=img, rng=np.random.default_rng(4))
            if name == "RandomScale":
                assert got["image"].shape == want["image"].shape
                assert np.abs(got["image"].astype(float) - want["image"]).max() <= tol
            else:
                np.testing.assert_array_equal(got["image"], want["image"])


DEFAULT_AUGS = [
    {"aug": "RandomScale", "scale_limit": [-0.9, 1]},
    {"aug": "PadIfNeeded", "min_height": 64, "min_width": 64},
    {"aug": "RandomCrop", "height": 64, "width": 64},
    {"aug": "Rotate", "limit": 180},
    {"aug": "RandomBrightnessContrast", "brightness_limit": 0.3, "contrast_limit": 0.3},
    {"aug": "HorizontalFlip"},
    {"aug": "VerticalFlip"},
    {"aug": "Normalize", "mean": 0.6, "std": 0.2},
]


def test_composed_default_augmentations_match_jax():
    """train_config.yaml's default list (at 64 px crops) plus the
    normalisation, twelve samples under one seed."""
    jtf = JA.create_augmentations(DEFAULT_AUGS, seed=5)
    ttf = A.create_augmentations(DEFAULT_AUGS, seed=5)
    rng = np.random.default_rng(2)
    for _ in range(12):
        img = _image(rng, (90, 110))
        mask = rng.integers(0, 5, (90, 110)).astype(np.int64)
        want, got = jtf(image=img, mask=mask), ttf(image=img, mask=mask)
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["mask"], want["mask"])


# ---- targets -----------------------------------------------------------------


def _instances(rng, shape, n):
    seg = np.zeros(shape, np.int64)
    for i in range(n):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        seg[y:y + rng.integers(3, 20), x:x + rng.integers(3, 20)] = i + 1
    return seg


@pytest.mark.parametrize("n", [0, 1, 9])
def test_targets_match_jax(n):
    rng = np.random.default_rng(n)
    seg = _instances(rng, (70, 90), n)
    got_h, got_o = Tg.heatmap_and_offsets(seg, 6)
    want_h, want_o = JTg.heatmap_and_offsets(seg, 6)
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=HEATMAP_TOL)
    np.testing.assert_array_equal(got_o, want_o)
    assert got_h.dtype == want_h.dtype == np.float32
    assert len(Tg.gaussian_kernel(6)) == 49
    vol = np.stack([seg, np.roll(seg, 3, axis=1)])
    for kw in ({}, {"tsz_h": 2}, {"do_bg": False}):
        np.testing.assert_array_equal(Tg.seg_to_instance_bd(vol, **kw),
                                      JTg.seg_to_instance_bd(vol, **kw))


# ---- datasets and the loader --------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two sources of 64 x 80 images (PNG and TIFF) with instance masks;
    class-2 instances for the panoptic dataset."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for src, n, ext in (("a", 6, "png"), ("b", 3, "tif")):
        d = root / src
        (d / "images").mkdir(parents=True)
        (d / "masks").mkdir(parents=True)
        for i in range(n):
            seg = _instances(rng, (64, 80), 4)
            seg[seg == 4] = 2000 + 4
            seg[(seg > 0) & (seg < 4)] += 1000
            img = (rng.random((64, 80)) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / "images" / f"{i:02d}.{ext}")
            Image.fromarray(seg.astype(np.int32 if ext == "tif" else np.uint16)).save(
                d / "masks" / f"{i:02d}.{ext}")
    return str(root)


DATASETS = [("SingleClassInstanceDataset", {}),
            ("PanopticDataset", dict(labels=[1, 2], thing_list=[1], label_divisor=1000)),
            ("BCDataset", {})]


@pytest.mark.parametrize("name,kw", DATASETS, ids=[n for n, _ in DATASETS])
def test_dataset_items_and_loader_match_jax(name, kw, data_dir):
    augs = [{"aug": "Rotate", "limit": 30}, {"aug": "RandomCrop", "height": 48, "width": 48},
            {"aug": "HorizontalFlip"}, {"aug": "Normalize", "mean": 0.5, "std": 0.2}]
    jset = JD.create_dataset(name, data_dir, transforms=JA.create_augmentations(augs, 1), **kw)
    tset = D.create_dataset(name, data_dir, transforms=A.create_augmentations(augs, 1), **kw)
    assert len(jset) == len(tset) == 9
    np.testing.assert_array_equal(tset.weights, jset.weights)
    jl, tl = JD.WeightedBatchLoader(jset, 4, seed=2), D.WeightedBatchLoader(tset, 4, seed=2)
    assert len(jl) == len(tl) == 2
    for _ in range(2):  # two epochs: the generators carry on
        for want, got in zip(jl, tl):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                if k == "ctr_hmp":
                    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=HEATMAP_TOL)
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    merged_j, merged_t = jset + jset, tset + tset
    np.testing.assert_array_equal(merged_t.weights, merged_j.weights)
    state = tl.state_dict()
    order = tl._sample_indices()
    tl.load_state_dict(state)
    np.testing.assert_array_equal(tl._sample_indices(), order)


def test_dataset_guards(tmp_path):
    d = tmp_path / "train" / "src"
    (d / "images").mkdir(parents=True)
    (d / "masks").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(d / "images" / f"{i}.png")
    for i in range(2):
        Image.fromarray(np.zeros((8, 8), np.uint16)).save(d / "masks" / f"{i}.png")
    with pytest.raises(ValueError, match="3 images but 2 masks"):
        D.SingleClassInstanceDataset(str(tmp_path / "train"))
    e = tmp_path / "empty" / "src"
    (e / "images").mkdir(parents=True)
    (e / "masks").mkdir(parents=True)
    with pytest.raises(ValueError, match="no images"):
        D.SingleClassInstanceDataset(str(tmp_path / "empty"))


# ---- the image reader ----------------------------------------------------------


def _jax_read(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        img = np.asarray(Image.open(path))
    return img[..., 0] if img.ndim == 3 else img


PIL_CASES = [("L", np.uint8, (37, 53), ("png", "tif")),
             ("I;16", np.uint16, (41, 29), ("png", "tif")),
             ("RGB", np.uint8, (23, 31, 3), ("png", "tif")),
             ("RGBA", np.uint8, (23, 31, 4), ("png",)),
             ("I", np.int32, (20, 30), ("tif",)),
             ("F", np.float32, (20, 30), ("tif",))]


@pytest.mark.parametrize("mode,dtype,shape,exts", PIL_CASES, ids=[c[0] for c in PIL_CASES])
def test_reader_matches_pil_and_cv2(mode, dtype, shape, exts, tmp_path):
    """PIL-written files read as the JAX package reads them (a colour
    file's channel 0 of cv2's BGR: blue).  Smooth images make PIL's
    adaptive filtering pick every row filter."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = np.sin(xx / 5.0) + np.cos(yy / 3.0)
    for i, arr in enumerate((rng.random(shape), np.broadcast_to(
            smooth.reshape(smooth.shape + (1,) * (len(shape) - 2)), shape))):
        if dtype == np.float32:
            arr = arr.astype(np.float32)
        else:
            top = 60000 if dtype != np.uint8 else 255
            arr = (np.abs(arr) / np.abs(arr).max() * top).astype(dtype)
        for ext in exts:
            path = str(tmp_path / f"{i}.{ext}")
            Image.fromarray(np.ascontiguousarray(arr)).save(path)
            want, got = _jax_read(path), imread_gray(path)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def _png(arr, filters):
    """A PNG of an 8-bit grey image whose row r uses filter filters[r]."""
    h, w = arr.shape
    rows, prior = [], np.zeros(w, np.int64)
    for r in range(h):
        cur = arr[r].astype(np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        f = filters[r]
        if f == 0:
            pred = np.zeros(w, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_reader_takes_every_row_filter(tmp_path):
    arr = np.random.default_rng(3).integers(0, 256, (25, 33)).astype(np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png(arr, [r % 5 for r in range(25)]))
    np.testing.assert_array_equal(imread_gray(str(path)), arr)
    np.testing.assert_array_equal(_jax_read(str(path)), arr)


def test_reader_refuses_other_formats(tmp_path):
    arr = np.zeros((8, 8), np.uint8)
    Image.fromarray(arr).convert("P").save(tmp_path / "p.png")
    Image.fromarray(arr).save(tmp_path / "j.jpg")
    Image.fromarray(np.zeros((8, 8, 4), np.uint8)).save(tmp_path / "rgba.tif")
    with pytest.raises(ValueError, match="colour type 3"):
        imread_gray(str(tmp_path / "p.png"))
    with pytest.raises(ValueError, match="not a PNG or TIFF"):
        imread_gray(str(tmp_path / "j.jpg"))
    with pytest.raises(ValueError, match="4 samples"):
        imread_gray(str(tmp_path / "rgba.tif"))
    assert os.path.getsize(tmp_path / "p.png") > 0
