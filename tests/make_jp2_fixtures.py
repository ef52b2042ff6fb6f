"""Writes ``tests/fixtures/jp2_*``, the JPEG 2000 files that phase 21 of
``chip_smoke.py`` reads on the card (whose machine has neither PIL nor
cv2), with PIL (OpenJPEG 2.5) from ``chip_smoke.blob_image``'s seeded
EM-like slices, and prints ``chip_smoke.JP2_SHA256``: the digests of the
JAX package's two readers' arrays of each file (``cli._load_array``,
``datasets._imread_gray``).

    JAX_PLATFORMS=cpu python tests/make_jp2_fixtures.py [--write]

Without ``--write`` it only prints the digests of the committed files.
"""

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402

SEEDS = {"slice97": 30, "slice16": 31, "rgb": 32, "tiled": 33, "j2k": 34}


def _save(arr: np.ndarray, **kw) -> bytes:
    """PIL's file of ``arr`` (mode L, I;16 or RGB by its dtype and shape)."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def slice16(shape, n_blobs, seed) -> np.ndarray:
    """A 12-bit detector's EM-like slice in 16-bit samples: blob_image's
    blobs (dark Gaussians at its seed's places and sizes) on a flat
    background, 0-4095, with a count's noise of 2."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.full(shape, 0.5)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        sig = rng.uniform(min(h, w) * 0.02, min(h, w) * 0.05)
        img -= 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    return np.clip(img * 4095 + rng.normal(0, 2, shape), 0, 4095).astype(np.uint16)


def _mask(slice_: np.ndarray, block: int) -> np.ndarray:
    """Instance labels of the dark regions of a slice, on a coarse grid: one
    id a ``block``-pixel tile."""
    h, w = slice_.shape
    coarse = slice_.reshape(h // 16, 16, w // 16, 16).mean((1, 3)) < 118
    dark = coarse.repeat(16, 0).repeat(16, 1)
    yy, xx = np.mgrid[:h, :w]
    return (dark * (1 + (yy // block) * (w // block) + xx // block)).astype(np.uint8)


def fixtures() -> dict:
    """{form: bytes} of the seven files."""
    s97 = chip_smoke.blob_image((1024, 1024), 60, SEEDS["slice97"])
    rgb = chip_smoke.blob_image((512, 512), 20, SEEDS["rgb"])
    tiled = chip_smoke.blob_image((768, 640), 30, SEEDS["tiled"])
    cs = chip_smoke.blob_image((256, 256), 8, SEEDS["j2k"])
    return {
        "slice97": _save(s97, irreversible=True, quality_layers=[20]),
        "slice16": _save(slice16((1024, 1024), 60, SEEDS["slice16"])),
        "rgb": _save(np.dstack([rgb, np.roll(rgb, 7, 1), 255 - rgb]), mct=1,
                     irreversible=True, quality_layers=[20]),
        "tiled": _save(tiled, tile_size=(256, 256), progression="RPCL",
                       precinct_size=(64, 64), codeblock_size=(32, 32), irreversible=True,
                       quality_layers=[40, 20, 10], num_resolutions=4),
        "j2k": _save(np.dstack([cs, np.roll(cs, 5, 0), 255 - cs]), mct=1, no_jp2=True),
        "mask": _save(_mask(s97, 256)),
        "mask_tiled": _save(_mask(tiled, 128)),
    }


def main():
    from empanada_tpu.cli import _load_array
    from empanada_tpu.data.datasets import _imread_gray

    root = os.path.join(HERE, "fixtures")
    if "--write" in sys.argv:
        for form, data in fixtures().items():
            with open(os.path.join(root, chip_smoke.JP2_FILES[form]), "wb") as f:
                f.write(data)
    for form, name in chip_smoke.JP2_FILES.items():
        path = os.path.join(root, name)
        digests = tuple(chip_smoke.raster_digest(fn(path)) for fn in (_load_array, _imread_gray))
        print(f"    {form!r}: {digests!r},  # {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
