"""Writes ``tests/fixtures/webp_*.webp``, the WebP files that phase 20 of
``chip_smoke.py`` reads on the card (whose machine has neither PIL nor
cv2), with PIL from ``chip_smoke.blob_image``'s seeded EM-like slices, and
prints ``chip_smoke.WEBP_SHA256``: the digests of the JAX package's two
readers' arrays of each file (``cli._load_array``, ``datasets._imread_gray``).

    JAX_PLATFORMS=cpu python tests/make_webp_fixtures.py [--write]

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

SEEDS = {"lossy": 20, "lossless": 21, "alpha": 22, "anim": 23}


def _save(image, frames=None, **kw) -> bytes:
    buf = io.BytesIO()
    if frames:
        kw.update(save_all=True, append_images=frames)
    image.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _mask(slice_: np.ndarray, block: int) -> np.ndarray:
    """Instance labels of the dark regions of a slice, on a coarse grid (so
    that the mask is one a labeller would draw): one id a 256-pixel tile."""
    h, w = slice_.shape
    coarse = slice_.reshape(h // 16, 16, w // 16, 16).mean((1, 3)) < 118
    dark = coarse.repeat(16, 0).repeat(16, 1)
    yy, xx = np.mgrid[:h, :w]
    ids = 1 + (yy // block) * (w // block) + xx // block
    return (dark * ids).astype(np.uint8)


def fixtures() -> dict:
    """{form: bytes} of the six files."""
    lossy = chip_smoke.blob_image((1024, 1024), 60, SEEDS["lossy"])
    lossless = chip_smoke.blob_image((512, 512), 30, SEEDS["lossless"])
    alpha_slice = chip_smoke.blob_image((512, 512), 30, SEEDS["alpha"])
    alpha = np.clip(np.arange(512)[None, :] // 2 + np.zeros((512, 1), int), 0, 255)
    rgba = np.dstack([alpha_slice] * 3 + [alpha.astype(np.uint8)])
    base = chip_smoke.blob_image((256, 256), 12, SEEDS["anim"])
    # a flat bar that grows (a lossless sub-frame), an inverted patch that
    # moves (a lossy one) and a transparent corner that grows (a frame that
    # does not blend): minimize_size and allow_mixed make these sub-frames
    bars, patch, cut = (0, 40, 40, 80), (150, 150, 170, 170), (128, 128, 128, 96)
    frames = []
    for k in range(4):
        f = np.dstack([base] * 3 + [np.full((256, 256), 255, np.uint8)])
        f[40:100, 30:30 + bars[k]] = (200, 60, 60, 255)
        f[patch[k]:patch[k] + 50, 150:220, :3] = 255 - f[patch[k]:patch[k] + 50, 150:220, :3]
        f[230:, cut[k]:, 3] = 0
        frames.append(Image.fromarray(f, "RGBA"))
    return {
        "lossy": _save(Image.fromarray(lossy), quality=75),
        "mask": _save(Image.fromarray(_mask(lossy, 256)), lossless=True),
        "lossless": _save(Image.fromarray(lossless), lossless=True),
        "alpha": _save(Image.fromarray(rgba, "RGBA"), quality=75, alpha_quality=50),
        "mask512": _save(Image.fromarray(_mask(alpha_slice, 128)), lossless=True),
        "anim": _save(frames[0], frames[1:], duration=100, allow_mixed=True,
                      minimize_size=True, quality=75),
    }


def main():
    from empanada_tpu.cli import _load_array
    from empanada_tpu.data.datasets import _imread_gray

    root = os.path.join(HERE, "fixtures")
    if "--write" in sys.argv:
        for form, data in fixtures().items():
            with open(os.path.join(root, chip_smoke.WEBP_FILES[form]), "wb") as f:
                f.write(data)
    for form, name in chip_smoke.WEBP_FILES.items():
        path = os.path.join(root, name)
        digests = tuple(chip_smoke.raster_digest(fn(path)) for fn in (_load_array, _imread_gray))
        print(f"    {form!r}: {digests!r},  # {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
