"""Writes ``tests/fixtures/tiff_*.tif``, the CCITT TIFFs that phase 25 of
``chip_smoke.py`` reads on the card (whose machine has neither PIL nor
libtiff), with PIL's libtiff from ``chip_smoke.tiff_fixture_mask``'s
seeded bilevel pages (``chip_smoke.TIFF_FIXTURES``: Group 4, Group 3 1D,
Group 3 2D with fill bits and FillOrder 2, Modified Huffman), and prints
``chip_smoke.TIFF_SHA256``: the digests of the JAX package's two readers'
arrays (``cli._load_array``, ``datasets._imread_gray``) of every file of
the phase (``chip_smoke.tiff_files``), None where the reader raises.

    JAX_PLATFORMS=cpu python tests/make_tiff_fixtures.py [--write]

Without ``--write`` it only prints the digests of the committed files.
"""

import io
import os
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402


def fixtures() -> dict:
    """{file name: bytes} of the CCITT fixtures."""
    out = {}
    for key, (name, compression, info) in chip_smoke.TIFF_FIXTURES.items():
        buf = io.BytesIO()
        Image.fromarray(chip_smoke.tiff_fixture_mask(key)).save(
            buf, "TIFF", compression=compression, tiffinfo=info)
        out[name] = buf.getvalue()
    return out


def digests() -> dict:
    """{form: (imread's digest, imread_gray's)} of the oracles' arrays of
    every file of phase 25."""
    from empanada_tpu.cli import _load_array
    from empanada_tpu.data.datasets import _imread_gray

    vol = chip_smoke.input_volume(chip_smoke.TIFF_SHAPE, chip_smoke.TIFF_SEED)
    files = chip_smoke.tiff_files(vol, (vol >> 8).astype(np.uint8))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for form, (name, data) in files.items():
            path = os.path.join(d, name)
            with open(path, "wb") as f:
                f.write(data)
            row = []
            for read in (_load_array, _imread_gray):
                try:
                    row.append(chip_smoke.raster_digest(read(path)))
                except Exception:
                    row.append(None)
            out[form] = tuple(row)
    return out


def main():
    if "--write" in sys.argv:
        for name, data in fixtures().items():
            with open(os.path.join(HERE, "fixtures", name), "wb") as f:
                f.write(data)
    print("TIFF_SHA256 = {")
    for form, (pil, gray) in digests().items():
        print(f"    {form!r}: ({None if pil is None else tuple(pil)!r},")
        print(f"        {None if gray is None else tuple(gray)!r}),")
    print("}")


if __name__ == "__main__":
    main()
