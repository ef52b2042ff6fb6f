"""Times the port's PNG readers on the host: ``imread`` and ``imread_gray``
of seeded 1024 x 1024 grey PNGs (8 bits with one IDAT, the same rows in
IDATs of 8192 bytes, and 16 bits), every row filter in turn, each read
checked against its source; the best of 5 reads, in MB/s of decoded
samples.  Each ``--root`` (a checkout of the repository) is timed in a
subprocess of its own, in the order given, so that two versions compare
within one run on one machine:

    python3 tests/time_png_reads.py --root ab_parent --root . --root . --root ab_parent

Prints one JSON line per root, then the card's name and power limit where
``nvidia-smi`` reads them.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

SIDE = 1024
READS = 5


def _filtered(arr: np.ndarray) -> bytes:
    """The rows of ``arr`` (grey, big-endian samples) filtered as PNG, row r
    by filter r % 5, each filter byte first."""
    samples = arr.astype(">u2" if arr.dtype == np.uint16 else np.uint8)
    rows = samples.view(np.uint8).reshape(arr.shape[0], -1).astype(np.int16)
    bpp = samples.itemsize
    out = []
    for r, x in enumerate(rows):
        prior = rows[r - 1] if r else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int16), prior[:-bpp]])
        kind = r % 5
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (a + prior) >> 1
        else:  # Paeth
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def _png(arr: np.ndarray, idat_bytes: int = 0) -> bytes:
    """A grey PNG of ``arr``, its zlib stream in IDATs of ``idat_bytes``
    (0: one IDAT)."""
    def chunk(cid, body):
        return struct.pack(">I", len(body)) + cid + body + struct.pack(
            ">I", zlib.crc32(body, zlib.crc32(cid)))
    depth = 16 if arr.dtype == np.uint16 else 8
    stream = zlib.compress(_filtered(arr), 6)
    step = idat_bytes or len(stream)
    idats = [chunk(b"IDAT", stream[k:k + step]) for k in range(0, len(stream), step)]
    head = chunk(b"IHDR", struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], depth, 0, 0, 0, 0))
    return b"\x89PNG\r\n\x1a\n" + head + b"".join(idats) + chunk(b"IEND", b"")


def _sources() -> dict:
    rng = np.random.default_rng(0)
    ramp = np.add.outer(np.arange(SIDE), np.arange(SIDE)) // 8
    grey8 = ((ramp + rng.integers(0, 24, (SIDE, SIDE))) % 256).astype(np.uint8)
    grey16 = ((ramp * 37 + rng.integers(0, 3000, (SIDE, SIDE))) % 65536).astype(np.uint16)
    return {"grey8": (grey8, 0), "grey8_idat8192": (grey8, 8192), "grey16": (grey16, 0)}


def _child(root: str, folder: str) -> dict:
    """The best of ``READS`` reads of each file by each reader of the port
    in ``root``, checked against its source."""
    sys.path.insert(0, os.path.abspath(root))
    from empanada_tpu_torch.data.imread import imread, imread_gray

    out = {"root": root}
    for form, (arr, _) in _sources().items():
        path = os.path.join(folder, f"{form}.png")
        for read in (imread, imread_gray):
            best = float("inf")
            for _ in range(READS):
                t0 = time.perf_counter()
                got = read(path)
                best = min(best, time.perf_counter() - t0)
            if got.dtype != arr.dtype or not np.array_equal(got, arr):
                raise SystemExit(f"{root}: {read.__name__} of {form} differs from its source")
            out[f"{read.__name__}_{form}_MB_per_s"] = arr.nbytes / best / 1e6
            out[f"{read.__name__}_{form}_ms"] = best * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout whose empanada_tpu_torch is timed (repeatable)")
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child)))
        return 0
    with tempfile.TemporaryDirectory() as folder:
        for form, (arr, idat_bytes) in _sources().items():
            with open(os.path.join(folder, f"{form}.png"), "wb") as f:
                f.write(_png(arr, idat_bytes))
        for root in args.root or ["."]:
            proc = subprocess.run([sys.executable, __file__, "--child", root, folder],
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            print(proc.stdout.strip(), flush=True)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip() or "no card")
    except OSError:
        print("no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
