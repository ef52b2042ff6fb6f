"""WebP, read by the port (``data/webp.py``, ``csrc/webp_decode.cpp``) on
the CPU at small sizes; every comparison is exact (tolerance 0): ``imread``
against the JAX package's ``cli._load_array`` (PIL 12.1, libwebp 1.6) and
``imread_gray`` against its ``datasets._imread_gray`` (cv2 5.0, then PIL),
in dtype, shape and every sample, or both raising, on the same file:

- the corpus: files PIL writes (lossless at every method and several
  qualities, ``exact``; lossy at qualities 0-100 and methods 0-6, with
  ``alpha_quality``; animations with ``duration``, ``minimize_size``,
  ``kmin``/``kmax``, ``allow_mixed``) and cv2 writes (qualities 1-100,
  and 101 for lossless), of sizes 1 x N, N x 1, odd and off the 16-pixel
  grid, of noise, gradients, flat images, masks of 2, 4, 16 and 256
  colours, EM-like blobs and patterns; and files put together from their
  chunks (``_webp_writer``): raw and recoded ALPH with each filter,
  metadata and unknown chunks, VP8 profiles 1-3 and scale bits,
  animations of sub-frames, blending and disposal;
- the coverage test names the corpus file that reaches each VP8L
  transform, predictor mode, bundling width, the colour cache and meta
  prefix codes, each ALPH compression and filter, VP8 segmentation, 4x4,
  16x16 and skipped macroblocks, and blended and disposed sub-frames;
- where the two oracles disagree (VP8X reserved flags or an ALPH chunk
  before VP8L: PIL refuses, cv2 reads; a VP8X alpha flag without ALPH or
  an ALPH without the flag; a file under 32 bytes) each reader follows its
  own, and the test pins the difference;
- the refused forms raise naming themselves; truncated and bit-flipped
  files raise ValueError naming the file (hypothesis); a header claiming
  more than its data can hold is refused before allocating; the committed
  fixtures of ``chip_smoke.py``'s phase 20 read to its ``WEBP_SHA256``.
"""

import functools
import io
import os
import tempfile
import tracemalloc
import warnings

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from _webp_writer import alph_raw, anim, anmf, chunk, riff, split, vp8_refused, vp8_tag, vp8x
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import raster
from empanada_tpu_torch.data.imread import imread, imread_gray


def _outcome(fn, path):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(path)
    except Exception as exc:  # noqa: BLE001  an oracle's refusal, of any type
        return exc


def _held(path: str) -> None:
    """Both readers equal their oracles on ``path``, or raise where they
    raise (cv2's None, then PIL's error, for ``_imread_gray``)."""
    for port, jax in ((imread, jax_load), (imread_gray, jax_gray)):
        want = _outcome(jax, path)
        if isinstance(want, Exception):
            with pytest.raises(ValueError, match=path):
                port(path)
            continue
        got = port(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (port.__name__, got.shape,
                                                                     want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{port.__name__} {path}")


@functools.lru_cache(maxsize=None)
def _tmpdir() -> tempfile.TemporaryDirectory:
    """One directory for the module's files, removed when the process ends."""
    return tempfile.TemporaryDirectory(prefix="webp-")


def _write(data: bytes) -> str:
    fd, path = tempfile.mkstemp(suffix=".webp", dir=_tmpdir().name)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return path


# ----- images --------------------------------------------------------------------


def _image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """A seeded (h, w) uint8 plane of ``kind``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    if kind == "noise":
        v = rng.integers(0, 256, (h, w))
    elif kind == "grad":
        v = x * 255 // max(w - 1, 1) // 2 + y * 255 // max(h - 1, 1) // 2
    elif kind == "flat":
        v = np.full((h, w), 173)
    elif kind.startswith("mask"):
        n = int(kind[4:])
        v = rng.integers(0, n, (h // 4 + 1, w // 4 + 1)).repeat(4, 0).repeat(4, 1)[:h, :w]
        v = v * (255 // max(n - 1, 1)) if n <= 16 else v
    elif kind == "blobs":
        v = np.full((h, w), 200.0)
        for _ in range(8):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            v -= 120 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * (w / 10) ** 2))
        v += rng.normal(0, 6, (h, w))
    elif kind == "diag1":
        v = ((x + y) * 16) % 256
    elif kind == "diag2":
        v = ((x - y) * 16) % 256
    elif kind == "diag3":
        v = ((2 * x + y) * 9) % 256
    elif kind == "check":
        v = ((x // 4 + y // 4) % 2) * 255
    elif kind == "stairs":
        v = (np.minimum(x, y) * 7) % 256
    elif kind == "rings":
        v = (np.hypot(x - w / 2, y - h / 2) * 9) % 256
    else:
        raise KeyError(kind)
    return np.clip(v, 0, 255).astype(np.uint8)


def _colour(kind: str, h: int, w: int, mode: str, seed: int = 0) -> np.ndarray:
    """``_image`` as PIL mode L, RGB or RGBA (channels shifted copies)."""
    v = _image(kind, h, w, seed)
    if mode == "L":
        return v
    rgb = np.dstack([v, np.roll(v, 3, 1), 255 - v])
    if mode == "RGB":
        return rgb
    alpha = np.roll(_image("blobs", h, w, seed + 1), 5, 0)
    return np.dstack([rgb, alpha])


def _pil(arr: np.ndarray, mode: str, frames=None, **kw) -> bytes:
    buf = io.BytesIO()
    first = Image.fromarray(arr, mode)
    if frames:
        kw.update(save_all=True, append_images=[Image.fromarray(f, mode) for f in frames])
    first.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _cv2(arr: np.ndarray, quality: int) -> bytes:
    ok, enc = cv2.imencode(".webp", arr, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return enc.tobytes()


def _chunks(data: bytes) -> dict:
    return dict(split(data))


# ----- the corpus ------------------------------------------------------------------

_LOSSLESS = [  # (kind, h, w, mode, method, quality[, seed])
    ("blobs", 128, 128, "RGB", 6, 0, 1), ("blobs", 128, 128, "RGB", 4, 0),
    ("blobs", 128, 128, "L", 6, 0), ("blobs", 128, 128, "L", 3, 0),
    ("diag1", 128, 128, "L", 6, 100), ("diag2", 128, 128, "RGBA", 6, 100),
    ("diag3", 128, 128, "RGBA", 0, 0), ("diag3", 128, 128, "RGB", 3, 0),
    ("stairs", 128, 128, "RGB", 3, 0), ("check", 128, 128, "L", 0, 0),
    ("check", 128, 128, "RGB", 0, 0), ("diag1", 128, 128, "L", 0, 0),
    ("diag3", 128, 128, "L", 0, 0), ("diag1", 128, 128, "L", 3, 0),
    ("rings", 128, 128, "RGB", 6, 75), ("rings", 128, 128, "RGBA", 4, 75),
    ("noise", 1, 37, "RGB", 4, 75), ("noise", 29, 1, "RGBA", 4, 75),
    ("noise", 37, 45, "L", 6, 100), ("grad", 23, 50, "RGB", 2, 50),
    ("flat", 17, 33, "RGB", 4, 75), ("mask2", 40, 41, "L", 4, 75),
    ("mask4", 40, 41, "L", 5, 90), ("mask16", 40, 41, "L", 1, 25),
    ("mask256", 64, 64, "L", 4, 75), ("grad", 1, 1, "RGBA", 4, 75),
]
_LOSSY = [  # (kind, h, w, mode, quality, method, alpha_quality)
    ("blobs", 128, 128, "L", 75, 4, 100), ("blobs", 128, 128, "RGB", 90, 6, 100),
    ("noise", 37, 45, "RGB", 0, 0, 100), ("noise", 37, 45, "RGB", 100, 6, 100),
    ("grad", 23, 50, "L", 50, 3, 100), ("grad", 1, 37, "RGB", 75, 4, 100),
    ("grad", 29, 1, "RGB", 75, 4, 100), ("noise", 1, 1, "RGB", 75, 4, 100),
    ("flat", 33, 17, "RGB", 10, 2, 100), ("rings", 64, 80, "RGB", 25, 5, 100),
    ("mask4", 40, 41, "L", 60, 1, 100), ("check", 48, 48, "RGB", 95, 6, 100),
    ("blobs", 37, 45, "RGBA", 75, 4, 100), ("noise", 23, 50, "RGBA", 50, 6, 0),
    ("rings", 40, 48, "RGBA", 80, 0, 50), ("diag3", 31, 33, "RGBA", 30, 4, 100),
]
_CV2 = [  # (kind, h, w, colour, quality)
    ("blobs", 64, 64, False, 95), ("noise", 37, 45, True, 1), ("grad", 23, 50, True, 50),
    ("blobs", 31, 33, True, 100), ("mask16", 40, 41, False, 101), ("noise", 23, 50, True, 101),
]


def _lossless(kind, h, w, mode, method, quality, seed=0):
    return _pil(_colour(kind, h, w, mode, seed), mode, lossless=True, method=method,
                quality=quality)


def _lossy(kind, h, w, mode, quality, method, alpha_quality):
    return _pil(_colour(kind, h, w, mode), mode, quality=quality, method=method,
                alpha_quality=alpha_quality)


def _cv2_file(kind, h, w, colour, quality):
    v = _image(kind, h, w)
    return _cv2(np.dstack([v, 255 - v, np.roll(v, 2, 0)]) if colour else v, quality)


def _frames(kind, h, w, mode, n, seed=0):
    """n frames of ``kind`` with a moving patch (transparent in RGBA)."""
    base = _colour(kind, h, w, mode, seed)
    out = []
    for k in range(n):
        f = base.copy()
        f[2 + k:9 + k, 3 + 2 * k:12 + 2 * k] = 255 - f[2 + k:9 + k, 3 + 2 * k:12 + 2 * k]
        if mode == "RGBA":
            f[h // 2:, w // 2 + k:, 3] = 0
        out.append(f)
    return out


def _animation(mode, n, **kw):
    fr = _frames("blobs", 40, 48, mode, n)
    return _pil(fr[0], mode, fr[1:], duration=40, **kw)


_ANIMATIONS = {
    "lossless_rgba": dict(mode="RGBA", n=3, lossless=True),
    "lossless_rgba_min": dict(mode="RGBA", n=4, lossless=True, minimize_size=True),
    "mixed_min": dict(mode="RGBA", n=4, allow_mixed=True, minimize_size=True, quality=60),
    "lossy_rgb": dict(mode="RGB", n=3, quality=50),
    "lossy_rgb_kmax": dict(mode="RGB", n=5, quality=70, kmin=1, kmax=2),
    "mixed_rgb": dict(mode="RGB", n=4, allow_mixed=True, minimize_size=True),
    "lossy_rgba_alpha": dict(mode="RGBA", n=3, quality=70, alpha_quality=40),
}


def _vp8l_frame(kind, h, w, seed, alpha):
    """A VP8L chunk of an RGBA (or RGB) plane, as PIL writes it."""
    mode = "RGBA" if alpha else "RGB"
    return chunk(b"VP8L", _chunks(_pil(_colour(kind, h, w, mode, seed), mode, lossless=True,
                                       exact=True))[b"VP8L"])


def _crafted_animation(case: str) -> bytes:
    """Animations put together from VP8L and VP8 chunks: sub-frames,
    blending and disposal in the cases anim_decode.c tells apart."""
    a = _vp8l_frame("blobs", 10, 12, 1, True)
    b = _vp8l_frame("rings", 8, 6, 2, True)
    c = _vp8l_frame("noise", 6, 8, 3, False)
    lossy = _chunks(_pil(_colour("grad", 10, 12, "RGBA", 4), "RGBA", quality=60))
    lossy_frame = chunk(b"ALPH", lossy[b"ALPH"]) + chunk(b"VP8 ", lossy[b"VP8 "])
    full = _vp8l_frame("blobs", 16, 20, 5, True)
    head = vp8x(20, 16, 0x12) + anim(0xFF336699, 0)
    frames = {
        "subrect_first": [anmf(4, 2, 12, 10, a), anmf(2, 4, 6, 8, b)],
        "blend_over": [anmf(0, 0, 20, 16, full), anmf(2, 2, 12, 10, a), anmf(6, 4, 6, 8, b)],
        "dispose_then_blend": [anmf(0, 0, 20, 16, full), anmf(2, 2, 12, 10, a, dispose=True),
                               anmf(4, 6, 6, 8, b), anmf(0, 0, 8, 6, c)],
        "no_blend": [anmf(0, 0, 20, 16, full), anmf(2, 2, 12, 10, a, blend=False),
                     anmf(8, 0, 12, 10, lossy_frame)],
        "dispose_key": [anmf(0, 0, 20, 16, full, dispose=True), anmf(4, 4, 12, 10, a),
                        anmf(0, 0, 20, 16, full, dispose=True), anmf(6, 2, 12, 10, lossy_frame)],
        "dispose_sub_key": [anmf(2, 2, 12, 10, a, dispose=True), anmf(4, 4, 6, 8, b),
                            anmf(0, 0, 8, 6, c, dispose=True), anmf(10, 6, 6, 8, b)],
        "opaque_full": [anmf(2, 2, 12, 10, a), anmf(0, 0, 20, 16, _vp8l_frame("grad", 16, 20, 6,
                                                                              False)),
                        anmf(4, 4, 12, 10, a)],
    }[case]
    return riff(head, *frames)


def _alph_file(filt: int, compressed: bool) -> bytes:
    """A lossy RGBA still with its ALPH chunk raw (filtered by ``filt``) or
    PIL's compressed one with its filter bits set to ``filt``."""
    data = _pil(_colour("blobs", 21, 30, "RGBA", 7), "RGBA", quality=70)
    parts = _chunks(data)
    if compressed:
        payload = bytes([(parts[b"ALPH"][0] & ~0x0C) | (filt << 2)]) + parts[b"ALPH"][1:]
    else:
        alpha = np.roll(_image("rings", 21, 30, 8), 4, 1)
        payload = alph_raw(alpha, filt)
    return riff(vp8x(30, 21, 0x10), chunk(b"ALPH", payload), chunk(b"VP8 ", parts[b"VP8 "]))


def _container(case: str) -> bytes:
    """Still files rewritten at the container or frame-tag level."""
    lossy = _chunks(_pil(_colour("blobs", 37, 45, "RGB"), "RGB", quality=75))[b"VP8 "]
    ll = _chunks(_pil(_colour("diag3", 19, 23, "RGBA"), "RGBA", lossless=True))[b"VP8L"]
    if case.startswith("profile"):
        return riff(chunk(b"VP8 ", vp8_tag(lossy, profile=int(case[-1]))))
    if case == "scale_bits":
        return riff(chunk(b"VP8 ", vp8_tag(lossy, scale=(2, 3))))
    meta = chunk(b"ICCP", bytes(40)) + chunk(b"EXIF", b"Exif\0\0" + bytes(21))
    return {
        "metadata": riff(vp8x(23, 19, 0x10 | 0x20 | 0x08 | 0x04), meta, chunk(b"VP8L", ll),
                         chunk(b"XMP ", b"<x:xmpmeta/>")),
        "unknown_chunks": riff(vp8x(45, 37, 0), chunk(b"ABCD", b"odd"), chunk(b"VP8 ", lossy),
                               chunk(b"WXYZ", bytes(9))),
        "simple_trailing": riff(chunk(b"VP8L", ll), chunk(b"JUNK", b"12345")),
        "riff_short_junk_after": riff(chunk(b"VP8 ", lossy)) + b"trailing bytes",
        "vp8x_lossy": riff(vp8x(45, 37, 0), chunk(b"VP8 ", lossy)),
        "one_frame_animation": riff(vp8x(45, 37, 0x02), anim(), anmf(0, 0, 45, 37,
                                                                     chunk(b"VP8 ", lossy))),
    }[case]


_CORPUS = {}
for _k in _LOSSLESS:
    _CORPUS["lossless-" + "-".join(map(str, _k))] = functools.partial(_lossless, *_k)
for _k in _LOSSY:
    _CORPUS["lossy-" + "-".join(map(str, _k))] = functools.partial(_lossy, *_k)
for _k in _CV2:
    _CORPUS["cv2-" + "-".join(map(str, _k))] = functools.partial(_cv2_file, *_k)
for _k, _kw in _ANIMATIONS.items():
    _CORPUS["anim-" + _k] = functools.partial(_animation, **_kw)
for _k in ("subrect_first", "blend_over", "dispose_then_blend", "no_blend", "dispose_key",
           "dispose_sub_key", "opaque_full"):
    _CORPUS["crafted-" + _k] = functools.partial(_crafted_animation, _k)
for _f in range(4):
    for _c in (False, True):
        _CORPUS[f"alph-{'vp8l' if _c else 'raw'}-filter{_f}"] = functools.partial(_alph_file, _f,
                                                                                  _c)
for _k in ("metadata", "unknown_chunks", "simple_trailing", "riff_short_junk_after",
           "vp8x_lossy", "one_frame_animation", "profile1", "profile2", "profile3",
           "scale_bits"):
    _CORPUS["container-" + _k] = functools.partial(_container, _k)


@functools.lru_cache(maxsize=None)
def _corpus_file(name: str) -> bytes:
    return _CORPUS[name]()


@pytest.mark.parametrize("name", sorted(_CORPUS))
def test_corpus_reads_as_the_oracles(name):
    _held(_write(_corpus_file(name)))


# ----- coverage ------------------------------------------------------------------

# feature -> the corpus file that reaches it
_REACHES = {
    "vp8l transform predictor": "anim-lossless_rgba",
    "vp8l transform cross-colour": "container-metadata",
    "vp8l transform subtract-green": "cv2-noise-23-50-True-101",
    "vp8l transform colour-indexing": "crafted-blend_over",
    **{f"vp8l predictor mode {m}": f for m, f in (
        (0, "lossless-blobs-128-128-RGB-6-0-1"), (1, "lossless-diag1-128-128-L-6-100"),
        (2, "container-metadata"), (3, "lossless-rings-128-128-RGB-6-75"),
        (4, "lossless-rings-128-128-RGBA-4-75"), (5, "lossless-blobs-128-128-RGB-4-0"),
        (6, "lossless-blobs-128-128-L-6-0"), (7, "lossless-blobs-128-128-L-6-0"),
        (8, "lossless-blobs-128-128-L-6-0"), (9, "lossless-blobs-128-128-L-6-0"),
        (10, "lossless-blobs-128-128-L-3-0"), (11, "lossless-diag3-128-128-RGBA-0-0"),
        (12, "crafted-blend_over"), (13, "crafted-dispose_key"))},
    "vp8l bundling 8 bits (no packing)": "crafted-dispose_sub_key",
    "vp8l bundling 4 bits": "lossless-mask16-40-41-L-1-25",
    "vp8l bundling 2 bits": "lossless-mask4-40-41-L-5-90",
    "vp8l bundling 1 bit": "lossless-mask2-40-41-L-4-75",
    "vp8l colour cache": "cv2-mask16-40-41-False-101",
    "vp8l meta prefix codes": "lossless-diag3-128-128-RGB-3-0",
    "vp8l back-references": "anim-lossless_rgba_min",
    **{f"alph raw filter {f}": f"alph-raw-filter{f}" for f in range(4)},
    **{f"alph vp8l filter {f}": f"alph-vp8l-filter{f}" for f in range(4)},
    "vp8 segmentation": "alph-raw-filter0",
    "vp8 4x4 macroblocks": "alph-raw-filter0",
    "vp8 16x16 macroblocks": "anim-lossy_rgb",
    "vp8 skipped macroblocks": "lossy-flat-33-17-RGB-10-2-100",
    "vp8 normal loop filter": "alph-raw-filter0",
    "anim blended sub-frame": "crafted-blend_over",
    "anim disposed sub-frame": "crafted-dispose_then_blend",
    "anim lossy after lossless": "crafted-no_blend",
}


def _features_of(data: bytes) -> set:
    """What one file reaches, from its chunks and the decoders' stats."""
    got = set()
    names = {0: "predictor", 1: "cross-colour", 2: "subtract-green", 3: "colour-indexing"}
    bundles = {0: "8 bits (no packing)", 1: "4 bits", 2: "2 bits", 3: "1 bit"}

    def image(tag, payload):
        stats = np.zeros(8, np.int64)
        native.webp_decode(tag.decode(), payload, stats)
        if tag == b"VP8L":
            got.update(f"vp8l transform {names[t]}" for t in range(4) if stats[0] >> t & 1)
            got.update(f"vp8l predictor mode {m}" for m in range(14) if stats[1] >> m & 1)
            got.update(f"vp8l bundling {bundles[b]}" for b in range(4) if stats[2] >> b & 1)
            got.update({"vp8l colour cache"} if stats[3] else set())
            got.update({"vp8l meta prefix codes"} if stats[4] > 1 else set())
            got.update({"vp8l back-references"} if stats[5] else set())
        else:
            got.update({"vp8 segmentation"} if stats[0] and bin(stats[1]).count("1") > 1
                       else set())
            got.update({"vp8 4x4 macroblocks"} if stats[2] else set())
            got.update({"vp8 16x16 macroblocks"} if stats[3] else set())
            got.update({"vp8 skipped macroblocks"} if stats[4] else set())
            got.update({"vp8 normal loop filter"} if stats[5] == 2 else set())

    def frame(parts):
        for tag, payload in parts:
            if tag in (b"VP8L", b"VP8 "):
                image(tag, payload)
            elif tag == b"ALPH":
                got.add(f"alph {'vp8l' if payload[0] & 3 else 'raw'} filter "
                        f"{(payload[0] >> 2) & 3}")

    top = split(data)
    canvas = None
    kinds = []
    for tag, payload in top:
        if tag == b"VP8X":
            canvas = (int.from_bytes(payload[4:7], "little") + 1,
                      int.from_bytes(payload[7:10], "little") + 1)
        elif tag == b"ANMF":
            x, y = 2 * int.from_bytes(payload[0:3], "little"), 2 * int.from_bytes(payload[3:6],
                                                                                  "little")
            w, h = int.from_bytes(payload[6:9], "little") + 1, int.from_bytes(payload[9:12],
                                                                               "little") + 1
            sub = (x, y, w, h) != (0, 0) + canvas
            if sub and not payload[15] & 2 and kinds:
                got.add("anim blended sub-frame")
            if sub and payload[15] & 1:
                got.add("anim disposed sub-frame")
            parts = split(b"RIFF" + bytes(4) + b"WEBP" + payload[16:])
            kinds.append(any(t == b"VP8L" for t, _ in parts))
            if len(kinds) > 1 and kinds[-2] and not kinds[-1]:
                got.add("anim lossy after lossless")
            frame(parts)
    frame([(t, p) for t, p in top if t in (b"ALPH", b"VP8 ", b"VP8L")])
    return got


def test_corpus_coverage():
    """Each feature is reached by the corpus file ``_REACHES`` names for it
    (and every corpus file reads as the oracles, above)."""
    missing = {feat: name for feat, name in _REACHES.items()
               if feat not in _features_of(_corpus_file(name))}
    assert not missing, missing


# ----- where the oracles disagree ---------------------------------------------------


def _tiny_vp8l() -> bytes:
    """A VP8L stream of one opaque black pixel: five simple prefix codes of
    one symbol each (9 bytes; PIL's own is longer)."""
    bits = [0, 0, 0] + [1, 0, 0, 0] * 3 + [1, 0, 1] + [1] * 8 + [1, 0, 0, 0]
    value = sum(b << i for i, b in enumerate(bits))
    return b"\x2f" + bytes(4) + value.to_bytes((len(bits) + 7) // 8, "little")


def _disagreement(case: str) -> bytes:
    ll = _chunks(_pil(_colour("diag3", 6, 8, "RGB"), "RGB", lossless=True))[b"VP8L"]
    lossy = _chunks(_pil(_colour("blobs", 6, 8, "RGBA"), "RGBA", quality=80))
    alph, vp8 = chunk(b"ALPH", lossy[b"ALPH"]), chunk(b"VP8 ", lossy[b"VP8 "])
    return {
        "reserved_flag": riff(vp8x(8, 6, 0x01), chunk(b"VP8L", ll)),
        "alph_before_vp8l": riff(vp8x(8, 6, 0x10), alph, chunk(b"VP8L", ll)),
        "alpha_flag_without_alph": riff(vp8x(8, 6, 0x10), vp8),
        "alph_without_alpha_flag": riff(vp8x(8, 6, 0), alph, vp8),
        "under_32_bytes": riff(chunk(b"VP8L", _tiny_vp8l())),
    }[case]


# (case, PIL reads it, cv2 reads it, the channels of each where it does)
_DISAGREE = [("reserved_flag", False, True, (None, 3)),
             ("alph_before_vp8l", False, True, (None, 4)),
             ("alpha_flag_without_alph", True, True, (4, 4)),
             ("alph_without_alpha_flag", True, True, (4, 3)),
             ("under_32_bytes", True, False, (3, None))]


@pytest.mark.parametrize("case,pil_reads,cv2_reads,channels", _DISAGREE,
                         ids=[c[0] for c in _DISAGREE])
def test_where_the_oracles_disagree(case, pil_reads, cv2_reads, channels):
    """PIL's demuxer refuses VP8X reserved flag bits and an ALPH chunk
    before VP8L, which cv2's WebPDecode reads; the two take a still image's
    alpha from different places (PIL drops an ALPH where the VP8X flag
    lacks alpha, so its alpha is 255); cv2 takes no file under 32 bytes.
    ``imread`` follows PIL and ``imread_gray`` cv2 (else PIL's red)."""
    data = _disagreement(case)
    path = _write(data)
    pil = _outcome(lambda p: np.asarray(Image.open(p)), path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert (not isinstance(pil, Exception)) == pil_reads and (cv is not None) == cv2_reads
    assert (pil.shape[2] if pil_reads else None, cv.shape[2] if cv2_reads else None) == channels
    if case == "alph_without_alpha_flag":
        assert (pil[..., 3] == 255).all()
    if pil_reads and cv2_reads:
        np.testing.assert_array_equal(cv[..., 0], pil[..., 2])
    _held(path)


# ----- refusals ----------------------------------------------------------------------

_REFUSED = [
    ("simple_filter", dict(simple=1), "the simple loop filter"),
    ("sharpness", dict(sharpness=3), "loop-filter sharpness 3"),
    ("lf_deltas", dict(lf_delta=True), "loop-filter deltas"),
    ("partitions", dict(partitions_log2=2), "4 token partitions"),
]


@pytest.mark.parametrize("case,kw,match", _REFUSED, ids=[c[0] for c in _REFUSED])
def test_vp8_forms_without_an_oracle_file_are_refused(case, kw, match):
    """The VP8 forms no encoder here writes (libwebp reads them) raise a
    ValueError that names the form, in both readers."""
    path = _write(riff(chunk(b"VP8 ", vp8_refused(**kw))))
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=match):
            read(path)


@pytest.mark.parametrize("case,match", [("inter", "VP8 inter frame"),
                                        ("profile4", "profile 4"), ("profile7", "profile 7")])
def test_forms_libwebp_refuses(case, match):
    """An inter frame and a profile above 3: PIL and cv2 read nothing, and
    the port names the form."""
    lossy = _chunks(_pil(_colour("blobs", 16, 16, "RGB"), "RGB", quality=75))[b"VP8 "]
    payload = vp8_tag(lossy, inter=True) if case == "inter" else vp8_tag(lossy,
                                                                        profile=int(case[-1]))
    path = _write(riff(chunk(b"VP8 ", payload)))
    for jax in (jax_load, jax_gray):
        assert isinstance(_outcome(jax, path), Exception)
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=match):
            read(path)


def test_identify_takes_webp_as_pil_does():
    """RIFF, WEBP and a first chunk of VP8, VP8L or VP8X, as PIL's
    ``_accept``; another first chunk is no format the port reads."""
    ll = _corpus_file("lossless-noise-37-45-L-6-100")
    assert raster.identify(ll) == "WEBP"
    assert raster.identify(riff(chunk(b"ALPH", b"\0" * 4), ll[12:])) is None
    path = _write(riff(chunk(b"ICCP", bytes(8))))
    with pytest.raises(ValueError, match="not a file of a format the port reads"):
        imread(path)


# ----- damaged files ------------------------------------------------------------------

_SEEDS = ("lossless-noise-37-45-L-6-100", "lossy-blobs-37-45-RGBA-75-4-100",
          "anim-mixed_min", "crafted-dispose_then_blend", "alph-raw-filter3")


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.sampled_from(_SEEDS), cut=st.booleans(), at=st.floats(0, 1),
       bit=st.integers(0, 7))
def test_damaged_files_raise_naming_the_file(seed, cut, at, bit):
    """A file cut short or with one bit flipped reads, or raises a
    ValueError that names it; nothing else escapes and the process lives."""
    data = bytearray(_corpus_file(seed))
    pos = min(int(at * len(data)), len(data) - 1)
    if cut:
        data = data[:pos]
    else:
        data[pos] ^= 1 << bit
    path = _write(bytes(data))
    for read in (imread, imread_gray):
        try:
            out = read(path)
        except ValueError as exc:
            assert path in str(exc)
        else:
            assert isinstance(out, np.ndarray) and out.dtype == np.uint8


def test_damaged_files_as_the_oracles_see_them():
    """A truncated last chunk, a RIFF size past the file's end, and a
    bit-flipped lossless and lossy stream: held to both oracles."""
    ll = _corpus_file("lossless-blobs-128-128-L-3-0")
    lossy = _corpus_file("lossy-blobs-37-45-RGBA-75-4-100")
    for data in (ll[:-3], riff(*(chunk(t, p) for t, p in split(ll)), size=len(ll) + 100),
                 ll[:200] + bytes([ll[200] ^ 0x10]) + ll[201:],
                 lossy[:100] + bytes([lossy[100] ^ 0x04]) + lossy[101:]):
        _held(_write(data))


def _bounded(data: bytes) -> None:
    path = _write(data)
    for read in (imread, imread_gray):
        tracemalloc.start()
        try:
            with pytest.raises(ValueError, match=path):
                read(path)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 1 << 20, peak


def test_headers_claiming_more_than_their_data_are_refused_before_allocating():
    """A VP8L header of 16384 x 16384 over bytes that hold no prefix code, a
    VP8 key frame of 16383 x 16383 whose first partition cannot hold its
    macroblocks, and an animation canvas of 16384 x 16384 whose first frame
    is damaged raise before any buffer of their size is allocated (the
    peak traced allocation stays under 1 MiB); so does a canvas over 2^28
    pixels, which the port refuses."""
    big = (16383 | 16383 << 14).to_bytes(4, "little")
    _bounded(riff(chunk(b"VP8L", b"\x2f" + big + bytes([0xFF]) * 40)))
    lossy = bytearray(_chunks(_corpus_file("lossy-noise-37-45-RGB-0-0-100"))[b"VP8 "])
    lossy[6:10] = (16383).to_bytes(2, "little") * 2
    _bounded(riff(chunk(b"VP8 ", bytes(lossy))))
    frame = chunk(b"VP8L", b"\x2f" + (7 | 7 << 14).to_bytes(4, "little") + bytes([0xFF]) * 30)
    _bounded(riff(vp8x(16384, 16384, 0x12), anim(), anmf(0, 0, 8, 8, frame)))
    ok = _vp8l_frame("noise", 8, 8, 0, False)
    _bounded(riff(vp8x(1 << 20, 1 << 10, 0x02), anim(), anmf(0, 0, 8, 8, ok)))


# ----- the fixtures of chip_smoke.py's phase 20 ------------------------------------------


@pytest.mark.parametrize("form", ["lossy", "mask", "lossless", "alpha", "mask512", "anim"])
def test_fixtures_read_to_the_phase_digests(form):
    """``tests/fixtures/*.webp`` (written by ``tests/make_webp_fixtures.py``)
    read through the JAX package's readers and the port's to the digests
    phase 20 holds on the card (``chip_smoke.WEBP_SHA256``)."""
    import chip_smoke

    name, want = chip_smoke.WEBP_FILES[form], chip_smoke.WEBP_SHA256[form]
    path = os.path.join(os.path.dirname(chip_smoke.__file__), "tests", "fixtures", name)
    for read in ((jax_load, jax_gray), (imread, imread_gray)):
        got = [list(chip_smoke.raster_digest(fn(path))) for fn in read]
        assert got == [list(w) for w in want], (read, got)
