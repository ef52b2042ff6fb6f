"""JPEG 2000, read by the port (``data/jpeg2000.py``, ``csrc/j2k_decode.cpp``)
on the CPU at small sizes; every comparison is exact (tolerance 0):
``imread`` against the JAX package's ``cli._load_array`` (PIL 12.1,
OpenJPEG 2.5.4) and ``imread_gray`` against its ``datasets._imread_gray``
(cv2 5.0, OpenJPEG 2.5.3, then PIL), in dtype, shape and every sample, or
both raising, on the same file:

- the corpus: files PIL writes (L, LA, I;16, RGB and RGBA; reversible and
  irreversible; both quality modes and 1-5 layers; 1 to the most
  resolutions a size allows; code-blocks from 4 x 4 to 64 x 64, square and
  not; precincts; tiles with tile and image offsets; the five progression
  orders; MCT on and off; signed samples, comments and PLT markers; JP2
  files and codestreams) and cv2 writes (grey, 16-bit and BGR at its
  compression rates from 1 to 1000), of sizes 1 x N, N x 1, odd and prime,
  of noise, gradients, flat images, masks and EM-like blobs; and files put
  together from their pieces (``_jp2_writer``): components subsampled,
  several tile-parts a tile, SOP markers, boxes and markers both readers
  pass over;
- the coverage test names the corpus file that reaches each progression
  order, cleanup's run mode, the 5/3 and 9/7 wavelets, the RCT and the
  ICT, a code-block cut short by layers, offset tiles and subsampled
  geometry;
- where the two oracles disagree (LA, an image offset, signed samples,
  subsampled components: cv2 reads nothing and PIL's array is taken) each
  reader follows its own, and the test pins the difference;
- the refused forms raise naming themselves; truncated and bit-flipped
  files raise a ValueError naming the file or equal both oracles
  (hypothesis); a header beyond the port's bound is refused before
  allocating; the decoder's constant tables are those of the installed
  libopenjp2; the committed fixtures of ``chip_smoke.py``'s phase 21 read
  to its ``JP2_SHA256``.
"""

import functools
import io
import os
import struct
import tempfile
import tracemalloc
import warnings

import cv2
import numpy as np
import PIL
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import _jp2_writer as jw
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import jpeg2000, raster
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
    return tempfile.TemporaryDirectory(prefix="jp2-")


def _write(data: bytes, suffix: str = ".jp2") -> str:
    fd, path = tempfile.mkstemp(suffix=suffix, dir=_tmpdir().name)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return path


def _suffix(data: bytes) -> str:
    return ".jp2" if data[:12] == jpeg2000.SIGNATURE else ".j2k"


# ----- images ----------------------------------------------------------------------


def _image(kind: str, h: int, w: int, seed: int = 0, bits: int = 8) -> np.ndarray:
    """A seeded (h, w) plane of ``kind``, uint8 or (``bits`` 16) uint16."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    top = (1 << bits) - 1
    if kind == "noise":
        v = rng.integers(0, top + 1, (h, w)).astype(np.float64)
    elif kind == "grad":
        v = (x / max(w - 1, 1) + y / max(h - 1, 1)) / 2 * top
    elif kind == "flat":
        v = np.full((h, w), top * 0.68)
    elif kind == "mask":
        v = rng.integers(0, 4, (h // 4 + 1, w // 4 + 1)).repeat(4, 0).repeat(4, 1)[:h, :w] * (
            top // 3)
    elif kind == "blobs":
        v = np.full((h, w), 0.78)
        for _ in range(6):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            v -= 0.45 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * (w / 9 + 1) ** 2))
        v = (v + rng.normal(0, 0.03, (h, w))) * top
    else:
        raise KeyError(kind)
    return np.clip(v, 0, top).astype(np.uint8 if bits == 8 else np.uint16)


def _colour(kind: str, h: int, w: int, mode: str, seed: int = 0) -> np.ndarray:
    """``_image`` as PIL mode L, I;16, LA, RGB or RGBA (channels shifted
    copies)."""
    if mode == "I;16":
        return _image(kind, h, w, seed, 16)
    v = _image(kind, h, w, seed)
    planes = [v, np.roll(v, 3, 1), 255 - v, np.roll(_image("blobs", h, w, seed + 1), 5, 0)]
    picks = {"L": [0], "LA": [0, 3], "RGB": [0, 1, 2], "RGBA": [0, 1, 2, 3]}[mode]
    return planes[0] if mode == "L" else np.dstack([planes[k] for k in picks])


def _pil(arr: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PIL's deprecation of the mode argument
        Image.fromarray(arr, mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _cv2(arr: np.ndarray, rate: int) -> bytes:
    ok, enc = cv2.imencode(".jp2", arr, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, rate])
    assert ok
    return enc.tobytes()


# ----- the corpus ------------------------------------------------------------------

# (kind, h, w, mode, options)
_PIL = [
    ("blobs", 64, 64, "L", {}),
    ("blobs", 64, 64, "L", dict(irreversible=True)),
    ("noise", 37, 45, "L", dict(irreversible=True, quality_layers=[20])),
    ("grad", 37, 45, "L", dict(quality_mode="dB", quality_layers=[30, 40, 50])),
    ("blobs", 64, 64, "L", dict(quality_layers=[40, 20, 10, 5, 2])),
    ("blobs", 64, 64, "L", dict(irreversible=True, quality_mode="dB",
                                 quality_layers=[25, 35, 45, 55])),
    ("noise", 33, 29, "I;16", {}),
    ("blobs", 64, 64, "I;16", dict(irreversible=True, quality_layers=[10])),
    ("grad", 31, 40, "I;16", dict(quality_layers=[30, 8])),
    ("blobs", 40, 48, "RGB", {}),
    ("blobs", 40, 48, "RGB", dict(mct=1)),
    ("noise", 40, 48, "RGB", dict(mct=1, irreversible=True, quality_layers=[15])),
    ("blobs", 40, 48, "RGB", dict(irreversible=True)),
    ("noise", 40, 48, "RGBA", {}),
    ("blobs", 40, 48, "RGBA", dict(irreversible=True, mct=1, quality_layers=[12, 4])),
    ("blobs", 31, 33, "LA", {}),
    ("mask", 31, 33, "LA", dict(irreversible=True)),
    *[("grad", 32, 32, "L", dict(num_resolutions=n, irreversible=n % 2 == 0))
      for n in range(1, 7)],
    ("noise", 37, 45, "L", dict(codeblock_size=(4, 4))),
    ("blobs", 37, 45, "L", dict(codeblock_size=(8, 64), irreversible=True)),
    ("blobs", 64, 64, "L", dict(codeblock_size=(64, 16))),
    ("blobs", 64, 64, "L", dict(codeblock_size=(32, 32), precinct_size=(16, 16),
                                 quality_layers=[20, 5])),
    ("blobs", 64, 96, "RGB", dict(precinct_size=(32, 64), codeblock_size=(8, 8),
                                   irreversible=True)),
    ("blobs", 70, 50, "L", dict(tile_size=(32, 32), num_resolutions=3)),
    ("blobs", 40, 50, "L", dict(offset=(7, 9), tile_offset=(2, 3), tile_size=(16, 16),
                                 num_resolutions=2)),
    ("grad", 45, 43, "RGB", dict(offset=(5, 3), tile_offset=(4, 1), tile_size=(20, 24),
                                  num_resolutions=3, irreversible=True, mct=1)),
    ("blobs", 40, 50, "L", dict(offset=(3, 5), tile_size=(64, 64))),
    ("blobs", 70, 50, "L", dict(progression="RLCP", quality_layers=[30, 10])),
    ("blobs", 70, 50, "L", dict(progression="RPCL", tile_size=(32, 32), num_resolutions=3,
                                 precinct_size=(16, 16), codeblock_size=(8, 8))),
    ("blobs", 40, 50, "RGB", dict(progression="PCRL", precinct_size=(32, 32),
                                   codeblock_size=(8, 8), quality_layers=[25, 5])),
    ("blobs", 40, 50, "RGB", dict(progression="CPRL", plt=True, comment="EM slice",
                                   codeblock_size=(16, 16), precinct_size=(32, 32))),
    ("grad", 40, 50, "RGBA", dict(progression="RPCL", quality_layers=[30, 10, 3],
                                   irreversible=True)),
    ("blobs", 20, 21, "L", dict(signed=True)),
    ("blobs", 20, 21, "I;16", dict(signed=True, irreversible=True)),
    ("blobs", 20, 21, "RGB", dict(signed=True)),
    ("blobs", 23, 19, "L", dict(no_jp2=True)),
    ("blobs", 23, 19, "RGB", dict(no_jp2=True, mct=1, irreversible=True)),
    ("noise", 23, 19, "I;16", dict(no_jp2=True, plt=True)),
    ("noise", 1, 37, "L", {}),
    ("noise", 37, 1, "L", dict(irreversible=True)),
    ("grad", 1, 1, "L", {}),
    ("grad", 97, 1, "RGB", {}),
    ("noise", 17, 19, "L", dict(irreversible=True, quality_layers=[8, 2])),
    ("flat", 29, 31, "L", dict(irreversible=True)),
    ("flat", 29, 31, "RGB", dict(mct=1)),
    ("mask", 64, 64, "L", {}),
    ("mask", 64, 64, "L", dict(irreversible=True, quality_layers=[30])),
]
# (kind, h, w, cv2 image: grey, grey16 or bgr, rate x 1000)
_CV2 = [("blobs", 35, 41, "grey", 1000), ("blobs", 35, 41, "grey", 100),
        ("noise", 35, 41, "grey", 10), ("blobs", 64, 64, "grey16", 1000),
        ("blobs", 64, 64, "grey16", 50), ("blobs", 33, 47, "bgr", 1000),
        ("blobs", 33, 47, "bgr", 200), ("noise", 33, 47, "bgr", 1)]


def _pil_file(kind, h, w, mode, opts):
    return _pil(_colour(kind, h, w, mode), mode, **opts)


def _cv2_file(kind, h, w, form, rate):
    if form == "grey16":
        return _cv2(_image(kind, h, w, bits=16), rate)
    v = _image(kind, h, w)
    return _cv2(np.dstack([v, 255 - v, np.roll(v, 2, 0)]) if form == "bgr" else v, rate)


def _subsampled(which, h, w, mode="RGB", levels=3):
    """A codestream whose components in ``which`` are subsampled 2 x 2."""
    opts = dict(progression="CPRL", plt=True, no_jp2=True, num_resolutions=levels)
    full = _pil(_colour("blobs", h, w, mode, 1), mode, **opts)
    half = _pil(_colour("grad", -(-h // 2), -(-w // 2), mode, 2), mode, **opts)
    return jw.subsampled(full, half, which, levels)


def _split_parts(data: bytes) -> bytes:
    """Each tile's data in two tile-parts (the second a few bytes long), and
    the last tile-part's length 0 (to the EOC)."""
    cs = jw.Codestream(data)
    parts = []
    for tile, _, _, markers, body in cs.parts:
        cut = len(body) - min(len(body) // 2, 9)
        parts += [(tile, 0, 2, markers, body[:cut]), (tile, 1, 2, [], body[cut:])]
    cs.parts = parts
    out = bytearray(cs.build())
    last = out.rfind(b"\xff\x90\x00\x0a")
    out[last + 6:last + 10] = bytes(4)
    return bytes(out)


def _with_sop(data: bytes) -> bytes:
    """An SOP marker before each packet (the PLT lengths), and the coding
    style that says so."""
    cs = jw.Codestream(data)
    lens = cs.packet_lengths()
    body, pos, out = cs.parts[0][4], 0, b""
    for k, n in enumerate(lens):
        out += struct.pack(">HHH", 0xFF91, 4, k % 65536) + body[pos:pos + n]
        pos += n
    cod = bytearray(cs.marker(jw.COD))
    cod[0] |= 2
    cs.set_marker(jw.COD, bytes(cod))
    tile, part, nparts, markers, _ = cs.parts[0]
    cs.parts = [(tile, part, nparts, [], out + body[pos:])]
    return cs.build()


def _crafted(case: str) -> bytes:
    grey = _pil(_colour("blobs", 21, 26, "L"), "L")
    cs = jw.codestream_of(grey)
    if case.startswith("subsampled"):
        which, h, w, mode = {"subsampled-first": ({0}, 24, 32, "RGB"),
                             "subsampled-all": ({0, 1, 2}, 24, 32, "RGB"),
                             "subsampled-first-odd": ({0}, 23, 31, "RGB"),
                             "subsampled-all-odd": ({0, 1, 2}, 23, 31, "RGB"),
                             "subsampled-alpha": ({3}, 24, 32, "RGBA"),
                             "subsampled-first-alpha-odd": ({0, 3}, 25, 33, "RGBA"),
                             "subsampled-rgba": ({0, 1, 2, 3}, 24, 32, "RGBA")}[case]
        return _subsampled(which, h, w, mode)
    if case == "tile-parts":
        return _split_parts(_pil(_colour("blobs", 70, 50, "L"), "L", tile_size=(32, 32),
                                 num_resolutions=3, no_jp2=True, irreversible=True))
    if case == "sop":
        return _with_sop(_pil(_colour("blobs", 40, 50, "L"), "L", plt=True, no_jp2=True,
                              quality_layers=[20, 5], precinct_size=(16, 16),
                              num_resolutions=3))
    box = {"xml": jw.box(b"xml ", b"<em/>"), "uuid": jw.box(b"uuid", bytes(20))}
    return {
        "xml": jw.jp2(cs, 21, 26, 1, 7, 17, before_codestream=box["xml"]),
        "uuid": jw.jp2(cs, 21, 26, 1, 7, 17, before_codestream=box["uuid"]),
        "res": jw.jp2(cs, 21, 26, 1, 7, 17, header_extra=jw.box(b"res ", jw.box(
            b"resc", struct.pack(">HHHHbb", 3, 1, 3, 1, 4, 4)))),
        "trailing-box": grey + jw.box(b"xml ", b"<after/>"),
        "after-eoc": cs + b"trailing bytes",
        "mct-grey": jw.with_mct(cs, 1),
        "crg": _with_crg(cs),
    }[case]


def _with_crg(cs: bytes) -> bytes:
    c = jw.Codestream(cs)
    c.insert(0xFF63, struct.pack(">HH", 0, 0), after=jw.COD)
    return c.build()


def _name(opts: dict) -> str:
    return "-".join(f"{k}={v}".replace(" ", "") for k, v in sorted(opts.items())) or "default"


_CORPUS = {}
for _k in _PIL:
    _CORPUS[f"pil-{_k[3]}-{_k[0]}-{_k[1]}x{_k[2]}-{_name(_k[4])}"] = functools.partial(
        _pil_file, *_k)
for _k in _CV2:
    _CORPUS["cv2-" + "-".join(map(str, _k))] = functools.partial(_cv2_file, *_k)
for _k in ("subsampled-first", "subsampled-all", "subsampled-first-odd", "subsampled-all-odd",
           "subsampled-alpha", "subsampled-first-alpha-odd", "subsampled-rgba", "tile-parts",
           "sop", "xml", "uuid", "res", "trailing-box", "after-eoc", "mct-grey", "crg"):
    _CORPUS["crafted-" + _k] = functools.partial(_crafted, _k)


@functools.lru_cache(maxsize=None)
def _corpus_file(name: str) -> bytes:
    return _CORPUS[name]()


@functools.lru_cache(maxsize=None)
def _corpus_path(name: str) -> str:
    data = _corpus_file(name)
    return _write(data, _suffix(data))


@pytest.mark.parametrize("name", sorted(_CORPUS))
def test_corpus_reads_as_the_oracles(name):
    _held(_corpus_path(name))


# ----- coverage ------------------------------------------------------------------

_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
# feature -> the corpus file that reaches it
_REACHES = {
    "progression LRCP": "pil-L-blobs-64x64-default",
    "progression RLCP": "pil-L-blobs-70x50-progression=RLCP-quality_layers=[30,10]",
    "progression RPCL": "pil-L-blobs-70x50-codeblock_size=(8,8)-num_resolutions=3-"
                        "precinct_size=(16,16)-progression=RPCL-tile_size=(32,32)",
    "progression PCRL": "pil-RGB-blobs-40x50-codeblock_size=(8,8)-precinct_size=(32,32)-"
                        "progression=PCRL-quality_layers=[25,5]",
    "progression CPRL": "pil-RGB-blobs-40x50-codeblock_size=(16,16)-comment=EMslice-"
                        "plt=True-precinct_size=(32,32)-progression=CPRL",
    "cleanup run mode": "pil-L-mask-64x64-default",
    "5/3 wavelet": "pil-I;16-noise-33x29-default",
    "9/7 wavelet": "pil-L-blobs-64x64-irreversible=True",
    "RCT": "pil-RGB-blobs-40x48-mct=1",
    "ICT": "pil-RGB-noise-40x48-irreversible=True-mct=1-quality_layers=[15]",
    "code-block cut short by layers": "pil-L-noise-37x45-irreversible=True-quality_layers=[20]",
    "code-block of several layers": "pil-L-blobs-64x64-quality_layers=[40,20,10,5,2]",
    "offset tiles": "pil-L-blobs-40x50-num_resolutions=2-offset=(7,9)-tile_offset=(2,3)-"
                    "tile_size=(16,16)",
    "subsampled geometry": "crafted-subsampled-first-odd",
    "SOP markers": "crafted-sop",
    "several tile-parts a tile": "crafted-tile-parts",
}


def _features_of(data: bytes) -> set:
    """What one file reaches, from the decoder's stats."""
    stats = np.zeros(len(native.J2K_STATS), np.int64)
    native.j2k_decode(jw.codestream_of(data), stats)
    s = dict(zip(native.J2K_STATS, stats))
    got = {f"progression {p}" for k, p in enumerate(_PROGRESSIONS) if s["progressions"] >> k & 1}
    for feat, key in (("cleanup run mode", "run modes"), ("5/3 wavelet", "5/3"),
                      ("9/7 wavelet", "9/7"), ("RCT", "RCT"), ("ICT", "ICT"),
                      ("code-block cut short by layers", "cut short"),
                      ("code-block of several layers", "multi-layer"),
                      ("offset tiles", "tile offset"), ("subsampled geometry", "subsampled"),
                      ("SOP markers", "SOP")):
        if s[key]:
            got.add(feat)
    if len(jw.Codestream(data).parts) > s["tiles"]:
        got.add("several tile-parts a tile")
    return got


def test_corpus_coverage():
    """Each feature is reached by the corpus file ``_REACHES`` names for it
    (and every corpus file reads as the oracles, above)."""
    missing = {feat: name for feat, name in _REACHES.items()
               if feat not in _features_of(_corpus_file(name))}
    assert not missing, missing


# ----- where the oracles disagree ---------------------------------------------------

# (case, the corpus file, channels of PIL's array, whether cv2 reads it)
_DISAGREE = [("la", "pil-LA-blobs-31x33-default", 2, False),
             ("offset", "pil-L-blobs-40x50-offset=(3,5)-tile_size=(64,64)", None, False),
             ("signed", "pil-RGB-blobs-20x21-signed=True", 3, False),
             ("subsampled", "crafted-subsampled-all", 3, False),
             ("plain", "pil-RGB-blobs-40x48-mct=1", 3, True)]


@pytest.mark.parametrize("case,name,channels,cv2_reads", _DISAGREE,
                         ids=[c[0] for c in _DISAGREE])
def test_where_the_oracles_disagree(case, name, channels, cv2_reads):
    """cv2 reads no two-component image, no image offset from the origin, no
    signed component and no subsampled one; there ``_imread_gray`` takes
    PIL's array, channel 0 (red, or L of LA), and so does ``imread_gray``.
    PIL maps signed 8-bit samples v to v + 128, so that its array is not the
    one written.  Where cv2 reads the file its channel 0 is blue."""
    path = _corpus_path(name)
    pil = np.asarray(Image.open(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert (cv is not None) == cv2_reads
    assert (pil.shape[2] if pil.ndim == 3 else None) == channels
    want_gray = cv[..., 0] if cv2_reads else (pil[..., 0] if pil.ndim == 3 else pil)
    np.testing.assert_array_equal(imread_gray(path), want_gray)
    np.testing.assert_array_equal(imread(path), pil)
    if cv2_reads:
        np.testing.assert_array_equal(cv[..., 0], pil[..., 2])
    if case == "signed":  # PIL writes each byte as a signed sample and reads it back + 128
        written = _colour("blobs", 20, 21, "RGB")
        np.testing.assert_array_equal(pil, (written + np.uint8(128)))


# ----- refusals ----------------------------------------------------------------------


def _refused(case: str) -> bytes:
    """A form nothing here writes, patched into a PIL-written file."""
    grey = _pil(_colour("blobs", 21, 26, "L"), "L")
    rgb = _pil(_colour("blobs", 21, 26, "RGB"), "RGB")
    cs, crgb = jw.codestream_of(grey), jw.codestream_of(rgb)
    styles = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32,
              "ht": 64}
    if case in styles:
        return jw.with_style(cs, styles[case])
    c = jw.Codestream(cs)
    if case in ("rgn", "poc", "ppm", "cap", "part2-marker"):
        marker, payload = {"rgn": (0xFF5E, bytes([0, 0, 3])),
                           "poc": (0xFF5F, bytes([0, 0, 0, 1, 3, 1, 0])),
                           "ppm": (0xFF60, bytes([0]) + struct.pack(">I", 1) + b"\0"),
                           "cap": (0xFF50, struct.pack(">I", 1 << 17) + b"\0\0"),
                           "part2-marker": (0xFF74, bytes([0, 0, 0, 0, 0]))}[case]
        c.insert(marker, payload)
        return c.build()
    if case == "ppt":
        tile, part, nparts, markers, body = c.parts[0]
        c.parts[0] = (tile, part, nparts, markers + [(0xFF61, b"\0\0")], body)
        return c.build()
    if case in ("part2", "htj2k"):
        siz = bytearray(c.marker(jw.SIZ))
        siz[0] = 0x80 if case == "part2" else 0x40
        c.set_marker(jw.SIZ, bytes(siz))
        return c.build()
    if case == "precision12":
        siz = bytearray(c.marker(jw.SIZ))
        siz[36] = 11
        c.set_marker(jw.SIZ, bytes(siz))
        return c.build()
    if case == "palette":
        return jw.jp2(crgb, 21, 26, 3, 7, 16, header_extra=jw.box(
            b"pclr", struct.pack(">HB", 2, 3) + bytes([7, 7, 7]) + bytes(6)) + jw.box(
            b"cmap", struct.pack(">HBB", 0, 1, 0) * 3))
    if case == "sycc":
        return jw.jp2(crgb, 21, 26, 3, 7, 18)
    if case == "icc":
        return jw.jp2(cs, 21, 26, 1, 7, 17, colr=struct.pack(">BBB", 2, 0, 0) + bytes(128))
    if case == "cdef-swap":
        entries = struct.pack(">HHHHHHHHHH", 3, 0, 0, 3, 1, 0, 2, 2, 0, 1)
        return jw.jp2(crgb, 21, 26, 3, 7, 16, header_extra=jw.box(b"cdef", entries))
    if case == "sycc-subsampled":
        return _subsampled({1, 2}, 24, 32)
    raise KeyError(case)


_REFUSED = [
    ("bypass", "code-block style BYPASS"), ("reset", "code-block style RESET"),
    ("termall", "code-block style TERMALL"), ("vsc", "code-block style VSC"),
    ("pterm", "code-block style PTERM"), ("segsym", "code-block style SEGSYM"),
    ("ht", "code-block style HT"),
    ("rgn", r"an RGN marker \(region of interest\)"),
    ("poc", r"a POC marker \(progression order change\)"),
    ("ppm", r"a PPM marker \(packed packet headers\)"),
    ("ppt", r"a PPT marker \(packed packet headers\)"),
    ("cap", r"an HTJ2K marker \(CAP or CPF, Part 15\)"),
    ("part2-marker", "a Part 2 marker 0xff74"),
    ("part2", r"a Part 2 codestream \(Rsiz 0x8000\)"),
    ("htj2k", r"an HTJ2K codestream \(Rsiz 0x4000\)"),
    ("precision12", "12-bit samples, which the port does not read"),
    ("palette", r"a palette \(pclr and cmap boxes\)"),
    ("sycc", r"a colr colour space 18 \(sYCC\)"),
    ("icc", r"a colr box of method 2 \(an ICC profile\)"),
    ("cdef-swap", "a cdef box that reorders or reassigns channels"),
    ("sycc-subsampled", "chroma components subsampled under a full-size first component, "
                        "which PIL reads as sYCC"),
]


@pytest.mark.parametrize("case,match", _REFUSED, ids=[c[0] for c in _REFUSED])
def test_forms_nothing_here_writes_are_refused(case, match):
    """The forms of the refusal list raise a ValueError that names the form,
    in both readers (OpenJPEG reads some of them: a code-block style
    changes how the PIL-written data decodes, so its samples differ)."""
    data = _refused(case)
    path = _write(data, _suffix(data))
    for read in (imread, imread_gray):
        with pytest.raises(ValueError, match=match):
            read(path)


def test_identify_takes_jpeg2000_as_pil_does():
    """A JP2 signature box or a codestream's SOC and SIZ markers, as PIL's
    ``_accept``; JPX and other boxes after the signature are JP2 files too
    (the port reads their boxes); a codestream without SIZ is no format."""
    assert raster.identify(_corpus_file("pil-L-blobs-64x64-default")) == "JPEG2000"
    assert raster.identify(_corpus_file("pil-L-blobs-23x19-no_jp2=True")) == "JPEG2000"
    assert raster.identify(b"\xff\x4f\xff\x52" + bytes(40)) is None


# ----- damaged files ------------------------------------------------------------------

_SEEDS = ("pil-L-blobs-64x64-default",
          "pil-L-noise-37x45-irreversible=True-quality_layers=[20]",
          "pil-RGB-blobs-40x48-mct=1",
          "pil-L-blobs-70x50-codeblock_size=(8,8)-num_resolutions=3-precinct_size=(16,16)-"
          "progression=RPCL-tile_size=(32,32)",
          "pil-I;16-noise-23x19-no_jp2=True-plt=True",
          "pil-LA-mask-31x33-irreversible=True")


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.sampled_from(_SEEDS), cut=st.booleans(), at=st.floats(0, 1),
       bit=st.integers(0, 7))
def test_damaged_files_raise_or_read_as_the_oracles(seed, cut, at, bit):
    """A file cut short or with one bit flipped raises a ValueError that
    names it, or reads as both oracles read it: never another array."""
    data = bytearray(_corpus_file(seed))
    pos = min(int(at * len(data)), len(data) - 1)
    if cut:
        data = data[:pos]
    else:
        data[pos] ^= 1 << bit
    path = _write(bytes(data), _suffix(_corpus_file(seed)))
    for port, jax in ((imread, jax_load), (imread_gray, jax_gray)):
        try:
            got = port(path)
        except ValueError as exc:
            assert path in str(exc)
            continue
        want = _outcome(jax, path)
        assert not isinstance(want, Exception), (port.__name__, want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cut", ["half", "last10"])
def test_truncated_lossless_files_are_refused_as_the_oracles_refuse_them(cut):
    """A lossless file cut at half and at its last 10 bytes: PIL raises and
    cv2 returns None; the port raises a ValueError naming the file."""
    data = _corpus_file("pil-L-blobs-64x64-default")
    path = _write(data[:len(data) // 2] if cut == "half" else data[:-10])
    assert isinstance(_outcome(jax_load, path), Exception)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    _held(path)


def _bounded(data: bytes) -> None:
    path = _write(data, _suffix(data))
    for read in (imread, imread_gray):
        tracemalloc.start()
        try:
            with pytest.raises(ValueError, match=path):
                read(path)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 1 << 20, peak


def test_headers_beyond_the_bound_are_refused_before_allocating():
    """A SIZ marker claiming 20000 x 20000 (400 million pixels, over the
    port's bound, PIL's 178956970) raises before any buffer of its size is
    allocated (the peak traced allocation stays under 1 MiB), in a JP2
    file and in a codestream; so does one within the bound whose data holds
    one of its tiles (16384 x 10000 in tiles of 64 x 64)."""
    c = jw.Codestream(_corpus_file("pil-L-blobs-23x19-no_jp2=True"))
    siz = bytearray(c.marker(jw.SIZ))
    struct.pack_into(">IIIIII", siz, 2, 20000, 20000, 0, 0, 20000, 20000)
    c.set_marker(jw.SIZ, bytes(siz))
    _bounded(c.build())
    _bounded(jw.jp2(c.build(), 20000, 20000, 1, 7, 17))
    struct.pack_into(">IIIIII", siz, 2, 16384, 10000, 0, 0, 64, 64)
    c.set_marker(jw.SIZ, bytes(siz))
    _bounded(c.build())


# ----- the decoder's tables against libopenjp2 -------------------------------------------


def _libopenjp2() -> bytes:
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    names = [n for n in os.listdir(libs) if n.startswith("libopenjp2")]
    assert len(names) == 1, names
    with open(os.path.join(libs, names[0]), "rb") as f:
        return f.read()


def _relative_relocations(so: bytes) -> dict:
    """{virtual address: addend} of the R_X86_64_RELATIVE relocations of an
    ELF64 shared object (its SHT_RELA sections)."""
    shoff, = struct.unpack_from("<Q", so, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", so, 0x3A)
    relocs = {}
    for k in range(shnum):
        sh = shoff + k * shentsize
        kind, = struct.unpack_from("<I", so, sh + 4)
        offset, size = struct.unpack_from("<QQ", so, sh + 0x18)
        entsize, = struct.unpack_from("<Q", so, sh + 0x38)
        if kind != 4:  # SHT_RELA
            continue
        for r in range(size // entsize):
            r_off, r_info, r_add = struct.unpack_from("<QQq", so, offset + r * entsize)
            if r_info & 0xFFFFFFFF == 8:  # R_X86_64_RELATIVE
                relocs[r_off] = r_add
    return relocs


def _vaddr(so: bytes, file_offset: int) -> int:
    """The virtual address of a file offset, by the loaded segments."""
    phoff, = struct.unpack_from("<Q", so, 0x20)
    phentsize, phnum = struct.unpack_from("<HH", so, 0x36)
    for k in range(phnum):
        ph = phoff + k * phentsize
        kind, = struct.unpack_from("<I", so, ph)
        off, vaddr, _, filesz = struct.unpack_from("<QQQQ", so, ph + 8)
        if kind == 1 and off <= file_offset < off + filesz:
            return vaddr + file_offset - off
    raise AssertionError("no segment holds the table")


def test_tables_are_libopenjp2s():
    """The zero-coding contexts of the four orientations, the sign contexts
    and sign flips, the MQ coder's 94 states (each Qe and MPS, and the
    states its MPS and LPS lead to, by the relocations of the table's
    pointers) and the 9/7 and ICT constants are found, byte for byte, in
    the libopenjp2 that PIL loads."""
    so = _libopenjp2()
    t = native.j2k_tables()
    zc, sc, spb = t[:2048], t[2048:2304], t[2304:2560]
    assert so.find(zc) >= 0 and so.find(sc) >= 0 and so.find(spb) >= 0
    states = np.frombuffer(t[2560:2560 + 94 * 16], np.uint32).reshape(94, 4)
    heads = b"".join(struct.pack("<IIQQ", q, m, 0, 0) for q, m, _, _ in states)
    found = [k for k in range(0, len(so) - len(heads), 8)
             if so[k:k + 8] == heads[:8]
             and all(so[k + 24 * i:k + 24 * i + 8] == heads[24 * i:24 * i + 8]
                     for i in range(94))]
    assert len(found) == 1, found
    base = _vaddr(so, found[0])
    relocs = _relative_relocations(so)
    for i, (_, _, nmps, nlps) in enumerate(states):
        assert relocs[base + 24 * i + 8] == base + 24 * int(nmps), i
        assert relocs[base + 24 * i + 16] == base + 24 * int(nlps), i
    for value in np.frombuffer(t[2560 + 94 * 16:], np.float32):
        assert so.find(struct.pack("<f", value)) >= 0 or so.find(struct.pack("<f", -value)) >= 0


# ----- the fixtures of chip_smoke.py's phase 21 --------------------------------------------


@pytest.mark.parametrize("form", ["slice97", "slice16", "rgb", "tiled", "j2k", "mask",
                                  "mask_tiled"])
def test_fixtures_read_to_the_phase_digests(form):
    """``tests/fixtures/jp2_*`` (written by ``tests/make_jp2_fixtures.py``)
    read through the JAX package's readers and the port's to the digests
    phase 21 holds on the card (``chip_smoke.JP2_SHA256``)."""
    import chip_smoke

    name, want = chip_smoke.JP2_FILES[form], chip_smoke.JP2_SHA256[form]
    path = os.path.join(os.path.dirname(chip_smoke.__file__), "tests", "fixtures", name)
    for read in ((jax_load, jax_gray), (imread, imread_gray)):
        got = [list(chip_smoke.raster_digest(fn(path))) for fn in read]
        assert got == [list(w) for w in want], (read, got)
