"""DDS, BLP, FTEX and GBR (``data/textures.py``, the blocks by
``csrc/bcn_decode.cpp``), read by the port on the CPU at small sizes;
every comparison is exact (tolerance 0): ``imread`` against the JAX
package's ``cli._load_array`` (PIL) and ``imread_gray`` against its
``datasets._imread_gray`` (cv2, which reads none of them, then PIL), in
dtype, shape and every sample, or both raising, on the same file:

- DDS files PIL writes (DXT1, DXT3, DXT5, BC2, BC3, BC5; L, LA, RGB, RGBA);
  DX10 and FOURCC files of seeded random blocks of BC1-BC7, BC4, BC5S and
  BC6H UF16 and SF16 that reach every BC6H and BC7 mode, the reserved ones
  included (counted from each block's mode bits); odd sizes; mipmaps;
  ``DDPF_RGB`` of other masks and bit counts, cut short (PIL reads zeros);
  a palette; R8G8B8A8;
- BLP1 and BLP2 palette files PIL writes; BLP1 JPEG (grey, colour, CMYK)
  and BLP2 DXT1, DXT3 and DXT5 put together by ``_texture_writer``, with
  and without alpha, of widths that are not a multiple of 4; the same
  blocks under BLP2's Python rule and DDS's C rule, which differ;
- FTEX of both formats; GBR versions 1 and 2 at depths 1 and 4;
- the forms PIL refuses, and files cut short, raise naming the file.
"""

import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from _texture_writer import (
    BC6H_MODES,
    bc6h_mode,
    bc7_mode,
    bc_encode,
    blp1_bytes,
    blp2_bytes,
    dds_bytes,
    ftex_bytes,
    gbr_bytes,
    random_blocks,
)
from empanada_tpu.cli import _load_array as jax_load
from empanada_tpu.data.datasets import _imread_gray as jax_gray
from empanada_tpu_torch.core import native
from empanada_tpu_torch.data import raster
from empanada_tpu_torch.data.imread import imread, imread_gray


def _oracle(read, path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return read(path)
        except Exception:  # PIL's OSError, NotImplementedError, ValueError...
            return None


def _check(tmp_path, name, data, raises=False):
    """Both readers on ``data`` written to ``name``: the JAX readers' array,
    or both raising (naming the file) where they raise.  ``raises`` says
    which the test expects of the oracle.  Returns what ``imread`` read."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    out = []
    for read, oracle in ((imread, jax_load), (imread_gray, jax_gray)):
        want = _oracle(oracle, path)
        assert (want is None) == raises, (read.__name__, name)
        if want is None:
            with pytest.raises(ValueError, match=name):
                read(path)
            out.append(None)
            continue
        got = read(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                      want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)
        out.append(got)
    return out[0]


def _pil_bytes(arr, mode, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


# ----- DDS ---------------------------------------------------------------------


@pytest.mark.parametrize("mode,pixel_format", [
    ("RGBA", "DXT1"), ("RGB", "DXT1"), ("RGBA", "DXT3"), ("RGBA", "DXT5"), ("RGB", "DXT5"),
    ("RGBA", "BC2"), ("RGBA", "BC3"), ("RGB", "BC5"), ("L", None), ("LA", None), ("RGB", None),
    ("RGBA", None)])
@pytest.mark.parametrize("shape", [(8, 12), (7, 10), (1, 1)])
def test_dds_pil_writes(mode, pixel_format, shape, tmp_path):
    rng = np.random.default_rng(hash((mode, pixel_format, shape)) % 2**32)
    arr = rng.integers(0, 256, shape + (len(mode),)).astype(np.uint8)
    arr = arr[..., 0] if mode == "L" else arr
    kw = {"pixel_format": pixel_format} if pixel_format else {}
    _check(tmp_path, f"{mode}_{pixel_format}.dds", _pil_bytes(arr, mode, "DDS", **kw))


# (BCn, signed, DXGI format) of each DX10 form PIL reads, and FOURCC forms
DX10 = [(1, False, 70), (1, False, 71), (2, False, 73), (2, False, 74), (3, False, 76),
        (3, False, 77), (4, False, 79), (4, False, 80), (5, False, 82), (5, False, 83),
        (5, True, 84), (6, False, 95), (6, True, 96), (7, False, 97), (7, False, 98),
        (7, False, 99)]
FOURCC = [(1, b"DXT1"), (2, b"DXT3"), (3, b"DXT5"), (4, b"BC4U"), (4, b"ATI1"), (5, b"BC5U"),
          (5, b"ATI2"), (5, b"BC5S")]


@pytest.mark.parametrize("fmt,signed,dxgi", DX10, ids=[f"dxgi{d}" for *_, d in DX10])
@pytest.mark.parametrize("w,h", [(24, 28), (13, 17)])
def test_dds_dx10_random_blocks(fmt, signed, dxgi, w, h, tmp_path):
    n = -(-w // 4) * -(-h // 4)
    blocks = random_blocks(fmt, n, dxgi + w)
    if fmt == 6:  # every mode of the 14, and the 4 reserved
        assert {bc6h_mode(b) for b in blocks} == set(BC6H_MODES)
    if fmt == 7:  # modes 0-7 and the reserved 8
        assert {bc7_mode(b) for b in blocks} == set(range(9))
    _check(tmp_path, f"bc{fmt}_{dxgi}.dds", dds_bytes(w, h, blocks.tobytes(), dxgi=dxgi))


def _with_bits(blocks, at, n, values):
    """``blocks`` with bits ``at``..``at + n`` of block k set to values[k]."""
    out = []
    for block, v in zip(blocks, values):
        x = int.from_bytes(block.tobytes(), "little")
        x = (x & ~(((1 << n) - 1) << at)) | (v << at)
        out.append(x.to_bytes(16, "little"))
    return b"".join(out)


# (format, mode bits, their count, partition bits, DXGI format): BC7 modes
# 0 (three regions, 16 partitions), 1 and 7 (two regions) and 2 (three
# regions), BC6H modes 1 and 3 (two regions, 32 partitions), signed and not
PARTITIONED = [(7, 0b1, 1, 4, 98), (7, 0b10, 2, 6, 98), (7, 0b100, 3, 6, 98),
               (7, 0b10000000, 8, 6, 98), (6, 0b00, 2, 5, 95), (6, 0b00010, 5, 5, 96)]


@pytest.mark.parametrize("fmt,mode,mode_bits,pb,dxgi", PARTITIONED,
                         ids=[f"bc{f}-mode{m:b}-{d}" for f, m, _, _, d in PARTITIONED])
def test_every_partition(fmt, mode, mode_bits, pb, dxgi, tmp_path):
    """Seeded blocks of one partitioned mode, one for each partition (and
    its anchors): every entry of the partition and anchor tables."""
    n = 1 << pb
    blocks = random_blocks(fmt, n, mode + pb)
    data = _with_bits(blocks, 0, mode_bits, [mode] * n)
    # BC6H's partition follows its 75 (modes 1 and 2) or 72 endpoint bits
    at = mode_bits + (75 if mode_bits == 2 else 72) if fmt == 6 else mode_bits
    data = _with_bits(np.frombuffer(data, np.uint8).reshape(n, 16), at, pb, list(range(n)))
    _check(tmp_path, f"partitions{fmt}_{mode}.dds", dds_bytes(4 * n, 4, data, dxgi=dxgi))


@pytest.mark.parametrize("fmt,code", FOURCC, ids=[c.decode() for _, c in FOURCC])
def test_dds_fourcc_random_blocks(fmt, code, tmp_path):
    blocks = random_blocks(fmt, 4 * 3, len(code) + fmt)
    _check(tmp_path, f"{code.decode()}.dds", dds_bytes(15, 10, blocks.tobytes(), fourcc=code))


@pytest.mark.parametrize("fmt,dxgi", [(1, 71), (3, 77), (4, 80), (7, 98)])
def test_dds_mipmaps_read_the_first_surface(fmt, dxgi, tmp_path):
    """A mipmapped file (and one with more surfaces than it says) reads
    its first surface alone."""
    w, h, body = 32, 20, b""
    for level in range(4):
        lw, lh = max(1, w >> level), max(1, h >> level)
        body += random_blocks(fmt, -(-lw // 4) * -(-lh // 4), level + fmt).tobytes()
    got = _check(tmp_path, f"mips{fmt}.dds", dds_bytes(w, h, body, dxgi=dxgi, mipmaps=4))
    assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("bitcount,masks,alpha", [
    (16, (0xF800, 0x7E0, 0x1F, 0), False), (16, (0x7C00, 0x3E0, 0x1F, 0x8000), True),
    (16, (0xF00, 0xF0, 0xF, 0xF000), True), (24, (0xFF0000, 0xFF00, 0xFF, 0), False),
    (32, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000), True), (32, (0xFF, 0xFF00, 0, 0), False),
    (8, (0xE0, 0x1C, 0x3, 0), False), (40, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), True),
    (0xFFFFFFF8, (0xFF, 0xFF00, 0xFF0000, 0), False), (4099, (0xF, 0xF00, 0xF0000, 0), False)])
def test_dds_rgb_masks(bitcount, masks, alpha, tmp_path):
    """``DdsRgbDecoder``: each mask's bits scaled to 8 bits, any bit count
    (one of 512 MiB a pixel on a file of a few hundred bytes too)."""
    w, h = 7, 5
    body = np.random.default_rng(bitcount).integers(0, 256, min(w * h * bitcount // 8, 1200),
                                                    np.uint8)
    data = dds_bytes(w, h, body.tobytes(), flags=0x40 | alpha, fourcc=None, bitcount=bitcount,
                     masks=masks)
    _check(tmp_path, f"rgb{bitcount}.dds", data)
    _check(tmp_path, f"rgb{bitcount}_cut.dds", data[:-7])  # PIL reads zeros past the end


def test_dds_palette_and_r8g8b8a8(tmp_path):
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 256, (6, 9), np.uint8)
    _check(tmp_path, "p.dds", dds_bytes(9, 6, bytes(rng.integers(0, 256, 1024, np.uint8))
                                        + idx.tobytes(), flags=0x20, fourcc=None, bitcount=8))
    for dxgi in (27, 28, 29):
        _check(tmp_path, f"rgba{dxgi}.dds",
               dds_bytes(9, 6, rng.integers(0, 256, 216, np.uint8).tobytes(), dxgi=dxgi))


REFUSED_DDS = {
    "header_size": lambda: dds_bytes(8, 8, bytes(64), fourcc=b"DXT1", header_size=100),
    "dxgi_bc1_srgb": lambda: dds_bytes(8, 8, bytes(64), dxgi=72),
    "dxgi_bc4_snorm": lambda: dds_bytes(8, 8, bytes(64), dxgi=81),
    "dxgi_float": lambda: dds_bytes(8, 8, bytes(1024), dxgi=2),
    "fourcc_bc4s": lambda: dds_bytes(8, 8, bytes(64), fourcc=b"BC4S"),
    "fourcc_unknown": lambda: dds_bytes(8, 8, bytes(64), fourcc=b"ABCD"),
    "luminance_16": lambda: dds_bytes(8, 8, bytes(128), flags=0x20000, fourcc=None,
                                      bitcount=16),
    "no_flags": lambda: dds_bytes(8, 8, bytes(128), flags=0, fourcc=None),
    "bc1_cut": lambda: dds_bytes(8, 8, bytes(31), fourcc=b"DXT1"),
    "bc7_cut": lambda: dds_bytes(8, 8, bytes(63), dxgi=98),
    "l8_cut": lambda: dds_bytes(8, 8, bytes(63), flags=0x20000, fourcc=None, bitcount=8),
    "header_cut": lambda: dds_bytes(8, 8, b"", fourcc=b"DXT1")[:100],
    "dx10_cut": lambda: dds_bytes(8, 8, b"", fourcc=b"DX10")[:140],
    "width_0": lambda: dds_bytes(0, 8, bytes(64), fourcc=b"DXT1"),
}


@pytest.mark.parametrize("kind", list(REFUSED_DDS))
def test_dds_refusals(kind, tmp_path):
    _check(tmp_path, f"{kind}.dds", REFUSED_DDS[kind](), raises=True)


# ----- BLP ---------------------------------------------------------------------


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("palette_mode", ["RGB", "RGBA"])
def test_blp_pil_writes(version, palette_mode, tmp_path):
    rng = np.random.default_rng(len(palette_mode) + len(version))
    im = Image.fromarray(rng.integers(0, 256, (9, 13), np.uint8), "P")
    im.putpalette(rng.integers(0, 256, 256 * len(palette_mode), np.uint8).tobytes(),
                  palette_mode)
    buf = io.BytesIO()
    im.save(buf, "BLP", blp_version=version)
    _check(tmp_path, f"{version}_{palette_mode}.blp", buf.getvalue())


@pytest.mark.parametrize("alpha_encoding", [0, 1, 7])
@pytest.mark.parametrize("alpha", [0, 8])
@pytest.mark.parametrize("w,h", [(16, 8), (13, 6)])
def test_blp2_dxt(alpha_encoding, alpha, w, h, tmp_path):
    fmt = {0: 1, 1: 2, 7: 3}[alpha_encoding]
    blocks = random_blocks(fmt, -(-w // 4) * -(-h // 4), alpha_encoding + w)
    _check(tmp_path, f"dxt{fmt}_{alpha}.blp",
           blp2_bytes(w, h, [blocks.tobytes()], alpha=alpha, alpha_encoding=alpha_encoding))


def test_dxt_rules_differ_and_each_matches_its_oracle(tmp_path):
    """The same 8 x 8 blocks of 32 x 32 pixels under BLP2's Python rule
    and DDS's C rule: 5-6-5 colours widened differently, up to 7 levels
    apart; each file reads as its own oracle reads it."""
    for fmt, (alpha_encoding, code) in {1: (0, b"DXT1"), 2: (1, b"DXT3"),
                                        3: (7, b"DXT5")}.items():
        blocks = random_blocks(fmt, 64, fmt).tobytes()
        blp = _check(tmp_path, f"rule{fmt}.blp",
                     blp2_bytes(32, 32, [blocks], alpha=8, alpha_encoding=alpha_encoding))
        dds = _check(tmp_path, f"rule{fmt}.dds", dds_bytes(32, 32, blocks, fourcc=code))
        diff = np.abs(blp[..., :3].astype(int) - dds[..., :3].astype(int))
        assert 0 < diff.max() <= 7 and (diff.max(-1) > 0).mean() > 0.5
        np.testing.assert_array_equal(blp[..., 3], dds[..., 3])  # alpha follows one rule
        np.testing.assert_array_equal(
            native.bcn_decode(blocks, fmt, 32, 32, rule="blp"), blp)


def _jpeg_split(jpeg):
    """A BLP1's JPEG: the shared header up to the first scan, the mip's data
    after it."""
    sos = jpeg.index(b"\xff\xda")
    return jpeg[:sos], jpeg[sos:]


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK", "YCCK"])
@pytest.mark.parametrize("alpha", [0, 1])
def test_blp1_jpeg(mode, alpha, tmp_path):
    """Grey, colour and CMYK JPEGs; a YCCK one (its Adobe transform set to
    2) reads its planes as stored, the CMYK source PIL's BLP plugin sets."""
    rng = np.random.default_rng(len(mode) + alpha)
    arr = rng.integers(0, 256, (20, 24, 3 if mode == "RGB" else 4), np.uint8)
    jpeg = _pil_bytes(arr[..., 0] if mode == "L" else arr, "CMYK" if mode == "YCCK" else mode,
                      "JPEG", quality=90)
    if mode == "YCCK":
        at = jpeg.index(b"Adobe") + 11
        jpeg = jpeg[:at] + b"\x02" + jpeg[at + 1:]
    header, mip = _jpeg_split(jpeg)
    _check(tmp_path, f"jpeg_{mode}_{alpha}.blp",
           blp1_bytes(24, 20, [mip], compression=0, alpha=alpha, jpeg_header=header))
    # a JPEG larger than the BLP reads as the BLP's size of its bytes; a
    # smaller one raises (PIL: not enough image data)
    _check(tmp_path, f"jpeg_{mode}_small.blp",
           blp1_bytes(16, 9, [mip], compression=0, alpha=alpha, jpeg_header=header))
    _check(tmp_path, f"jpeg_{mode}_large.blp",
           blp1_bytes(30, 20, [mip], compression=0, alpha=alpha, jpeg_header=header),
           raises=True)


REFUSED_BLP = {
    "blp2_encoding3": lambda: blp2_bytes(8, 8, [bytes(256)], encoding=3),
    "blp2_alpha_encoding": lambda: blp2_bytes(8, 8, [bytes(64)], alpha_encoding=8),
    "blp2_jpeg": lambda: blp2_bytes(8, 8, [bytes(64)], compression=0),
    "blp2_dxt_cut": lambda: blp2_bytes(8, 8, [bytes(20)]),
    "blp2_palette_cut": lambda: blp2_bytes(8, 8, [bytes(64)], encoding=1)[:1000],
    "blp2_indices_short": lambda: blp2_bytes(8, 8, [bytes(60)], encoding=1),
    "blp1_encoding": lambda: blp1_bytes(8, 8, [bytes(64)], encoding=3),
    "blp1_compression": lambda: blp1_bytes(8, 8, [bytes(64)], compression=2),
    "blp1_cut": lambda: blp1_bytes(8, 8, [bytes(64)])[:1200],
    "blp1_header_cut": lambda: b"BLP1" + bytes(20),
}


@pytest.mark.parametrize("kind", list(REFUSED_BLP))
def test_blp_refusals(kind, tmp_path):
    _check(tmp_path, f"{kind}.blp", REFUSED_BLP[kind](), raises=True)


# ----- FTEX and GBR ------------------------------------------------------------


@pytest.mark.parametrize("w,h", [(16, 12), (10, 7)])
def test_ftex(w, h, tmp_path):
    rng = np.random.default_rng(w)
    blocks = random_blocks(1, -(-w // 4) * -(-h // 4), h).tobytes()
    _check(tmp_path, "dxt1.ftc", ftex_bytes(w, h, 0, blocks))
    raw = rng.integers(0, 256, w * h * 3, np.uint8).tobytes()
    _check(tmp_path, "rgb.ftu", ftex_bytes(w, h, 1, raw))
    _check(tmp_path, "rgb_rest.ftu", ftex_bytes(w, h, 1, raw, size=-1))  # reads to the end
    for name, data in {"formats2.ftc": ftex_bytes(w, h, 0, blocks, formats=2),
                       "format2.ftc": ftex_bytes(w, h, 2, blocks),
                       "cut.ftc": ftex_bytes(w, h, 0, blocks[:-1]),
                       "cut.ftu": ftex_bytes(w, h, 1, raw, size=len(raw) - 1)}.items():
        _check(tmp_path, name, data, raises=True)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("depth", [1, 4])
def test_gbr(version, depth, tmp_path):
    rng = np.random.default_rng(version * depth)
    img = rng.integers(0, 256, (9, 11) if depth == 1 else (9, 11, 4), np.uint8)
    data = gbr_bytes(img, version)
    _check(tmp_path, "brush.gbr", data)
    _check(tmp_path, "cut.gbr", data[:-1], raises=True)
    if version == 2:
        _check(tmp_path, "magic.gbr", gbr_bytes(img, 2, magic=b"GIMQ"), raises=True)
        _check(tmp_path, "short.gbr", gbr_bytes(img, 2, comment=b"")[:-4], raises=True)
    bad = bytearray(data)
    bad[19] = 3  # colour depth 3
    _check(tmp_path, "depth3.gbr", bytes(bad), raises=True)


def test_formats_route_to_textures(tmp_path):
    """``raster.identify`` finds each format by PIL's order."""
    files = {"DDS": dds_bytes(4, 4, bytes(8), fourcc=b"DXT1"),
             "BLP": blp2_bytes(4, 4, [bytes(8)]),
             "FTEX": ftex_bytes(4, 4, 0, bytes(8)),
             "GBR": gbr_bytes(np.zeros((2, 2), np.uint8))}
    for name, data in files.items():
        assert raster.identify(data) == name
        path = tmp_path / name
        path.write_bytes(data)
        assert imread(str(path)).shape[:2] == imread_gray(str(path)).shape


def test_bc_encoder_round_trips(tmp_path):
    """``_texture_writer``'s BC1-BC5 encoder (phase 24's files): a flat
    block decodes to its value, and a grey slice's BC4 stays within the
    levels of its block's range."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (13, 18), np.uint8)
    got = native.bcn_decode(bc_encode(img, 4), 4, 18, 13)[..., 0]
    assert np.abs(got.astype(int) - img).max() <= 255 // 14 + 1
    flat = np.full((8, 8, 3), 77, np.uint8)
    for fmt in (1, 2, 3):
        out = native.bcn_decode(bc_encode(flat, fmt), fmt, 8, 8)
        assert np.abs(out[..., :3].astype(int) - 77).max() <= 4 and (out[..., 3] == 255).all()
