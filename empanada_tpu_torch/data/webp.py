"""WebP, read as the JAX package's two readers read it: PIL (``Image.open``,
frames stacked) and cv2 (``cv2.imread(IMREAD_UNCHANGED)``), both through
libwebp.  The bitstreams (VP8L, VP8 key frames, the ALPH chunk) are decoded
by the port's host library (``csrc/webp_decode.cpp``); the container and the
rules of each reader are here, after libwebp's ``src/dec/webp_dec.c``
(``WebPGetFeatures``, ``WebPDecode``), ``src/demux/demux.c`` (``WebPDemux``)
and ``src/demux/anim_decode.c`` (``WebPAnimDecoder``).

``imread`` is PIL's array.  PIL opens every file through the animation
decoder: the demuxer checks the whole file (the RIFF size, every chunk's
size, the VP8X flags and canvas, ANIM before ANMF, each frame inside the
canvas, a still image as large as its canvas), and each frame is composed
onto a canvas that starts transparent black: a frame is a key frame (the
canvas cleared) when it is the first, when it covers the canvas and has no
alpha or does not blend, or when the frame before it was disposed and
covered the canvas or was itself a key frame; else it starts from the
canvas before it, with that frame's rectangle cleared to transparent if it
was disposed, and its pixels of alpha below 255 are blended over that
canvas (libwebp's non-premultiplied ``BlendPixelNonPremult``), except
inside a rectangle just cleared.  The ANIM background colour is ignored, as
libwebp ignores it.  PIL's mode is RGBA where ``WebPGetFeatures`` of the
whole file reports alpha (an animation's VP8X alpha flag; a still image's
VP8X flag or ALPH chunk, or a VP8L image's alpha hint), else RGB; a file of
more than one frame is stacked (N, H, W, C).  A still VP8X image whose flag
lacks alpha has its ALPH chunk dropped (alpha 255).

``imread_gray`` is cv2's channel 0, blue.  cv2 takes a file of 32 bytes
or more whose first 32 bytes pass ``WebPGetFeatures``; an animation (the
VP8X flag) it reads through the animation decoder, frame 0 alone; a still
image through ``WebPDecode``, which checks less than the demuxer (it
ignores VP8X's reserved flag bits, takes the last ALPH chunk before the
image and ignores an ALPH before VP8L) but wants a VP8X chunk of 10 bytes.
Where cv2 reads nothing it is PIL's frame 0, channel 0 (red).

Refused, naming the form: VP8 frames of the simple loop filter, of
loop-filter sharpness or deltas, or of more than one token partition
(``csrc/webp_decode.cpp``); and what libwebp refuses: inter frames,
profiles above 3, damaged bitstreams.  Every buffer is sized from headers
that the data must back (a VP8 frame's first partition must be able to
hold its macroblocks; a VP8L stream's transforms and prefix codes are read
first), and each frame's headers are read before its canvas is allocated;
an animation canvas over 2^28 pixels (the largest frame's), which libwebp
would allocate, is refused.
"""

from __future__ import annotations

import struct

import numpy as np

from empanada_tpu_torch.core import native
from empanada_tpu_torch.data.imread import _READS, _Raw

__all__ = ["read"]

_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1  # libwebp's MAX_CHUNK_PAYLOAD
_MAX_AREA = 1 << 32  # MAX_IMAGE_AREA
_MAX_CANVAS = 1 << 28  # the port's: a VP8 or VP8L frame's largest, 16384 x 16384
_ALPHA, _ANIM = 0x10, 0x02
_VALID_FLAGS = 0x10 | 0x02 | 0x20 | 0x08 | 0x04  # alpha, animation, ICCP, EXIF, XMP
_HEADER = 32  # the bytes cv2 sniffs (its WEBP_HEADER_SIZE)


def _u32(d: bytes, at: int) -> int:
    return struct.unpack_from("<I", d, at)[0]


def _u24(d: bytes, at: int) -> int:
    return d[at] | d[at + 1] << 8 | d[at + 2] << 16


# ----- WebPGetFeatures / WebPDecode's header parse (webp_dec.c) ---------------


def _bitstream_info(tag: bytes, payload: bytes, chunk_size: int) -> tuple:
    """VP8GetInfo / VP8LGetInfo: (width, height, alpha hint) of a bitstream
    from its first bytes."""
    if tag == b"VP8L":
        if len(payload) < 5:
            raise ValueError("a VP8L chunk too short for its header")
        if payload[0] != 0x2F or payload[4] >> 5:
            raise ValueError("a VP8L chunk without its signature and version 0")
        bits = _u32(payload, 1)
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1
    if len(payload) < 10:
        raise ValueError("a VP8 chunk too short for its frame header")
    tag3 = payload[0] | payload[1] << 8 | payload[2] << 16
    if tag3 & 1:
        raise ValueError("a VP8 inter frame, which WebP does not hold")
    if (tag3 >> 1) & 7 > 3:
        raise ValueError(f"a VP8 frame of profile {(tag3 >> 1) & 7} (above 3)")
    if payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a VP8 key frame without its start code")
    if not (tag3 >> 4) & 1 or tag3 >> 5 >= chunk_size:
        raise ValueError("a VP8 frame not shown or of a first partition longer than its chunk")
    w, h = _u32(payload, 6) & 0x3FFF, (_u32(payload, 6) >> 16) & 0x3FFF
    if not w or not h:
        raise ValueError("a VP8 frame of width or height 0")
    return w, h, 0


def _features(data: bytes, have_all: bool = False) -> dict:
    """libwebp's ``ParseHeadersInternal`` of a file's first bytes: its
    ``width``, ``height``, ``alpha`` and ``animation``, and (unless an
    animation) the ``tag``, ``offset`` and ``size`` of its image chunk and
    the ``alph`` payload before it.  ``have_all`` as ``WebPDecode`` (the
    file whole: truncation raises); without it as ``WebPGetFeatures``."""
    if len(data) < 12:
        raise ValueError("shorter than a RIFF header")
    pos, riff = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise ValueError("a RIFF file that is not WEBP")
        riff = _u32(data, 4)
        if riff < 12 or riff > _MAX_PAYLOAD:
            raise ValueError(f"a RIFF size of {riff}")
        if have_all and riff > len(data) - 8:
            raise ValueError(f"its RIFF size ({riff}) runs past the file's end: the file is cut")
        pos = 12
    if len(data) - pos < 8:
        raise ValueError("cut before its first chunk")
    out = {"alpha": 0, "animation": 0, "alph": None}
    vp8x = data[pos:pos + 4] == b"VP8X"
    if vp8x:
        if _u32(data, pos + 4) != 10:
            raise ValueError("a VP8X chunk of other than 10 bytes")
        if len(data) - pos < 18:
            raise ValueError("cut inside its VP8X chunk")
        flags = _u32(data, pos + 8)
        w, h = _u24(data, pos + 12) + 1, _u24(data, pos + 15) + 1
        if w * h >= _MAX_AREA:
            raise ValueError(f"a canvas of {w} x {h}")
        if not riff:
            raise ValueError("a VP8X chunk outside a RIFF container")
        out.update(width=w, height=h, alpha=int(bool(flags & _ALPHA)),
                   animation=int(bool(flags & _ANIM)))
        pos += 18
        if out["animation"] and not have_all:
            return out
    if len(data) - pos < 4:
        if vp8x and not have_all:
            return out
        raise ValueError("cut before its image chunk")
    if vp8x:  # ParseOptionalChunks: skipped up to the image; the last ALPH counts
        total = 4 + 8 + 10
        while True:
            if len(data) - pos < 8:
                if not have_all:
                    return out
                raise ValueError("cut before its image chunk")
            size = _u32(data, pos + 4)
            if size > _MAX_PAYLOAD:
                raise ValueError(f"a chunk of {size} bytes")
            disk = (8 + size + 1) & ~1
            total += disk
            if riff and total > riff:
                raise ValueError("a chunk past its RIFF size")
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if len(data) - pos < disk:
                if not have_all:
                    return out
                raise ValueError("cut inside a chunk")
            if data[pos:pos + 4] == b"ALPH":
                out["alph"] = data[pos + 8:pos + 8 + size]
            pos += disk
    tag = data[pos:pos + 4]
    if tag not in (b"VP8 ", b"VP8L"):
        raise ValueError(f"a first chunk {tag!r} that is not VP8, VP8L or VP8X")
    size = _u32(data, pos + 4)
    if riff >= 12 and size > riff - 12:
        raise ValueError("an image chunk past its RIFF size")
    if have_all and size > len(data) - pos - 8:
        raise ValueError("its image chunk runs past the file's end: the file is cut")
    if size > _MAX_PAYLOAD:
        raise ValueError(f"an image chunk of {size} bytes")
    payload = data[pos + 8:pos + 8 + size]
    iw, ih, hint = _bitstream_info(tag, payload, size)
    if tag == b"VP8L":
        out["alpha"] = hint
    if vp8x and (iw, ih) != (out["width"], out["height"]):
        raise ValueError(f"an image of {iw} x {ih} on a canvas of {out['width']} x "
                         f"{out['height']}")
    out["alpha"] |= out["alph"] is not None
    out.update(width=iw, height=ih, tag=tag, offset=pos + 8, size=size)
    return out


# ----- WebPDemux (demux.c) ------------------------------------------------------


class _Frame:
    """One frame: its place on the canvas, its dispose and blend bits, its
    ALPH and image payloads."""

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.dispose = self.blend = False
        self.alph = self.image = self.tag = None
        self.alph_at = self.image_at = -1
        self.has_alpha = False
        self.complete = False


class _Mem:
    def __init__(self, data: bytes, end: int):
        self.data, self.end, self.pos = data, end, 0

    def chunk(self) -> tuple:
        """(tag, size, payload start, end of the padded chunk), checked
        against the RIFF's end."""
        if self.end - self.pos < 8:
            raise ValueError("cut inside a chunk header")
        tag, size = self.data[self.pos:self.pos + 4], _u32(self.data, self.pos + 4)
        padded = size + (size & 1)
        if size > _MAX_PAYLOAD or padded > self.end - self.pos - 8:
            raise ValueError(f"a {tag!r} chunk of {size} bytes past the RIFF's end: the file is "
                             f"cut or its sizes damaged")
        return tag, size, self.pos + 8, self.pos + 8 + padded


def _store_frame(mem: _Mem, frame: _Frame, min_size: int) -> None:
    """StoreFrame: an ALPH chunk and a VP8/VP8L chunk, up to the first
    chunk that is neither (or a second of either)."""
    if mem.end - mem.pos < max(8, min_size):
        raise ValueError("cut inside a frame")
    while True:
        tag, size, start, nxt = mem.chunk()
        payload = mem.data[start:start + size]
        if tag == b"ALPH" and frame.alph is None:
            frame.alph, frame.alph_at, frame.has_alpha = payload, mem.pos, True
        elif tag in (b"VP8 ", b"VP8L") and frame.image is None:
            if tag == b"VP8L" and frame.alph is not None:
                raise ValueError("an ALPH chunk before a VP8L image")
            frame.width, frame.height, hint = _bitstream_info(tag, payload, size)
            frame.image, frame.tag, frame.image_at = payload, tag, mem.pos
            frame.has_alpha |= bool(hint)
            frame.complete = True
        else:
            return
        mem.pos = nxt
        if mem.pos == mem.end:
            return


def _demux(data: bytes) -> tuple:
    """libwebp's WebPDemux of the whole file: ((canvas width, height),
    frames)."""
    if len(data) < 20:
        raise ValueError("shorter than a RIFF header and a chunk")
    riff = _u32(data, 4)
    if riff < 8 or riff > _MAX_PAYLOAD:
        raise ValueError(f"a RIFF size of {riff}")
    if len(data) < riff + 8:
        raise ValueError(f"its RIFF size ({riff}) runs past the file's end: the file is cut")
    mem = _Mem(data, riff + 8)
    mem.pos = 12
    frames = []
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):
        frame = _single(mem, frames, 0)
        return (frame.width, frame.height), frames
    if first != b"VP8X":
        raise ValueError(f"a first chunk {first!r} that is not VP8, VP8L or VP8X")
    size = _u32(data, 16)
    if size > _MAX_PAYLOAD or size < 10 or size + (size & 1) > mem.end - 20:
        raise ValueError(f"a VP8X chunk of {size} bytes")
    flags = data[20]
    canvas = (_u24(data, 24) + 1, _u24(data, 27) + 1)
    if canvas[0] * canvas[1] >= _MAX_AREA:
        raise ValueError(f"a canvas of {canvas[0]} x {canvas[1]}")
    animated = bool(flags & _ANIM)
    if animated and canvas[0] * canvas[1] > _MAX_CANVAS:
        raise ValueError(f"an animation canvas of {canvas[0]} x {canvas[1]}, over the "
                         f"{_MAX_CANVAS} pixels the port allocates")
    mem.pos = 20 + size + (size & 1)
    anim_seen = False
    while mem.pos != mem.end:
        tag, size, start, nxt = mem.chunk()
        if tag == b"VP8X":
            raise ValueError("a second VP8X chunk")
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim_seen or animated:
                raise ValueError("an image outside an ANMF chunk of an animation")
            _single(mem, frames, flags)
        elif tag == b"ANIM" and not anim_seen:
            if nxt - start < 6:
                raise ValueError("an ANIM chunk of fewer than 6 bytes")
            anim_seen = True
            mem.pos = nxt
        elif tag == b"ANMF":
            if not anim_seen:
                raise ValueError("an ANMF chunk before the ANIM chunk")
            if nxt - start < 16:
                raise ValueError("an ANMF chunk of fewer than 16 bytes")
            frame = _Frame()
            frame.x, frame.y = 2 * _u24(data, start), 2 * _u24(data, start + 3)
            w, h = _u24(data, start + 6) + 1, _u24(data, start + 9) + 1
            frame.dispose, frame.blend = bool(data[start + 15] & 1), not data[start + 15] & 2
            if w * h >= _MAX_AREA:
                raise ValueError(f"an ANMF frame of {w} x {h}")
            mem.pos = start + 16
            _store_frame(mem, frame, nxt - start - 16)
            if mem.pos - (start + 16) > nxt - start - 16:
                raise ValueError("an ANMF chunk shorter than the chunks it holds")
            if animated and (frame.image is not None or frame.alph is not None):
                _add(frames, frame)
        else:  # ICCP, EXIF, XMP, a second ANIM and unknown chunks: skipped
            mem.pos = nxt
        if mem.pos != mem.end and mem.end - mem.pos < 8:
            raise ValueError("cut inside a chunk header")
    _check_extended(canvas, flags, frames, animated)
    return canvas, frames


def _add(frames: list, frame: _Frame) -> None:
    if frames and not frames[-1].complete:
        raise ValueError("a frame after one without its image chunk")
    frames.append(frame)


def _single(mem: _Mem, frames: list, flags: int) -> _Frame:
    """ParseSingleImage: the image of a still file (its ALPH dropped where
    a VP8X lacks the alpha flag)."""
    if frames:
        raise ValueError("a second image in a still file")
    frame = _Frame()
    _store_frame(mem, frame, 0)
    if not flags & _ALPHA and frame.alph is not None:
        frame.alph, frame.alph_at, frame.has_alpha = None, -1, False
    if frame.image is None and frame.alph is None:
        raise ValueError("no image chunk")
    _add(frames, frame)
    if not frame.complete:
        raise ValueError("an ALPH chunk without its image chunk")
    return frame


def _check_extended(canvas, flags: int, frames: list, animated: bool) -> None:
    """IsValidExtendedFormat."""
    if not frames:
        raise ValueError("no frame")
    if flags & ~_VALID_FLAGS:
        raise ValueError(f"VP8X flags {flags:#04x} with reserved bits set")
    for f in frames:
        if not f.complete:
            raise ValueError("a frame without its image chunk")
        if f.alph is not None and f.alph_at > f.image_at:
            raise ValueError("an ALPH chunk after its image chunk")
        if animated:
            inside = f.x + f.width <= canvas[0] and f.y + f.height <= canvas[1]
        else:
            inside = (f.x, f.y, f.width, f.height) == (0, 0) + canvas
        if not inside:
            raise ValueError(f"a frame of {f.width} x {f.height} at ({f.x}, {f.y}) outside its "
                             f"canvas of {canvas[0]} x {canvas[1]}")


# ----- decoding and composing -------------------------------------------------


def _decode(tag: bytes, image: bytes, alph) -> np.ndarray:
    """(H, W, 4) RGBA of one image chunk and its ALPH (VP8 only)."""
    px = native.webp_decode(tag.decode("latin-1"), image)
    if alph is not None and tag == b"VP8 ":
        px[..., 3] = native.webp_alpha(alph, px.shape[1], px.shape[0])
    return px


def _blend(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """anim_decode.c's BlendPixelRowNonPremult: ``src`` over ``dst`` where
    its alpha is below 255 (none at 0 keeps ``dst``)."""
    sa = src[..., 3:].astype(np.uint32)
    dst_a = (dst[..., 3:].astype(np.uint32) * (256 - sa)) >> 8
    blend_a = sa + dst_a
    scale = (1 << 24) // np.maximum(blend_a, 1)
    rgb = ((src[..., :3] * sa + dst[..., :3] * dst_a) * scale.astype(np.uint64)) >> 24
    out = np.concatenate([rgb.astype(np.uint8), blend_a.astype(np.uint8)], -1)
    out = np.where(sa == 0, dst, out)
    return np.where(sa == 255, src, out)


def _compose(canvas, frames: list, count=None) -> list:
    """WebPAnimDecoderGetNext for the first ``count`` frames (all by
    default): their RGBA canvases."""
    cw, ch = canvas
    for f in frames[:count]:  # every frame's headers before any canvas
        native.webp_info(f.tag.decode("latin-1"), f.image)
    out, prev, prev_key, disposed = [], None, False, None
    for k, f in enumerate(frames[:count], 1):
        full = (f.width, f.height) == (cw, ch)
        if k == 1 or ((not f.has_alpha or not f.blend) and full):
            key = True
        else:
            key = prev.dispose and ((prev.width, prev.height) == (cw, ch) or prev_key)
        cur = np.zeros((ch, cw, 4), np.uint8) if key else disposed.copy()
        px = _decode(f.tag, f.image, f.alph)
        rect = (slice(f.y, f.y + f.height), slice(f.x, f.x + f.width))
        cur[rect] = px
        if k > 1 and f.blend and not key:
            blended = _blend(px, disposed[rect])
            if prev.dispose:  # the rectangle just cleared keeps the frame's pixels
                ys = np.arange(f.y, f.y + f.height)[:, None]
                xs = np.arange(f.x, f.x + f.width)[None, :]
                inside = ((ys >= prev.y) & (ys < prev.y + prev.height)
                          & (xs >= prev.x) & (xs < prev.x + prev.width))[..., None]
                blended = np.where(inside, px, blended)
            cur[rect] = blended
        out.append(cur)
        disposed = cur.copy()
        if f.dispose:
            disposed[rect] = 0
        prev, prev_key = f, key
    return out


def _pil(data: bytes, count=None) -> list:
    """PIL's frames (the first ``count``, or all): RGBA, or RGB where
    WebPGetFeatures reports no alpha."""
    canvas, frames = _demux(data)
    try:
        rgb = not _features(data)["alpha"]
    except ValueError:  # PIL's mode where the sniff fails
        rgb = False
    return [c[..., :3] if rgb else c for c in _compose(canvas, frames, count)]


def _cv2_blue(data: bytes) -> np.ndarray:
    """cv2's channel 0 (blue): frame 0 of an animation, or WebPDecode's
    image."""
    if len(data) < _HEADER:
        raise ValueError(f"{len(data)} bytes, fewer than cv2's {_HEADER}-byte WebP header")
    if _features(data[:_HEADER])["animation"]:
        canvas, frames = _demux(data)
        return _compose(canvas, frames, 1)[0][..., 2]
    head = _features(data, have_all=True)
    image = data[head["offset"]:head["offset"] + head["size"]]
    return _decode(head["tag"], image, head["alph"])[..., 2]


def read(data: bytes, name: str, first_only: bool = False) -> list:
    """The images of the WebP file ``name`` (its bytes ``data``) as
    ``_Raw``: PIL's frames, or frame 0 alone with cv2's channel 0."""
    where = f"{name}: WebP"

    def refused(exc):
        return ValueError(f"{where}: {exc}; {_READS}")

    def pil_frames(count=None):
        try:
            return _pil(data, count)
        except ValueError as exc:
            raise refused(exc) from None

    if not first_only:
        return [_Raw(None, "rgba", 8, f"{where} frame {k}", pil=lambda c=c: c)
                for k, c in enumerate(pil_frames())]
    try:
        blue = _cv2_blue(data)
    except ValueError:
        blue = None
    return [_Raw(None, "rgba", 8, where, cv2_reads=blue is not None,
                 pil=lambda: pil_frames(1)[0], gray=lambda: blue)]
