"""Container rewriting for the WebP tests (no encoder of pixels): split a
file that PIL or cv2 wrote into its chunks and put chunks together again
(RIFF, VP8X, ANIM, ANMF, raw ALPH with each filter, unknown chunks), and
rewrite a VP8 frame's tag (profile, inter frame) and its dimensions' scale
bits.  ``vp8_refused`` writes the first bytes of a VP8 key frame whose
header names a form the port refuses (a boolean encoder of RFC 6386 7.3
for the header's bits alone; the decoder stops there)."""

import struct

import numpy as np


def chunk(tag: bytes, payload: bytes) -> bytes:
    """One chunk, padded to an even length."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def split(data: bytes) -> list:
    """The top-level (tag, payload) chunks of a RIFF WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def riff(*chunks: bytes, size: int | None = None) -> bytes:
    """A RIFF WebP file of the chunks; ``size`` overrides the RIFF size."""
    body = b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body) + 4 if size is None else size) + b"WEBP" + body


def _u24(v: int) -> bytes:
    return int(v).to_bytes(3, "little")


def vp8x(width: int, height: int, flags: int) -> bytes:
    """A VP8X chunk: flags (0x10 alpha, 0x02 animation, 0x20 ICC, 0x08
    EXIF, 0x04 XMP) and the canvas."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _u24(width - 1) + _u24(height - 1))


def anim(bgcolor: int = 0, loops: int = 0) -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", bgcolor, loops))


def anmf(x: int, y: int, width: int, height: int, frame: bytes, duration: int = 50,
         dispose: bool = False, blend: bool = True) -> bytes:
    """An ANMF chunk holding ``frame`` (its ALPH and image chunks) at (x,
    y), both even."""
    bits = int(dispose) | (0 if blend else 2)
    return chunk(b"ANMF", _u24(x // 2) + _u24(y // 2) + _u24(width - 1) + _u24(height - 1)
                 + _u24(duration) + bytes([bits]) + frame)


def alph_raw(alpha: np.ndarray, filt: int = 0) -> bytes:
    """An ALPH payload of the (H, W) uint8 plane uncompressed, filtered
    forward by ``filt`` (0 none, 1 horizontal, 2 vertical, 3 gradient) as
    libwebp's filters do."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]  # the first row of every filter: left
        pred[1:, 0] = a[:-1, 0]
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    res = ((a - pred) & 0xFF).astype(np.uint8)
    return bytes([filt << 2]) + res.tobytes()


def vp8_tag(payload: bytes, profile: int | None = None, inter: bool = False,
            scale: tuple = (0, 0)) -> bytes:
    """A VP8 payload with its frame tag's profile or key-frame bit, and
    its dimensions' upper (scale) bits, rewritten."""
    out = bytearray(payload)
    bits = out[0] | out[1] << 8 | out[2] << 16
    if profile is not None:
        bits = (bits & ~0xE) | (profile << 1)
    if inter:
        bits |= 1
    out[0:3] = bits.to_bytes(3, "little")
    out[7] = (out[7] & 0x3F) | (scale[0] << 6)
    out[9] = (out[9] & 0x3F) | (scale[1] << 6)
    return bytes(out)


class _BoolEncoder:
    """RFC 6386 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int = 128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        for _ in range(32):
            self.put(0)
        return bytes(self.out)


def vp8_refused(simple: int = 0, level: int = 20, sharpness: int = 0, lf_delta: bool = False,
                partitions_log2: int = 0) -> bytes:
    """A 16 x 16 VP8 key frame's payload whose first partition's header (no
    segments, the filter header given, its token partitions) the decoder
    reads to its refusal; the rest is zeros."""
    enc = _BoolEncoder()
    enc.put(0)  # colour space
    enc.put(0)  # clamping type
    enc.put(0)  # no segmentation
    enc.put(simple)
    enc.value(level, 6)
    enc.value(sharpness, 3)
    enc.put(int(lf_delta))
    if lf_delta:
        enc.put(1)  # update the deltas
        for _ in range(8):
            enc.put(1)
            enc.value(2, 6)
            enc.put(0)  # positive
    enc.value(partitions_log2, 2)
    part0 = enc.flush() + bytes(64)
    tag = (len(part0) << 5) | (1 << 4)  # key frame, profile 0, shown
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", 16, 16)
            + part0 + bytes(3 * ((1 << partitions_log2) - 1)) + bytes(256))
