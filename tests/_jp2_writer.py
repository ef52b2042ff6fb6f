"""JPEG 2000 files put together, or patched, from the pieces of the ones PIL
writes, for ``tests/test_torch_jpeg2000.py``: JP2 boxes around a
codestream, the codestream's marker segments and tile-parts taken apart
and joined again (with new SOT lengths), a component's packets spliced in
from another file (the packet lengths of its PLT markers), and the forms
the port refuses (a marker, a box or a code-block style patched in)."""

import struct

SOC, SIZ, COD, SOT, SOD, EOC, PLT = 0xFF4F, 0xFF51, 0xFF52, 0xFF90, 0xFF93, 0xFFD9, 0xFF58


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2(codestream: bytes, height: int, width: int, comps: int, bpc: int, enumcs: int,
        header_extra: bytes = b"", before_codestream: bytes = b"", colr: bytes = None) -> bytes:
    """A JP2 file: signature, file type, a header of ihdr, colr (enumerated
    ``enumcs``, or the payload ``colr``) and ``header_extra``, then
    ``before_codestream`` boxes and the codestream box."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", height, width, comps, bpc, 7, 0, 0))
    colour = box(b"colr", colr if colr is not None else struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", ihdr + colour + header_extra) + before_codestream
            + box(b"jp2c", codestream))


def codestream_of(data: bytes) -> bytes:
    """The codestream of a JP2 file (or the codestream itself)."""
    at = data.find(b"jp2c\xff\x4f\xff\x51")
    return data[at + 4:] if at >= 0 else data


class Codestream:
    """A codestream taken apart: ``main`` [(marker, payload)] after SOC, and
    ``parts`` [(tile, part, parts declared, [(marker, payload)], data)]."""

    def __init__(self, data: bytes):
        data = codestream_of(data)
        assert data[:2] == b"\xff\x4f"
        pos, self.main = 2, []
        while True:
            marker, size = struct.unpack_from(">HH", data, pos)
            if marker == SOT:
                break
            self.main.append((marker, data[pos + 4:pos + 2 + size]))
            pos += 2 + size
        self.parts = []
        while struct.unpack_from(">H", data, pos)[0] == SOT:
            tile, psot, part, nparts = struct.unpack_from(">HIBB", data, pos + 4)
            end = pos + psot if psot else len(data) - 2
            at, markers = pos + 12, []
            while struct.unpack_from(">H", data, at)[0] != SOD:
                marker, size = struct.unpack_from(">HH", data, at)
                markers.append((marker, data[at + 4:at + 2 + size]))
                at += 2 + size
            self.parts.append((tile, part, nparts, markers, data[at + 2:end]))
            pos = end

    def marker(self, which: int) -> bytes:
        return next(p for m, p in self.main if m == which)

    def set_marker(self, which: int, payload: bytes) -> None:
        self.main = [(m, payload if m == which else p) for m, p in self.main]

    def insert(self, which: int, payload: bytes, after: int = SIZ) -> None:
        """A main-header marker segment, after the first of ``after``."""
        at = next(k for k, (m, _) in enumerate(self.main) if m == after)
        self.main.insert(at + 1, (which, payload))

    def build(self) -> bytes:
        out = b"\xff\x4f"
        for m, p in self.main:
            out += struct.pack(">HH", m, 2 + len(p)) + p
        for tile, part, nparts, markers, data in self.parts:
            head = b"".join(struct.pack(">HH", m, 2 + len(p)) + p for m, p in markers)
            out += struct.pack(">HHHIBB", SOT, 10, tile, 12 + len(head) + 2 + len(data), part,
                               nparts) + head + struct.pack(">H", SOD) + data
        return out + struct.pack(">H", EOC)

    def packet_lengths(self, k: int = 0) -> list:
        """The packet lengths that tile-part ``k``'s PLT markers give."""
        out, v = [], 0
        for m, p in self.parts[k][3]:
            if m == PLT:
                for byte in p[1:]:
                    v = v << 7 | (byte & 0x7F)
                    if not byte & 0x80:
                        out.append(v)
                        v = 0
        return out


def with_style(data: bytes, style: int) -> bytes:
    """The codestream with the COD marker's code-block style set."""
    cs = Codestream(data)
    cod = bytearray(cs.marker(COD))
    cod[8] = style
    cs.set_marker(COD, bytes(cod))
    return cs.build()


def with_mct(data: bytes, mct: int) -> bytes:
    cs = Codestream(data)
    cod = bytearray(cs.marker(COD))
    cod[4] = mct
    cs.set_marker(COD, bytes(cod))
    return cs.build()


def subsampled(full: bytes, half: bytes, which: set, levels: int) -> bytes:
    """A codestream whose components in ``which`` are subsampled 2 x 2: their
    packets from ``half`` (the image at half size), the others' from ``full``;
    both one-tile CPRL codestreams of one layer, default precincts,
    ``levels`` resolutions and PLT markers, so that each component's packets
    are ``levels`` consecutive ones."""
    a, b = Codestream(full), Codestream(half)
    la, lb = a.packet_lengths(), b.packet_lengths()
    siz = bytearray(a.marker(SIZ))
    data = b""
    for c in range((len(siz) - 36) // 3):
        src, lens = (b, lb) if c in which else (a, la)
        start = sum(lens[:c * levels])
        data += src.parts[0][4][start:start + sum(lens[c * levels:(c + 1) * levels])]
        if c in which:
            siz[36 + 3 * c + 1:36 + 3 * c + 3] = b"\x02\x02"
    a.set_marker(SIZ, bytes(siz))
    a.parts = [(0, 0, 1, [], data)]
    return a.build()
