// A JPEG decoder for data/imread.py: the .jpg files and the JPEG strips and
// tiles of TIFF (compression 7) that PIL and cv2 read through libjpeg-turbo,
// decoded to the same samples.
//
// Coverage: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2) at 8 bits, with 1 or 3 components and any
// integral sampling factors; DC and AC first and refinement scans, EOB
// runs, restart intervals.  The arithmetic is libjpeg-turbo's on x86-64 at
// its defaults: the SIMD islow IDCT (16-bit lanes, below), the fancy
// upsampling of jdsample.c (h2v1 and h2v2 when the component is wider than
// 2 samples, h1v2; box replication otherwise), the YCbCr -> RGB tables of
// jdcolor.c (SCALEBITS 16), and libjpeg's colour-space rule (a JFIF APP0,
// an Adobe APP14's transform flag, component ids 'R', 'G', 'B').
// Arithmetic coding, lossless and hierarchical processes, 12-bit samples,
// 2 or 4 components, a height that a DNL marker gives and a progressive
// image that libjpeg smooths (its scans leave low AC coefficients
// unfinished, jdcoefct.c's smoothing_ok) are refused by name; 4 components
// are read where the caller asks for cmyk (BLP1's JPEG, data/textures.py),
// each plane as it is stored: the JCS_CMYK source colour space that PIL's
// BLP plugin sets, whatever an Adobe marker says.
//
// Damaged streams are read as libjpeg-turbo reads them (jdmarker.c,
// jdhuff.c, jdphuff.c): bytes before a marker are skipped, FF fill and
// FF 00 pairs between segments too; an APPn or COM length under 2 skips
// nothing; the reserved markers, a second SOI or SOF, a bad length and a
// bad table raise; a Huffman code no table holds decodes as 0 (17 bits),
// a coefficient index past 63 lands on 63; a marker inside the
// entropy-coded data ends the segment (zero bits, the MCUs after it left
// zero until the next restart); a restart marker missing or out of order
// resyncs as jpeg_resync_to_restart does.  ``source`` says what happens
// where the data ends: 0 (strict: a TIFF strip) and 2 (cv2's
// jpeg_stdio_src) read an endless FF D9 there, 1 (PIL's suspending
// source, fed in blocks of 65536 bytes) fails wherever libjpeg would wait
// for more bytes, but after the last MCU of a one-scan image, where PIL
// ignores jpeg_finish_decompress's suspension.  The entropy decoder keeps
// libjpeg-turbo's bit buffer exactly (decode_mcu_fast while 512 bytes a
// block are buffered and no restart interval is set, else decode_mcu_slow
// filling to 57 bits), since where it runs out decides PIL's outcome.  In
// strict mode every libjpeg warning raises instead.
//
// jpeg_info reads the headers: (height, width, output components).
// jpeg_decode writes the (height, width, components) samples; sh > 0 first
// checks the sampling factors as libtiff does (sh x sv for the first
// component, 1 x 1 for the others).  Both take an
// optional tables stream first (a TIFF's JPEGTables: DQT and DHT segments
// that the strip's abbreviated stream leaves out), return 0 or -1, and on
// -1 (damaged or refused by libjpeg) or -2 (a form the port refuses) write
// the reason into err.  ``color``: 0 libjpeg's rule (a .jpg), 1
// no conversion (a TIFF of photometric min-is-black or RGB: libtiff's
// JCS_UNKNOWN), 2 YCbCr -> RGB (a TIFF of photometric YCbCr, libtiff's
// JPEGCOLORMODE_RGB).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};
// a form libjpeg reads and the port does not (jpeg_decode returns -2)
struct Refusal : Error {
    using Error::Error;
};
// PIL's source has no byte where libjpeg needs one: the decoder would wait
struct Suspend {};

enum Source { kStrict = 0, kPil = 1, kCv2 = 2 };
const int64_t kPilBlock = 65536;  // PIL's ImageFile.MAXBLOCK

// zigzag position -> natural (row-major) index, with jutils.c's 16 extra
// entries that catch a damaged stream's index past 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c's tables (T.81 K.3), which libjpeg-turbo's sequential decoder
// takes for a slot 0 or 1 that no DHT filled (Motion-JPEG frames): counts
// by length 1-16, then the values
const uint8_t kStdDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D},
                                   {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
  {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA
  },
  {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA
  }};

// a DHT's table as the stream gives it
struct HuffSpec {
    bool defined = false;
    uint8_t bits[17];
    uint8_t vals[256];
};

// jdhuff.c's d_derived_tbl
struct Huffman {
    int32_t maxcode[18];
    int32_t valoff[18];
    uint16_t lookup[256];  // 8-bit lookahead: length << 8 | symbol, length 9: longer
    uint8_t vals[256];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
    int dw = 0, dh = 0;        // downsampled size in samples
    int bw = 0, bh = 0;        // allocated blocks (whole MCUs)
    int wb = 0, hb = 0;        // blocks holding samples
    std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
    int32_t q[64] = {0};  // zeros until a scan latches its table
    bool latched = false;
    int coef_bits[64];
};

struct Decoder {
    const uint8_t* d = nullptr;
    int64_t n = 0, pos = 0, avail = 0;
    int source = kStrict;
    bool cmyk = false;    // 4 components read (BLP1's JPEG), planes as stored
    bool in_mcu = false;  // a suspension restarts the MCU
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    HuffSpec dcs[4], acs[4];
    Huffman dct[4], act[4];
    bool saw_soi = false, frame = false, progressive = false, jfif = false, adobe = false;
    bool multi_scan = false;
    int adobe_transform = -1;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart = 0;
    Component comp[4];
    // the scan
    Component* sc[4];
    int ns = 0, ss = 0, se = 0, ah = 0, al = 0;
    int dc_pred[4] = {0, 0, 0, 0};
    int eobrun = 0, restarts_to_go = 0, next_restart = 0;
    // jdhuff.c's bit reader
    uint64_t buf = 0;
    int bits = 0;
    int unread = 0;  // a marker the reader stopped at
    bool insufficient = false;

    void warn(const char* what) {
        if (source == kStrict) throw Error(std::string("damaged JPEG data (") + what + ")");
    }

    // ---- input ------------------------------------------------------------
    int in_byte() {
        if (pos < avail) return d[pos++];
        if (source != kPil) {  // past the end: FF D9 FF D9 ...
            int b = ((pos - n) & 1) ? 0xD9 : 0xFF;
            ++pos;
            return b;
        }
        if (avail < n) {  // PIL reads its next block and calls the decoder again
            avail = std::min(n, avail + kPilBlock);
            if (in_mcu) throw Suspend();
            return in_byte();
        }
        throw Suspend();
    }
    int u16() {
        int hi = in_byte();
        return (hi << 8) | in_byte();
    }
    void skip(int64_t k) {
        if (k > 0) pos += k;
    }

    // ---- bits -------------------------------------------------------------
    // jpeg_fill_bit_buffer: load to 57 bits, stop at a marker, and pad with
    // zeros (once a warning) when fewer than nbits are left
    void fill_slow(int nbits) {
        if (!unread) {
            while (bits < 57) {
                int c = in_byte();
                if (c == 0xFF) {
                    do c = in_byte();
                    while (c == 0xFF);
                    if (c == 0) {
                        c = 0xFF;
                    } else {
                        unread = c;
                        break;
                    }
                }
                buf = (buf << 8) | static_cast<uint64_t>(c);
                bits += 8;
            }
            if (!unread) return;
        }
        if (nbits > bits) {
            if (!insufficient) {
                warn("a marker where the entropy-coded data goes on");
                insufficient = true;
            }
            buf <<= 57 - bits;
            bits = 57;
        }
    }
    // FILL_BIT_BUFFER_FAST: 6 bytes when 16 bits or fewer are left; a
    // marker sets ``unread`` and reads as zeros (the MCU is then redone
    // by the slow path)
    void fill_fast() {
        if (bits > 16) return;
        for (int i = 0; i < 6; ++i) {
            int c0 = pos < avail ? d[pos] : 0, c1 = pos + 1 < avail ? d[pos + 1] : 0;
            ++pos;
            buf = (buf << 8) | static_cast<uint64_t>(c0);
            bits += 8;
            if (c0 == 0xFF) {
                ++pos;
                if (c1 != 0) {
                    unread = c1;
                    pos -= 2;
                    buf &= ~static_cast<uint64_t>(0xFF);
                }
            }
        }
    }
    int peek(int k) const { return static_cast<int>((buf >> (bits - k)) & ((1u << k) - 1)); }
    int take(int k) {
        int v = peek(k);
        bits -= k;
        return v;
    }
    int get_bits(int k) {  // CHECK_BIT_BUFFER + GET_BITS (slow path)
        if (bits < k) fill_slow(k);
        return take(k);
    }
    static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
    // jpeg_huff_decode from a code of at least l bits
    int huff_long(const Huffman& t, int l) {
        int code = get_bits(l);
        while (code > t.maxcode[l]) {
            code = (code << 1) | get_bits(1);
            ++l;
        }
        if (l > 16) {
            warn("a Huffman code no table holds");
            return 0;
        }
        return t.vals[(t.valoff[l] + code) & 0xFF];
    }
    int huff_slow(const Huffman& t) {  // HUFF_DECODE
        if (bits < 8) {
            fill_slow(0);
            if (bits < 8) return huff_long(t, 1);
        }
        int e = t.lookup[peek(8)];
        if ((e >> 8) <= 8) {
            bits -= e >> 8;
            return e & 0xFF;
        }
        return huff_long(t, 9);
    }
    int huff_fast(const Huffman& t) {  // HUFF_DECODE_FAST
        fill_fast();
        int e = t.lookup[peek(8)];
        int nb = e >> 8;
        bits -= nb;
        if (nb <= 8) return e & 0xFF;
        int code = static_cast<int>((buf >> bits) & ((1u << nb) - 1));
        while (code > t.maxcode[nb]) {
            code = (code << 1) | take(1);
            ++nb;
        }
        return nb > 16 ? 0 : t.vals[(t.valoff[nb] + code) & 0xFF];
    }

    // ---- marker segments (jdmarker.c) ---------------------------------------
    // next_marker: skip to an FF, past FF fill, and over FF 00 pairs
    int next_marker() {
        for (;;) {
            int c = in_byte();
            while (c != 0xFF) c = in_byte();
            do c = in_byte();
            while (c == 0xFF);
            if (c != 0) return c;
        }
    }
    void dqt() {
        int64_t length = u16() - 2;
        while (length > 0) {
            int pq = in_byte();
            int t = pq & 15, prec = pq >> 4;
            if (t > 3) throw Error("a DQT of table id > 3");
            for (int k = 0; k < 64; ++k) qt[t][kNatural[k]] = static_cast<uint16_t>(prec ? u16() : in_byte());
            qt_defined[t] = true;
            length -= 65 + (prec ? 64 : 0);
        }
        if (length != 0) throw Error("a DQT segment of a bad length");
    }
    void dht() {
        int64_t length = u16() - 2;
        while (length > 16) {
            int index = in_byte();
            uint8_t counts[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) total += counts[l] = static_cast<uint8_t>(in_byte());
            length -= 17;
            if (total > 256 || total > length) throw Error("a bad Huffman table");
            uint8_t vals[256] = {0};
            for (int k = 0; k < total; ++k) vals[k] = static_cast<uint8_t>(in_byte());
            length -= total;
            bool ac = index & 0x10;
            if (ac) index -= 0x10;
            if (index < 0 || index > 3) throw Error("a DHT of table class > 1 or id > 3");
            HuffSpec& h = ac ? acs[index] : dcs[index];
            std::memcpy(h.bits, counts, 17);
            std::memcpy(h.vals, vals, 256);
            h.defined = true;
        }
        if (length != 0) throw Error("a DHT segment of a bad length");
    }
    void std_tables() {  // jinit_huff_decoder's std_huff_tables
        for (int t = 0; t < 2; ++t) {
            for (int ac = 0; ac < 2; ++ac) {
                HuffSpec& h = ac ? acs[t] : dcs[t];
                if (h.defined) continue;
                h.bits[0] = 0;
                std::memcpy(h.bits + 1, ac ? kStdAcBits[t] : kStdDcBits[t], 16);
                std::memset(h.vals, 0, 256);
                if (ac)
                    std::memcpy(h.vals, kStdAcVals[t], 162);
                else
                    for (int i = 0; i < 12; ++i) h.vals[i] = static_cast<uint8_t>(i);
                h.defined = true;
            }
        }
    }
    // jpeg_make_d_derived_tbl, at the start of a scan that uses the table
    void derive(bool dc, int t) {
        if (t > 3 || !(dc ? dcs[t] : acs[t]).defined)
            throw Error("a scan uses a Huffman table that is not defined");
        const HuffSpec& h = dc ? dcs[t] : acs[t];
        Huffman& o = dc ? dct[t] : act[t];
        int total = 0, first = 0, last = 0;
        for (int l = 1; l <= 16; ++l) {
            total += h.bits[l];
            if (h.bits[l]) last = l, first = first ? first : l;
        }
        if (total > 256) throw Error("a bad Huffman table");
        for (int i = 0; i < 256; ++i) o.lookup[i] = 9 << 8;
        int32_t code = 0;
        int k = 0;
        for (int l = 1; l <= 16; ++l) {
            o.valoff[l] = k - code;
            for (int i = 0; i < h.bits[l]; ++i, ++code, ++k) {
                if (l <= 8)
                    for (int j = 0; j < (1 << (8 - l)); ++j)
                        o.lookup[(code << (8 - l)) | j] = static_cast<uint16_t>(l << 8 | h.vals[k]);
            }
            o.maxcode[l] = h.bits[l] ? code - 1 : -1;
            // no code may be all ones: each length from the first to the
            // last leaves room for one more
            if (first && l >= first && l <= last && code >= (1 << l))
                throw Error("a Huffman table whose codes overflow");
            code <<= 1;
        }
        o.valoff[17] = 0;
        o.maxcode[17] = 0xFFFFF;
        std::memcpy(o.vals, h.vals, 256);
        if (dc)
            for (int i = 0; i < total; ++i)
                if (h.vals[i] > 15) throw Error("a DC Huffman table of a symbol over 15");
    }
    void sof(int m) {
        if (frame) throw Error("a second frame header");
        int64_t length = u16();
        int p = in_byte();
        height = u16();
        width = u16();
        ncomp = in_byte();
        length -= 8;
        if (height == 0) throw Refusal("a JPEG whose height a DNL marker gives (DNL is not read)");
        if (width == 0 || ncomp == 0) throw Error("an empty JPEG image");
        if (length != ncomp * 3) throw Error("a frame header of a bad length");
        if (p != 8)
            throw Refusal(std::to_string(p) + "-bit JPEG (12-bit and other precisions are not read)");
        if (ncomp == 4 && !cmyk) throw Refusal("4-component JPEG (CMYK or YCCK) is not read");
        if (ncomp != 1 && ncomp != 3 && ncomp != 4)
            throw Refusal(std::to_string(ncomp) + "-component JPEG is not read");
        progressive = m == 0xC2;
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            k.id = in_byte();
            int hv = in_byte();
            k.h = hv >> 4;
            k.v = hv & 15;
            k.tq = in_byte();
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
                throw Error("a JPEG component's sampling factors or table are out of range");
            hmax = std::max(hmax, k.h);
            vmax = std::max(vmax, k.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            if (hmax % k.h || vmax % k.v)
                throw Refusal("JPEG sampling factors of a fractional ratio are not read");
            k.dw = static_cast<int>((static_cast<int64_t>(width) * k.h + hmax - 1) / hmax);
            k.dh = static_cast<int>((static_cast<int64_t>(height) * k.v + vmax - 1) / vmax);
            k.wb = (k.dw + 7) / 8;
            k.hb = (k.dh + 7) / 8;
            k.bw = mcux * k.h;
            k.bh = mcuy * k.v;
            for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
        }
        frame = true;
    }
    // APP0 and APP14 (get_interesting_appn: up to 14 bytes examined), other
    // APPn and COM skipped; a length under 2 skips nothing
    void appn(int m) {
        int64_t length = u16() - 2;
        uint8_t b[14];
        int64_t got = (m == 0xE0 || m == 0xEE) ? std::max<int64_t>(0, std::min<int64_t>(length, 14)) : 0;
        for (int i = 0; i < got; ++i) b[i] = static_cast<uint8_t>(in_byte());
        if (m == 0xE0 && got >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
        if (m == 0xEE && got >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = b[11];
        }
        skip(length - got);
    }
    void dac() {
        int64_t length = u16() - 2;
        while (length > 0) {
            int index = in_byte(), val = in_byte();
            length -= 2;
            if (index >= 32) throw Error("a DAC of table id > 31");
            if (index < 16 && (val >> 4) < (val & 15)) throw Error("a DAC of a bad value");
        }
        if (length != 0) throw Error("a DAC segment of a bad length");
    }
    void sos() {
        if (!frame) throw Error("a scan before the frame header");
        int64_t length = u16();
        ns = in_byte();
        if (length != ns * 2 + 6 || ns < 1 || ns > 4) throw Error("a scan header of a bad length");
        for (int i = 0; i < ns; ++i) {
            int id = in_byte(), tt = in_byte();
            sc[i] = nullptr;
            for (int c = 0; c < ncomp && !sc[i]; ++c) {
                bool taken = false;
                for (int j = 0; j < i; ++j) taken = taken || sc[j] == &comp[c];
                if (comp[c].id == id && !taken) sc[i] = &comp[c];
            }
            if (!sc[i]) throw Error("a scan names a component the frame lacks");
            sc[i]->td = tt >> 4;
            sc[i]->ta = tt & 15;
        }
        ss = in_byte();
        se = in_byte();
        int a = in_byte();
        ah = a >> 4;
        al = a & 15;
        next_restart = 0;
    }

    // read_markers: the segments up to the next SOS (true) or EOI (false)
    bool read_markers() {
        for (;;) {
            int m = unread ? unread : next_marker();
            unread = 0;
            switch (m) {
                case 0xD8:  // get_soi: a stream's restart interval and colour markers reset
                    if (saw_soi) throw Error("a second SOI marker");
                    saw_soi = true;
                    restart = 0;
                    jfif = adobe = false;
                    adobe_transform = -1;
                    break;
                case 0xC0:
                case 0xC1:
                case 0xC2:
                    sof(m);
                    break;
                case 0xC3:
                case 0xC7:
                case 0xCB:
                case 0xCF:
                    throw Refusal("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ") is not read");
                case 0xC5:
                case 0xC6:
                case 0xCD:
                case 0xCE:
                    throw Refusal("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
                                ") is not read");
                case 0xC9:
                case 0xCA:
                    throw Refusal("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
                                ") is not read");
                case 0xC8:
                    throw Error("a JPG (0xC8) marker, which libjpeg refuses");
                case 0xDA:
                    sos();
                    return true;
                case 0xD9:
                    return false;
                case 0xC4:
                    dht();
                    break;
                case 0xDB:
                    dqt();
                    break;
                case 0xCC:
                    dac();
                    break;
                case 0xDD:
                    if (u16() != 4) throw Error("a DRI segment of a bad length");
                    restart = u16();
                    break;
                case 0xDC:  // DNL: libjpeg skips it
                    skip(u16() - 2);
                    break;
                case 0x01:  // TEM and the restart markers carry nothing
                case 0xD0:
                case 0xD1:
                case 0xD2:
                case 0xD3:
                case 0xD4:
                case 0xD5:
                case 0xD6:
                case 0xD7:
                    break;
                default:
                    if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
                        appn(m);
                        break;
                    }
                    throw Error("a reserved JPEG marker (0x" + std::string(1, "0123456789ABCDEF"[m >> 4]) +
                                std::string(1, "0123456789ABCDEF"[m & 15]) + "), which libjpeg refuses");
            }
        }
    }

    // ---- scans (jdhuff.c, jdphuff.c) ----------------------------------------
    // read_restart_marker and jpeg_resync_to_restart
    void restart_marker() {
        bits = 0;
        if (!unread) unread = next_marker();
        if (unread == 0xD0 + next_restart) {
            unread = 0;
        } else {
            warn("a restart marker missing or out of order");
            for (;;) {
                int m = unread, action;
                if (m < 0xC0)
                    action = 2;
                else if (m < 0xD0 || m > 0xD7)
                    action = 3;
                else if (m == 0xD0 + ((next_restart + 1) & 7) || m == 0xD0 + ((next_restart + 2) & 7))
                    action = 3;
                else if (m == 0xD0 + ((next_restart - 1) & 7) || m == 0xD0 + ((next_restart - 2) & 7))
                    action = 2;
                else
                    action = 1;
                if (action == 1) {
                    unread = 0;
                    break;
                }
                if (action == 3) break;
                unread = next_marker();
            }
        }
        next_restart = (next_restart + 1) & 7;
        for (int i = 0; i < 4; ++i) dc_pred[i] = 0;
        eobrun = 0;
        restarts_to_go = restart;
        if (!unread) insufficient = false;
    }

    // decode_mcu_slow / decode_mcu_fast of one block; false: the fast path
    // met a marker
    template <bool Fast>
    bool block_sequential(int ci, Component& k, int16_t* blk) {
        auto decode = [&](const Huffman& t) { return Fast ? huff_fast(t) : huff_slow(t); };
        auto value = [&](int s) {
            if (Fast) {
                fill_fast();
                return take(s);
            }
            return get_bits(s);
        };
        int s = decode(dct[k.td]);
        if (s) s = extend(value(s), s);
        dc_pred[ci] += s;
        blk[0] = static_cast<int16_t>(dc_pred[ci]);
        const Huffman& t = act[k.ta];
        for (int i = 1; i < 64; ++i) {
            int rs = decode(t);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                i += r;
                blk[kNatural[i]] = static_cast<int16_t>(extend(value(s), s));
            } else {
                if (r != 15) break;
                i += 15;
            }
        }
        return !(Fast && unread);
    }

    void dc_first(int ci, Component& k, int16_t* blk) {
        int s = huff_slow(dct[k.td]);
        if (s) s = extend(get_bits(s), s);
        dc_pred[ci] += s;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(dc_pred[ci]) << al);
    }

    void ac_first(Component& k, int16_t* blk) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        const Huffman& t = act[k.ta];
        for (int i = ss; i <= se; ++i) {
            int rs = huff_slow(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                i += r;
                blk[kNatural[i]] = static_cast<int16_t>(
                    static_cast<uint32_t>(extend(get_bits(s), s)) << al);
            } else if (r == 15) {
                i += 15;
            } else {
                eobrun = (1 << r) - 1;
                if (r) eobrun += get_bits(r);
                break;
            }
        }
    }

    // decode_mcu_AC_refine: correction bits for the coefficients already
    // nonzero, new ones of magnitude 1 << al
    void ac_refine(Component& k, int16_t* blk) {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huffman& t = act[k.ta];
        int i = ss;
        auto correct = [&](int16_t& c) {
            if (get_bits(1) && (c & p1) == 0) c = static_cast<int16_t>(c >= 0 ? c + p1 : c + m1);
        };
        if (eobrun == 0) {
            for (; i <= se; ++i) {
                int rs = huff_slow(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) warn("a refinement of size > 1");
                    s = get_bits(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += get_bits(r);
                    break;
                }
                do {
                    int16_t& c = blk[kNatural[i]];
                    if (c != 0) {
                        correct(c);
                    } else {
                        if (--r < 0) break;
                    }
                    ++i;
                } while (i <= se);
                if (s) blk[kNatural[i]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; i <= se; ++i) {
                int16_t& c = blk[kNatural[i]];
                if (c != 0) correct(c);
            }
            --eobrun;
        }
    }

    // the blocks of MCU u of the scan
    void mcu_blocks(int64_t u, int16_t** out, int* owner) {
        int nb = 0;
        for (int i = 0; i < ns; ++i) {
            Component& k = *sc[i];
            int nby = ns == 1 ? 1 : k.v, nbx = ns == 1 ? 1 : k.h;
            int64_t by0 = ns == 1 ? u / k.wb : (u / mcux) * k.v;
            int64_t bx0 = ns == 1 ? u % k.wb : (u % mcux) * k.h;
            for (int y = 0; y < nby; ++y)
                for (int x = 0; x < nbx; ++x) {
                    out[nb] = &k.coef[((by0 + y) * k.bw + bx0 + x) * 64];
                    owner[nb++] = i;
                }
        }
    }

    // one MCU as decode_mcu (jdhuff.c) or the progressive decoders do it
    void mcu(int16_t** blk, const int* owner, int nb) {
        if (!progressive) {
            if (!multi_scan)
                for (int b = 0; b < nb; ++b) std::memset(blk[b], 0, 64 * sizeof(int16_t));
            if (insufficient) return;
            bool fast = !multi_scan && !restart && avail - pos >= 512 * static_cast<int64_t>(nb) && !unread;
            if (fast) {
                const uint64_t buf0 = buf;
                const int bits0 = bits, pred0[4] = {dc_pred[0], dc_pred[1], dc_pred[2], dc_pred[3]};
                const int64_t pos0 = pos;
                bool ok = true;
                for (int b = 0; b < nb && ok; ++b)
                    ok = block_sequential<true>(owner[b], *sc[owner[b]], blk[b]);
                if (ok) return;
                buf = buf0, bits = bits0, pos = pos0, unread = 0;
                std::memcpy(dc_pred, pred0, sizeof pred0);
                for (int b = 0; b < nb; ++b) std::memset(blk[b], 0, 64 * sizeof(int16_t));
            }
            for (int b = 0; b < nb; ++b) block_sequential<false>(owner[b], *sc[owner[b]], blk[b]);
            return;
        }
        if (ss == 0 && ah != 0) {  // DC refinement reads its bits regardless
            for (int b = 0; b < nb; ++b) blk[b][0] = static_cast<int16_t>(blk[b][0] | (get_bits(1) << al));
            return;
        }
        if (insufficient) return;
        for (int b = 0; b < nb; ++b) {
            Component& k = *sc[owner[b]];
            if (ss == 0)
                dc_first(owner[b], k, blk[b]);
            else if (ah == 0)
                ac_first(k, blk[b]);
            else
                ac_refine(k, blk[b]);
        }
    }

    void scan() {
        if (!progressive) {
            if (ss != 0 || se != 63 || ah != 0 || al != 0) warn("a sequential scan's parameters");
        } else {
            bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
            if ((ah != 0 && al != ah - 1) || al > 13 || bad)
                throw Error("damaged JPEG data (a progressive scan's parameters)");
        }
        for (int i = 0; i < ns; ++i) {
            Component& k = *sc[i];
            if (!progressive || (ss == 0 && ah == 0)) derive(true, k.td);
            if (!progressive || ss > 0) derive(false, k.ta);
            if (!k.latched) {  // libjpeg latches a table at the component's first scan
                if (!qt_defined[k.tq]) throw Error("a component's quantisation table is not defined");
                for (int j = 0; j < 64; ++j) k.q[j] = qt[k.tq][j];
                k.latched = true;
            }
            if (progressive)
                for (int j = ss; j <= se; ++j) k.coef_bits[j] = al;
        }
        for (int i = 0; i < 4; ++i) dc_pred[i] = 0;
        buf = 0;
        bits = 0;
        insufficient = false;
        eobrun = 0;
        restarts_to_go = restart;
        // one component: its blocks in raster order, each an MCU;
        // several: whole MCUs of each one's h x v blocks
        const int64_t units = ns == 1 ? static_cast<int64_t>(sc[0]->wb) * sc[0]->hb
                                      : static_cast<int64_t>(mcux) * mcuy;
        int16_t* blk[10];
        int owner[10];
        int16_t saved[10 * 64];
        int nb = 0;
        for (int i = 0; i < ns; ++i) nb += ns == 1 ? 1 : sc[i]->h * sc[i]->v;
        if (nb > 10) throw Error("a JPEG MCU of more than 10 blocks, which libjpeg refuses");
        for (int64_t u = 0; u < units; ++u) {
            if (restart) {
                if (restarts_to_go == 0) restart_marker();
                --restarts_to_go;
            }
            mcu_blocks(u, blk, owner);
            for (;;) {  // until the MCU is read without PIL's suspension
                const bool retry = source == kPil && avail < n;
                const uint64_t buf0 = buf;
                const int bits0 = bits, eob0 = eobrun, unread0 = unread;
                const int pred0[4] = {dc_pred[0], dc_pred[1], dc_pred[2], dc_pred[3]};
                const int64_t pos0 = pos;
                const bool insufficient0 = insufficient;
                if (retry)
                    for (int b = 0; b < nb; ++b) std::memcpy(saved + 64 * b, blk[b], 128);
                in_mcu = true;
                try {
                    mcu(blk, owner, nb);
                    in_mcu = false;
                    break;
                } catch (const Suspend&) {
                    in_mcu = false;
                    if (!retry) throw;
                    buf = buf0, bits = bits0, eobrun = eob0, unread = unread0, pos = pos0;
                    insufficient = insufficient0;
                    std::memcpy(dc_pred, pred0, sizeof pred0);
                    for (int b = 0; b < nb; ++b) std::memcpy(blk[b], saved + 64 * b, 128);
                }
            }
        }
    }

    // jpeg_read_header, then (decode) every scan and the markers to EOI as
    // jpeg_start_decompress / jpeg_finish_decompress read them
    enum Stage { kTables, kHeader, kImage };
    void run(const uint8_t* data, int64_t size, int src, Stage stage) {
        d = data;
        n = size;
        pos = 0;
        source = src;
        avail = src == kPil ? std::min(n, kPilBlock) : n;
        unread = 0;
        saw_soi = false;
        try {
            if (u16() != 0xFFD8) throw Error("not a JPEG stream (no SOI)");
        } catch (const Suspend&) {
            throw Error("not a JPEG stream (no SOI)");
        }
        unread = 0xD8;
        try {
            const bool image = read_markers();
            if (stage == kTables) {
                if (image) throw Error("a JPEG tables stream holding a scan");
                return;
            }
            if (!image) throw Error("a JPEG stream without an image (EOI before any scan)");
            if (stage == kHeader) return;
            multi_scan = progressive || ns < ncomp;
            if (!progressive) std_tables();
            for (int c = 0; c < ncomp; ++c)
                comp[c].coef.assign(static_cast<size_t>(comp[c].bw) * comp[c].bh * 64, 0);
            for (;;) {
                scan();
                if (!multi_scan) break;
                if (!read_markers()) return;
            }
        } catch (const Suspend&) {
            throw Error("the JPEG data ends where libjpeg needs more (PIL: image file is truncated)");
        }
        // one scan: the markers after it, to EOI (jpeg_finish_decompress),
        // where PIL stops quietly at the data's end and cv2 ignores errors
        if (source == kCv2) return;
        try {
            if (read_markers()) throw Error("a second scan in a JPEG of one (libjpeg expects EOI)");
        } catch (const Suspend&) {
        }
    }

    // ---- samples ----------------------------------------------------------
    // libjpeg-turbo's SIMD islow IDCT (simd/x86_64/jidctint-avx2.asm and
    // -sse2.asm, which compute the same), the one both oracles run on
    // x86-64: the arithmetic of jidctint.c in 16-bit lanes.  Dequantisation
    // keeps the low 16 bits of coef * q (pmullw); in0 +- in4 and the odd
    // part's z3 = in7 + in3, z4 = in5 + in1 wrap at 16 bits (paddw, psubw);
    // the rotations are pmaddwd pairs of 16-bit products (the constants of
    // jidctint.c folded as the asm folds them), summed in 32 bits; each
    // pass's outputs saturate to 16 bits (packssdw), the last pass's then to
    // 8 (packsswb) before centering, where the C code wraps through its
    // range-limit table.  Pass 1 skips the rotations of a block whose rows
    // 1-7 are all zero (the whole block, not a column), shifting each DC
    // product left by 2 with a 16-bit wrap (psllw); pass 2 has no shortcut.
    static int16_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
    static int16_t sat16(int32_t x) {
        return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
    }
    // one 1-D pass over in[0..7] (stride sin) into out (stride sout):
    // the outputs descaled by ``shift`` and saturated to 16 bits
    static void idct_pass(const int16_t* in, int sin, int16_t* out, int sout, int shift) {
        const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
        const int32_t i0 = in[0], i1 = in[sin], i2 = in[2 * sin], i3 = in[3 * sin],
                      i4 = in[4 * sin], i5 = in[5 * sin], i6 = in[6 * sin], i7 = in[7 * sin];
        auto add = [](int32_t a, int32_t b) {  // paddd / psubd: 32-bit wrap
            return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
        };
        // even part
        const int32_t tmp3 = i2 * (F0541 + F0765) + i6 * F0541;
        const int32_t tmp2 = i2 * F0541 + i6 * (F0541 - F1847);
        const int32_t tmp0 = static_cast<int32_t>(wrap16(i0 + i4)) * 8192;
        const int32_t tmp1 = static_cast<int32_t>(wrap16(i0 - i4)) * 8192;
        const int32_t tmp10 = add(tmp0, tmp3), tmp13 = add(tmp0, -tmp3),
                      tmp11 = add(tmp1, tmp2), tmp12 = add(tmp1, -tmp2);
        // odd part
        const int32_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
        const int32_t r3 = z3 * (F1175 - F1961) + z4 * F1175;
        const int32_t r4 = z3 * F1175 + z4 * (F1175 - F0390);
        const int32_t o0 = add(i7 * (F0298 - F0899) + i1 * -F0899, r3);
        const int32_t o1 = add(i5 * (F2053 - F2562) + i3 * -F2562, r4);
        const int32_t o3 = add(i7 * -F0899 + i1 * (F1501 - F0899), r4);
        const int32_t o2 = add(i5 * -F2562 + i3 * (F3072 - F2562), r3);
        const int32_t round = 1 << (shift - 1);
        auto ds = [&](int32_t x) { return sat16(add(x, round) >> shift); };
        out[0] = ds(add(tmp10, o3));
        out[7 * sout] = ds(add(tmp10, -o3));
        out[sout] = ds(add(tmp11, o2));
        out[6 * sout] = ds(add(tmp11, -o2));
        out[2 * sout] = ds(add(tmp12, o1));
        out[5 * sout] = ds(add(tmp12, -o1));
        out[3 * sout] = ds(add(tmp13, o0));
        out[4 * sout] = ds(add(tmp13, -o0));
    }

    // one block (natural order) dequantised by q into out (stride)
    static void idct(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
        int16_t deq[64], ws[64], res[64];
        int ac = 0;
        for (int i = 0; i < 64; ++i)
            deq[i] = wrap16(static_cast<int32_t>(static_cast<uint16_t>(in[i]) *
                                                 static_cast<uint32_t>(q[i] & 0xFFFF)));
        for (int i = 8; i < 64; ++i) ac |= in[i];
        if (!ac) {
            for (int c = 0; c < 8; ++c)
                for (int r = 0; r < 8; ++r) ws[r * 8 + c] = wrap16(deq[c] * 4);
        } else {
            for (int c = 0; c < 8; ++c) idct_pass(deq + c, 8, ws + c, 8, 11);
        }
        for (int r = 0; r < 8; ++r) idct_pass(ws + r * 8, 1, res + r * 8, 1, 18);
        for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) {
                const int v = res[r * 8 + c];
                out[static_cast<int64_t>(r) * stride + c] =
                    static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
            }
    }

    // component k's samples at full size (width x height), as jdsample.c
    // upsamples them
    std::vector<uint8_t> plane(const Component& k) const {
        const int pw = k.wb * 8, ph = k.hb * 8;
        std::vector<uint8_t> s(static_cast<size_t>(pw) * ph);
        for (int by = 0; by < k.hb; ++by)
            for (int bx = 0; bx < k.wb; ++bx)
                idct(&k.coef[(static_cast<int64_t>(by) * k.bw + bx) * 64], k.q,
                     &s[(static_cast<int64_t>(by) * 8) * pw + bx * 8], pw);
        const int fx = hmax / k.h, fy = vmax / k.v;
        std::vector<uint8_t> out(static_cast<size_t>(width) * height);
        const int dw = k.dw, dh = k.dh;
        auto in = [&](int y, int x) -> int {  // rows past the last real one repeat it
            y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
            return s[static_cast<int64_t>(y) * pw + x];
        };
        std::vector<int> row(2 * static_cast<size_t>(dw) + 2);
        for (int oy = 0; oy < height; ++oy) {
            uint8_t* o = &out[static_cast<int64_t>(oy) * width];
            if (fx == 1 && fy == 1) {
                for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(in(oy, x));
            } else if (fx == 2 && fy == 1 && dw > 2) {  // h2v1 fancy
                int* r = row.data();
                r[0] = in(oy, 0);
                r[1] = (in(oy, 0) * 3 + in(oy, 1) + 2) >> 2;
                for (int x = 1; x < dw - 1; ++x) {
                    int v3 = in(oy, x) * 3;
                    r[2 * x] = (v3 + in(oy, x - 1) + 1) >> 2;
                    r[2 * x + 1] = (v3 + in(oy, x + 1) + 2) >> 2;
                }
                r[2 * dw - 2] = (in(oy, dw - 1) * 3 + in(oy, dw - 2) + 1) >> 2;
                r[2 * dw - 1] = in(oy, dw - 1);
                for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(r[x]);
            } else if (fx == 1 && fy == 2) {  // h1v2 fancy
                int y = oy / 2, near = (oy & 1) ? y + 1 : y - 1, bias = (oy & 1) ? 2 : 1;
                for (int x = 0; x < width; ++x)
                    o[x] = static_cast<uint8_t>((in(y, x) * 3 + in(near, x) + bias) >> 2);
            } else if (fx == 2 && fy == 2 && dw > 2) {  // h2v2 fancy
                int y = oy / 2, near = (oy & 1) ? y + 1 : y - 1;
                int* r = row.data();
                auto col = [&](int x) { return in(y, x) * 3 + in(near, x); };
                int last = col(0), cur = last, next = col(1);
                r[0] = (cur * 4 + 8) >> 4;
                r[1] = (cur * 3 + next + 7) >> 4;
                for (int x = 1; x < dw - 1; ++x) {
                    last = cur;
                    cur = next;
                    next = col(x + 1);
                    r[2 * x] = (cur * 3 + last + 8) >> 4;
                    r[2 * x + 1] = (cur * 3 + next + 7) >> 4;
                }
                last = cur;
                cur = next;
                r[2 * dw - 2] = (cur * 3 + last + 8) >> 4;
                r[2 * dw - 1] = (cur * 4 + 7) >> 4;
                for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(r[x]);
            } else {  // box replication (jdsample.c's h2v1, h2v2 and int upsampling)
                int y = oy / fy;
                for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(in(y, x / fx));
            }
        }
        return out;
    }

    // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image whose
    // components all hold a table and a DC scan, the table's first ten
    // zigzag entries nonzero, and one of whose first nine AC coefficients
    // is unfinished; the port refuses it
    void check_finished() const {
        if (!progressive) return;
        bool useful = false;
        for (int c = 0; c < ncomp; ++c) {
            const Component& k = comp[c];
            if (!k.latched || k.coef_bits[0] < 0) return;
            for (int i = 0; i < 10; ++i)
                if ((k.q[kNatural[i]] & 0xFFFF) == 0) return;
            for (int i = 1; i < 10; ++i) useful = useful || k.coef_bits[i] != 0;
        }
        if (useful)
            throw Refusal("a progressive JPEG whose scans leave coefficients unfinished "
                        "(libjpeg's block smoothing) is not read");
    }

    bool to_rgb(int color) const {
        if (ncomp != 3 || color == 1) return false;
        if (color == 2) return true;
        if (jfif) return true;
        if (adobe) return adobe_transform != 0;
        return !(comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
    }

    void write(uint8_t* dst, int color) const {
        check_finished();
        std::vector<uint8_t> p[4];
        for (int c = 0; c < ncomp; ++c) p[c] = plane(comp[c]);
        const int64_t npx = static_cast<int64_t>(width) * height;
        if (!to_rgb(color)) {
            for (int64_t i = 0; i < npx; ++i)
                for (int c = 0; c < ncomp; ++c) dst[i * ncomp + c] = p[c][i];
            return;
        }
        // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        const int64_t half = 1 << 15;
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            cr_r[i] = static_cast<int>((91881 * x + half) >> 16);
            cb_b[i] = static_cast<int>((116130 * x + half) >> 16);
            cr_g[i] = -46802 * x;
            cb_g[i] = -22554 * x + half;
        }
        auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
        for (int64_t i = 0; i < npx; ++i) {
            int y = p[0][i], cb = p[1][i], cr = p[2][i];
            dst[i * 3] = clamp(y + cr_r[cr]);
            dst[i * 3 + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
            dst[i * 3 + 2] = clamp(y + cb_b[cb]);
        }
    }
};

void set_error(char* err, int64_t cap, const char* msg) {
    if (cap <= 0) return;
    std::strncpy(err, msg, static_cast<size_t>(cap - 1));
    err[cap - 1] = 0;
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* tables, int64_t nt, const uint8_t* src, int64_t n, int source,
              int cmyk, int64_t* info, char* err, int64_t errcap) {
    try {
        Decoder dec;
        dec.cmyk = cmyk;
        if (nt > 0) dec.run(tables, nt, source, Decoder::kTables);
        dec.run(src, n, source, Decoder::kHeader);
        info[0] = dec.height;
        info[1] = dec.width;
        info[2] = dec.ncomp;
        return 0;
    } catch (const Refusal& e) {
        set_error(err, errcap, e.what());
        return -2;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

int jpeg_decode(const uint8_t* tables, int64_t nt, const uint8_t* src, int64_t n, int source,
                int cmyk, int color, int sh, int sv, uint8_t* dst, int64_t cap, char* err,
                int64_t errcap) {
    try {
        Decoder dec;
        dec.cmyk = cmyk;
        if (nt > 0) dec.run(tables, nt, source, Decoder::kTables);
        dec.run(src, n, source, Decoder::kImage);
        if (sh > 0) {  // libtiff's check: the first component sh x sv, the others 1 x 1
            bool ok = dec.comp[0].h == sh && dec.comp[0].v == sv;
            for (int c = 1; c < dec.ncomp; ++c) ok = ok && dec.comp[c].h == 1 && dec.comp[c].v == 1;
            if (!ok)
                throw Error("JPEG sampling factors other than the TIFF's (" + std::to_string(sh) +
                            ", " + std::to_string(sv) + ") for its first component and 1 for the "
                            "others");
        }
        if (static_cast<int64_t>(dec.width) * dec.height * dec.ncomp > cap)
            throw Error("the JPEG image is larger than its buffer");
        dec.write(dst, color);
        return 0;
    } catch (const Refusal& e) {
        set_error(err, errcap, e.what());
        return -2;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

}  // extern "C"
