// A JPEG decoder for data/imread.py: the .jpg files and the JPEG strips and
// tiles of TIFF (compression 7) that PIL and cv2 read through libjpeg-turbo,
// decoded to the same samples.
//
// Coverage: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2) at 8 bits, with 1 or 3 components and any
// integral sampling factors; DC and AC first and refinement scans, EOB
// runs, restart intervals.  The arithmetic is libjpeg-turbo's at its
// defaults: the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2, the
// range-limit table of jdmaster.c), the fancy upsampling of jdsample.c
// (h2v1 and h2v2 when the component is wider than 2 samples, h1v2; box
// replication otherwise), the YCbCr -> RGB tables of jdcolor.c (SCALEBITS
// 16), and libjpeg's colour-space rule (a JFIF APP0, an Adobe APP14's
// transform flag, component ids 'R', 'G', 'B').  Arithmetic coding,
// lossless and hierarchical processes, 12-bit samples, 2 or 4 components,
// DNL and a progressive image whose scans leave coefficients unfinished
// (which libjpeg smooths) are refused by name; a damaged stream raises.
//
// jpeg_info reads the headers: (height, width, output components).
// jpeg_decode writes the (height, width, components) samples; sh > 0 first
// checks the sampling factors as libtiff does (sh x sv for the first
// component, 1 x 1 for the others).  Both take an
// optional tables stream first (a TIFF's JPEGTables: DQT and DHT segments
// that the strip's abbreviated stream leaves out), return 0 or -1, and on
// -1 write the reason into err.  ``color``: 0 libjpeg's rule (a .jpg), 1
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

// zigzag position -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    bool defined = false;
    uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer)
    uint8_t look_val[512];
    int32_t maxcode[18];
    int32_t valoff[17];
    uint8_t vals[256];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
    int dw = 0, dh = 0;        // downsampled size in samples
    int bw = 0, bh = 0;        // allocated blocks (whole MCUs)
    int wb = 0, hb = 0;        // blocks holding samples
    std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
    int32_t q[64];
    bool latched = false;
    int coef_bits[64];
    int dc_pred = 0;
};

struct Decoder {
    const uint8_t* d = nullptr;
    int64_t n = 0, pos = 0;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    bool frame = false, progressive = false, jfif = false, adobe = false;
    int adobe_transform = -1;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart = 0;
    Component comp[4];
    // the entropy-coded segment's bits
    uint64_t buf = 0;
    int bits = 0, fake = 0;
    bool marker = false;
    int eobrun = 0;

    uint8_t byte() {
        if (pos >= n) throw Error("the stream ends inside a marker segment");
        return d[pos++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }

    // ---- bits -------------------------------------------------------------
    void reset_bits() {
        buf = 0;
        bits = fake = 0;
        marker = false;
    }
    void fill() {
        while (bits <= 56) {
            if (!marker && pos < n) {
                uint8_t b = d[pos];
                if (b == 0xFF) {
                    if (pos + 1 < n && d[pos + 1] == 0) {
                        pos += 2;
                    } else {  // a marker: the segment's data ends here
                        marker = true;
                        continue;
                    }
                } else {
                    ++pos;
                }
                buf = (buf << 8) | b;
            } else {
                buf <<= 8;
                fake += 8;
            }
            bits += 8;
        }
    }
    void consume(int k) {
        bits -= k;
        if (bits < fake) throw Error("damaged JPEG data (the entropy-coded data ends early)");
    }
    int get_bits(int k) {
        if (k == 0) return 0;
        if (bits < k) fill();
        int v = static_cast<int>((buf >> (bits - k)) & ((1u << k) - 1));
        consume(k);
        return v;
    }
    int get_bit() { return get_bits(1); }
    static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
    int decode(const Huffman& t) {
        if (!t.defined) throw Error("a scan uses a Huffman table that is not defined");
        if (bits < 16) fill();
        int peek = static_cast<int>((buf >> (bits - 9)) & 511);
        if (t.look_len[peek]) {
            consume(t.look_len[peek]);
            return t.look_val[peek];
        }
        int code = static_cast<int>((buf >> (bits - 16)) & 0xFFFF);
        for (int l = 10; l <= 16; ++l) {
            int c = code >> (16 - l);
            if (c <= t.maxcode[l]) {
                consume(l);
                return t.vals[(t.valoff[l] + c) & 0xFF];
            }
        }
        throw Error("damaged JPEG data (a Huffman code no table holds)");
    }

    // ---- marker segments --------------------------------------------------
    int next_marker() {
        // skip to 0xFF, then past fill bytes
        while (pos < n && d[pos] != 0xFF) ++pos;
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) return -1;
        return d[pos++];
    }
    void dqt(int64_t end) {
        while (pos < end) {
            int pq = byte();
            int t = pq & 15;
            if (t > 3) throw Error("a DQT of table id > 3");
            for (int k = 0; k < 64; ++k)
                qt[t][kNatural[k]] = static_cast<uint16_t>((pq >> 4) ? u16() : byte());
            qt_defined[t] = true;
        }
    }
    void dht(int64_t end) {
        while (pos < end) {
            int tc = byte();
            int t = tc & 15;
            if (t > 3 || (tc >> 4) > 1) throw Error("a DHT of table class > 1 or id > 3");
            Huffman& h = (tc >> 4) ? ac[t] : dc[t];
            uint8_t counts[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
            if (total > 256) throw Error("a Huffman table of more than 256 codes");
            for (int k = 0; k < total; ++k) h.vals[k] = byte();
            std::memset(h.look_len, 0, sizeof h.look_len);
            int code = 0, k = 0;
            for (int l = 1; l <= 16; ++l) {
                h.valoff[l] = k - code;
                for (int i = 0; i < counts[l]; ++i, ++code, ++k) {
                    if (code >= (1 << l)) throw Error("a Huffman table whose codes overflow");
                    if (l <= 9) {
                        int shift = 9 - l;
                        for (int j = 0; j < (1 << shift); ++j) {
                            h.look_len[(code << shift) | j] = static_cast<uint8_t>(l);
                            h.look_val[(code << shift) | j] = h.vals[k];
                        }
                    }
                }
                h.maxcode[l] = counts[l] ? code - 1 : -1;
                code <<= 1;
            }
            h.maxcode[17] = 0x7FFFFFFF;
            h.defined = true;
        }
    }
    void sof(int m) {
        if (frame) throw Error("a second frame header");
        int p = byte();
        height = u16();
        width = u16();
        ncomp = byte();
        if (p != 8)
            throw Error(std::to_string(p) + "-bit JPEG (12-bit and other precisions are not read)");
        if (height == 0) throw Error("a JPEG whose height a DNL marker gives (DNL is not read)");
        if (width == 0) throw Error("a JPEG of width 0");
        if (ncomp == 4) throw Error("4-component JPEG (CMYK or YCCK) is not read");
        if (ncomp != 1 && ncomp != 3)
            throw Error(std::to_string(ncomp) + "-component JPEG is not read");
        progressive = m == 0xC2;
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            k.id = byte();
            int hv = byte();
            k.h = hv >> 4;
            k.v = hv & 15;
            k.tq = byte();
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
                throw Error("JPEG sampling factors of a fractional ratio are not read");
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

    // ---- scans ------------------------------------------------------------
    void restart_marker(int index) {
        reset_bits();
        while (pos < n && !(d[pos] == 0xFF && pos + 1 < n && d[pos + 1] != 0 &&
                            d[pos + 1] != 0xFF))
            ++pos;
        if (pos + 1 >= n || d[pos + 1] != 0xD0 + (index & 7))
            throw Error("damaged JPEG data (a restart marker missing or out of order)");
        pos += 2;
    }

    void block_sequential(Component& k, int16_t* blk) {
        int s = decode(dc[k.td]);
        if (s > 15) throw Error("damaged JPEG data (a DC difference of more than 15 bits)");
        int diff = s ? extend(get_bits(s), s) : 0;
        k.dc_pred += diff;
        blk[0] = static_cast<int16_t>(k.dc_pred);
        const Huffman& t = ac[k.ta];
        for (int i = 1; i < 64; ++i) {
            int rs = decode(t);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                i += r;
                if (i > 63) throw Error("damaged JPEG data (a coefficient past the block)");
                blk[kNatural[i]] = static_cast<int16_t>(extend(get_bits(s), s));
            } else {
                if (r != 15) break;
                i += 15;
            }
        }
    }

    void dc_first(Component& k, int16_t* blk, int al) {
        int s = decode(dc[k.td]);
        if (s > 15) throw Error("damaged JPEG data (a DC difference of more than 15 bits)");
        k.dc_pred += s ? extend(get_bits(s), s) : 0;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc_pred) << al);
    }

    void ac_first(Component& k, int16_t* blk, int ss, int se, int al) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        const Huffman& t = ac[k.ta];
        for (int i = ss; i <= se; ++i) {
            int rs = decode(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                i += r;
                if (i > 63) throw Error("damaged JPEG data (a coefficient past the block)");
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

    // jdphuff.c decode_mcu_AC_refine: correction bits for the coefficients
    // already nonzero, new ones of magnitude 1 << al
    void ac_refine(Component& k, int16_t* blk, int ss, int se, int al) {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huffman& t = ac[k.ta];
        int i = ss;
        auto correct = [&](int16_t& c) {
            if (get_bit() && (c & p1) == 0) c = static_cast<int16_t>(c >= 0 ? c + p1 : c + m1);
        };
        if (eobrun == 0) {
            for (; i <= se; ++i) {
                int rs = decode(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) throw Error("damaged JPEG data (a refinement of size > 1)");
                    s = get_bit() ? p1 : m1;
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
                if (s) {
                    if (i > 63) throw Error("damaged JPEG data (a coefficient past the block)");
                    blk[kNatural[i]] = static_cast<int16_t>(s);
                }
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

    void sos() {
        if (!frame) throw Error("a scan before the frame header");
        int ns = byte();
        if (ns < 1 || ns > 4) throw Error("a scan of more than 4 components");
        Component* sc[4];
        for (int i = 0; i < ns; ++i) {
            int id = byte(), tt = byte();
            sc[i] = nullptr;
            for (int c = 0; c < ncomp; ++c)
                if (comp[c].id == id) sc[i] = &comp[c];
            if (!sc[i]) throw Error("a scan names a component the frame lacks");
            sc[i]->td = tt >> 4;
            sc[i]->ta = tt & 15;
            if (sc[i]->td > 3 || sc[i]->ta > 3) throw Error("a scan's table id > 3");
        }
        int ss = byte(), se = byte(), a = byte();
        int ah = a >> 4, al = a & 15;
        if (progressive) {
            if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13)
                throw Error("damaged JPEG data (a progressive scan's parameters)");
        } else if (ss != 0 || se != 63 || a != 0) {
            throw Error("damaged JPEG data (a sequential scan's parameters)");
        }
        for (int i = 0; i < ns; ++i) {
            Component& k = *sc[i];
            if (!k.latched) {  // libjpeg latches a table at the component's first scan
                if (!qt_defined[k.tq]) throw Error("a component's quantisation table is not defined");
                for (int j = 0; j < 64; ++j) k.q[j] = qt[k.tq][j];
                k.latched = true;
                k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
            }
            k.dc_pred = 0;
            for (int j = ss; j <= se; ++j) k.coef_bits[j] = al;
        }
        reset_bits();
        eobrun = 0;
        // one component: its blocks in raster order, each an MCU;
        // several: whole MCUs of each one's h x v blocks
        const int64_t units = ns == 1 ? static_cast<int64_t>(sc[0]->wb) * sc[0]->hb
                                      : static_cast<int64_t>(mcux) * mcuy;
        int rst = 0;
        for (int64_t u = 0; u < units; ++u) {
            if (restart && u > 0 && u % restart == 0) {
                restart_marker(rst++);
                eobrun = 0;
                for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
            }
            for (int i = 0; i < ns; ++i) {
                Component& k = *sc[i];
                int nby = ns == 1 ? 1 : k.v, nbx = ns == 1 ? 1 : k.h;
                int64_t by0 = ns == 1 ? u / k.wb : (u / mcux) * k.v;
                int64_t bx0 = ns == 1 ? u % k.wb : (u % mcux) * k.h;
                for (int y = 0; y < nby; ++y) {
                    for (int x = 0; x < nbx; ++x) {
                        int16_t* blk = &k.coef[((by0 + y) * k.bw + bx0 + x) * 64];
                        if (!progressive)
                            block_sequential(k, blk);
                        else if (ss == 0 && ah == 0)
                            dc_first(k, blk, al);
                        else if (ss == 0)
                            blk[0] = static_cast<int16_t>(blk[0] | (get_bit() << al));
                        else if (ah == 0)
                            ac_first(k, blk, ss, se, al);
                        else
                            ac_refine(k, blk, ss, se, al);
                    }
                }
            }
        }
        // the scan's data ends at the next marker
        if (!marker)
            while (pos < n && !(d[pos] == 0xFF && pos + 1 < n && d[pos + 1] != 0)) ++pos;
        reset_bits();
    }

    // Read the markers until EOI (or, with ``header_only``, the first SOS).
    void parse(const uint8_t* data, int64_t size, bool header_only) {
        d = data;
        n = size;
        pos = 0;
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw Error("not a JPEG stream (no SOI)");
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (m < 0) {
                if (header_only || !frame) throw Error("the JPEG stream ends before its image");
                return;  // libjpeg takes a missing EOI as the end
            }
            if (m == 0xD9) return;
            if (m >= 0xD0 && m <= 0xD7) continue;  // a stray restart marker
            if (m == 0x01) continue;
            int64_t len = u16();
            int64_t end = pos + len - 2;
            if (len < 2 || end > n) throw Error("a marker segment runs past the stream");
            switch (m) {
                case 0xC0:
                case 0xC1:
                case 0xC2:
                    sof(m);
                    break;
                case 0xC3:
                case 0xC7:
                case 0xCB:
                case 0xCF:
                    throw Error("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ") is not read");
                case 0xC5:
                case 0xC6:
                case 0xCD:
                case 0xCE:
                    throw Error("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
                                ") is not read");
                case 0xC9:
                case 0xCA:
                    throw Error("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
                                ") is not read");
                case 0xC4:
                    dht(end);
                    break;
                case 0xDB:
                    dqt(end);
                    break;
                case 0xDD:
                    restart = u16();
                    break;
                case 0xDC:
                    throw Error("a JPEG with a DNL marker is not read");
                case 0xDA:
                    if (header_only) return;
                    sos();
                    continue;  // sos() left pos at the marker after the scan
                case 0xE0:
                    if (len >= 7 && std::memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
                    break;
                case 0xEE:
                    if (len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
                        adobe = true;
                        adobe_transform = d[pos + 11];
                    }
                    break;
                default:
                    break;
            }
            pos = end;
        }
    }

    // ---- samples ----------------------------------------------------------
    static uint8_t limit(int64_t x) {  // jdmaster.c's post-IDCT range limit
        int i = static_cast<int>(x & 1023);
        if (i >= 512) i -= 1024;
        i += 128;
        return static_cast<uint8_t>(i < 0 ? 0 : (i > 255 ? 255 : i));
    }

    // jidctint.c jpeg_idct_islow of one block into out (stride)
    static void idct(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
        const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
        int ws[64];
        for (int c = 0; c < 8; ++c) {
            const int16_t* p = in + c;
            const int32_t* qq = q + c;
            if (!p[8] && !p[16] && !p[24] && !p[32] && !p[40] && !p[48] && !p[56]) {
                int dcval = static_cast<int>(static_cast<uint32_t>(p[0] * qq[0]) << 2);
                for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
                continue;
            }
            int64_t z2 = p[16] * qq[16], z3 = p[48] * qq[48];
            int64_t z1 = (z2 + z3) * F0541;
            int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
            z2 = p[0] * qq[0];
            z3 = p[32] * qq[32];
            int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                    tmp12 = tmp1 - tmp2;
            tmp0 = p[56] * qq[56];
            tmp1 = p[40] * qq[40];
            tmp2 = p[24] * qq[24];
            tmp3 = p[8] * qq[8];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            auto ds = [](int64_t x) { return static_cast<int>((x + (1 << 10)) >> 11); };
            ws[0 * 8 + c] = ds(tmp10 + tmp3);
            ws[7 * 8 + c] = ds(tmp10 - tmp3);
            ws[1 * 8 + c] = ds(tmp11 + tmp2);
            ws[6 * 8 + c] = ds(tmp11 - tmp2);
            ws[2 * 8 + c] = ds(tmp12 + tmp1);
            ws[5 * 8 + c] = ds(tmp12 - tmp1);
            ws[3 * 8 + c] = ds(tmp13 + tmp0);
            ws[4 * 8 + c] = ds(tmp13 - tmp0);
        }
        for (int r = 0; r < 8; ++r) {
            const int* w = ws + r * 8;
            uint8_t* o = out + static_cast<int64_t>(r) * stride;
            if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
                uint8_t v = limit((static_cast<int64_t>(w[0]) + 16) >> 5);
                for (int c = 0; c < 8; ++c) o[c] = v;
                continue;
            }
            int64_t z2 = w[2], z3 = w[6];
            int64_t z1 = (z2 + z3) * F0541;
            int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
            int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * 8192;
            int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * 8192;
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                    tmp12 = tmp1 - tmp2;
            tmp0 = w[7];
            tmp1 = w[5];
            tmp2 = w[3];
            tmp3 = w[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            auto ds = [](int64_t x) { return limit((x + (1 << 17)) >> 18); };
            o[0] = ds(tmp10 + tmp3);
            o[7] = ds(tmp10 - tmp3);
            o[1] = ds(tmp11 + tmp2);
            o[6] = ds(tmp11 - tmp2);
            o[2] = ds(tmp12 + tmp1);
            o[5] = ds(tmp12 - tmp1);
            o[3] = ds(tmp13 + tmp0);
            o[4] = ds(tmp13 - tmp0);
        }
    }

    // component k's samples at full size (width x height), as jdsample.c
    // upsamples them
    std::vector<uint8_t> plane(const Component& k) const {
        const int pw = k.wb * 8, ph = k.hb * 8;
        std::vector<uint8_t> s(static_cast<size_t>(pw) * ph);
        if (!k.latched) throw Error("a component no scan holds");
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

    void check_finished() const {
        if (!progressive) return;
        for (int c = 0; c < ncomp; ++c)
            for (int i = 0; i < 10; ++i)
                if (comp[c].coef_bits[i] != 0)
                    throw Error("a progressive JPEG whose scans leave coefficients unfinished "
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
        std::vector<uint8_t> p[3];
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

int jpeg_info(const uint8_t* tables, int64_t nt, const uint8_t* src, int64_t n, int64_t* info,
              char* err, int64_t errcap) {
    try {
        Decoder dec;
        if (nt > 0) dec.parse(tables, nt, false);
        dec.parse(src, n, true);
        if (!dec.frame) throw Error("a JPEG stream without a frame header");
        info[0] = dec.height;
        info[1] = dec.width;
        info[2] = dec.ncomp;
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

int jpeg_decode(const uint8_t* tables, int64_t nt, const uint8_t* src, int64_t n, int color,
                int sh, int sv, uint8_t* dst, int64_t cap, char* err, int64_t errcap) {
    try {
        Decoder dec;
        if (nt > 0) dec.parse(tables, nt, false);
        dec.parse(src, n, false);
        if (!dec.frame) throw Error("a JPEG stream without a frame header");
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
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

}  // extern "C"
