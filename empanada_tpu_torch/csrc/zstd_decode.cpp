// A ZSTD decoder (RFC 8878) for data/imread.py: the strips and tiles of TIFF
// compression 50000, which libtiff writes as one frame each.
//
// zstd_decode(src, n, dst, cap) decodes the frames in src (skippable frames
// skipped) into dst, never past cap, and returns the bytes written (cap
// when the content is longer), -1 when the data is damaged or its checksum
// disagrees, -2 when a frame needs a dictionary (which the port does not
// read).  Covered: raw, RLE and compressed blocks; raw, RLE, compressed and
// treeless literals in 1 or 4 Huffman streams; sequences of predefined, RLE,
// FSE-compressed and repeated tables; repeat offsets; the frame's window;
// the XXH64 content checksum.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

struct Damaged {};
struct Dictionary {};
struct Full {};

inline int hsb(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---- bit readers ------------------------------------------------------------

// forward, little-endian (FSE table descriptions)
struct Forward {
    const uint8_t* p;
    int64_t n, bit = 0;
    uint32_t read(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i, ++bit) {
            int64_t b = bit >> 3;
            if (b >= n) throw Damaged();
            v |= static_cast<uint32_t>((p[b] >> (bit & 7)) & 1) << i;
        }
        return v;
    }
    int64_t bytes() const { return (bit + 7) >> 3; }
};

// backward (Huffman and FSE streams): starts after the final byte's highest
// set bit and reads towards the start; bits before the start read as 0
struct Backward {
    const uint8_t* p;
    int64_t n, pos;
    Backward(const uint8_t* src, int64_t len) : p(src), n(len) {
        if (len <= 0 || src[len - 1] == 0) throw Damaged();
        pos = len * 8 - (8 - hsb(src[len - 1]));
    }
    uint64_t read(int k) {
        if (k == 0) return 0;
        pos -= k;
        int64_t at = pos, bits = k;
        if (at < 0) {
            bits += at;
            at = 0;
        }
        uint64_t v = 0;
        if (bits > 0) {
            int64_t b0 = at >> 3, b1 = (at + bits - 1) >> 3;
            uint64_t w = 0;
            for (int64_t b = b1; b >= b0; --b) w = (w << 8) | p[b];
            v = (w >> (at & 7)) & ((bits >= 64) ? ~0ull : ((1ull << bits) - 1));
        }
        if (pos < 0) v = -pos >= 64 ? 0 : v << -pos;
        return v;
    }
};

// ---- FSE --------------------------------------------------------------------

struct Fse {
    int log = 0;
    std::vector<uint8_t> sym, bits;
    std::vector<uint16_t> base;

    void build(const int16_t* freq, int nsym, int al) {
        const int size = 1 << al;
        log = al;
        sym.assign(size, 0);
        bits.assign(size, 0);
        base.assign(size, 0);
        std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
        int high = size;
        for (int s = 0; s < nsym; ++s)
            if (freq[s] == -1) {
                if (high == 0) throw Damaged();
                sym[--high] = static_cast<uint8_t>(s);
                next[s] = 1;
            }
        const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
        int pos = 0;
        for (int s = 0; s < nsym; ++s) {
            if (freq[s] <= 0) continue;
            next[s] = static_cast<uint16_t>(freq[s]);
            for (int i = 0; i < freq[s]; ++i) {
                sym[pos] = static_cast<uint8_t>(s);
                do pos = (pos + step) & mask;
                while (pos >= high);
            }
        }
        if (pos != 0) throw Damaged();
        for (int i = 0; i < size; ++i) {
            uint16_t d = next[sym[i]]++;
            bits[i] = static_cast<uint8_t>(al - hsb(d));
            base[i] = static_cast<uint16_t>((d << bits[i]) - size);
        }
    }
    void rle(uint8_t s) {
        log = 0;
        sym.assign(1, s);
        bits.assign(1, 0);
        base.assign(1, 0);
    }
    // a table description at src; returns its size in bytes
    int64_t read(const uint8_t* src, int64_t n, int max_log, int max_sym) {
        Forward f{src, n};
        const int al = 5 + static_cast<int>(f.read(4));
        if (al > max_log) throw Damaged();
        int remaining = 1 << al;
        int16_t freq[256];
        int s = 0;
        while (remaining > 0 && s <= max_sym) {
            const int nb = hsb(static_cast<uint32_t>(remaining + 1)) + 1;
            const uint32_t lower_mask = (1u << (nb - 1)) - 1;
            const uint32_t threshold = (1u << nb) - 1 - (remaining + 1);
            uint32_t val = f.read(nb - 1);
            if (val >= threshold) {
                val |= f.read(1) << (nb - 1);
                if (val > lower_mask) val -= threshold;
            }
            const int proba = static_cast<int>(val) - 1;
            remaining -= proba < 0 ? -proba : proba;
            freq[s++] = static_cast<int16_t>(proba);
            if (proba == 0) {
                uint32_t repeat = f.read(2);
                for (;;) {
                    for (uint32_t i = 0; i < repeat && s <= max_sym; ++i) freq[s++] = 0;
                    if (repeat != 3) break;
                    repeat = f.read(2);
                }
            }
        }
        if (remaining != 0) throw Damaged();
        build(freq, s, al);
        return f.bytes();
    }
    uint32_t init(Backward& b) const { return static_cast<uint32_t>(b.read(log)); }
    uint32_t update(uint32_t state, Backward& b) const {
        return base[state] + static_cast<uint32_t>(b.read(bits[state]));
    }
};

// ---- Huffman ----------------------------------------------------------------

struct Huffman {
    int max_bits = 0;
    std::vector<uint8_t> sym, bits;

    // a tree description at src; returns its size in bytes
    int64_t read(const uint8_t* src, int64_t n) {
        if (n < 1) throw Damaged();
        const int hb = src[0];
        uint8_t w[256] = {0};
        int nw = 0;
        int64_t used;
        if (hb >= 128) {  // 4-bit weights, two a byte
            nw = hb - 127;
            used = 1 + (nw + 1) / 2;
            if (used > n) throw Damaged();
            for (int i = 0; i < nw; ++i)
                w[i] = static_cast<uint8_t>(i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15);
        } else {  // FSE-compressed weights, two interleaved states
            used = 1 + hb;
            if (used > n || hb == 0) throw Damaged();
            Fse t;
            int64_t desc = t.read(src + 1, hb, 6, 255);
            if (desc >= hb) throw Damaged();
            Backward b(src + 1 + desc, hb - desc);
            uint32_t s1 = t.init(b), s2 = t.init(b);
            for (;;) {
                if (nw >= 255) throw Damaged();
                w[nw++] = t.sym[s1];
                s1 = t.update(s1, b);
                if (b.pos < 0) {
                    w[nw++] = t.sym[s2];
                    break;
                }
                if (nw >= 255) throw Damaged();
                w[nw++] = t.sym[s2];
                s2 = t.update(s2, b);
                if (b.pos < 0) {
                    if (nw >= 255) throw Damaged();
                    w[nw++] = t.sym[s1];
                    break;
                }
            }
        }
        // the last weight completes the sum to a power of 2
        uint32_t total = 0;
        for (int i = 0; i < nw; ++i) {
            if (w[i] > 11) throw Damaged();
            if (w[i]) total += 1u << (w[i] - 1);
        }
        if (total == 0) throw Damaged();
        max_bits = hsb(total) + 1;
        const uint32_t left = (1u << max_bits) - total;
        if (left & (left - 1)) throw Damaged();
        w[nw++] = static_cast<uint8_t>(hsb(left) + 1);
        if (max_bits > 11) throw Damaged();
        // codes by weight, lowest first; within a weight in symbol order
        const int size = 1 << max_bits;
        sym.assign(size, 0);
        bits.assign(size, 0);
        int count[13] = {0};
        uint8_t nb[256];
        for (int i = 0; i < nw; ++i) {
            nb[i] = static_cast<uint8_t>(w[i] ? max_bits + 1 - w[i] : 0);
            count[nb[i]]++;
        }
        uint32_t start[13];
        start[max_bits] = 0;
        for (int b = max_bits; b >= 1; --b) start[b - 1] = start[b] + count[b] * (1u << (max_bits - b));
        if (start[0] != static_cast<uint32_t>(size)) throw Damaged();
        for (int i = 0; i < nw; ++i) {
            if (!nb[i]) continue;
            const uint32_t len = 1u << (max_bits - nb[i]);
            for (uint32_t k = 0; k < len; ++k) {
                sym[start[nb[i]] + k] = static_cast<uint8_t>(i);
                bits[start[nb[i]] + k] = nb[i];
            }
            start[nb[i]] += len;
        }
        return used;
    }

    void stream(const uint8_t* src, int64_t n, uint8_t* out, int64_t count) const {
        Backward b(src, n);
        const uint32_t mask = (1u << max_bits) - 1;
        uint32_t state = static_cast<uint32_t>(b.read(max_bits));
        for (int64_t i = 0; i < count; ++i) {
            out[i] = sym[state];
            const int k = bits[state];
            state = ((state << k) + static_cast<uint32_t>(b.read(k))) & mask;
        }
        if (b.pos != -max_bits) throw Damaged();
    }
};

// ---- sequences --------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,  16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,  30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,  83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};

struct Frame {
    uint8_t* dst;
    int64_t cap, out = 0, frame_start = 0, window = 0;
    bool huf_ok = false;
    Huffman huf;
    Fse ll, of, ml;
    bool ll_ok = false, of_ok = false, ml_ok = false;
    uint32_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lit;

    void put(const uint8_t* s, int64_t k) {
        if (k > cap - out) {
            std::memcpy(dst + out, s, static_cast<size_t>(cap - out));
            out = cap;
            throw Full();
        }
        std::memcpy(dst + out, s, static_cast<size_t>(k));
        out += k;
    }
    void fill(uint8_t v, int64_t k) {
        const bool cut = k > cap - out;
        const int64_t n = cut ? cap - out : k;
        std::memset(dst + out, v, static_cast<size_t>(n));
        out += n;
        if (cut) throw Full();
    }
    void match(uint32_t offset, int64_t k) {
        if (offset == 0 || offset > out - frame_start || (window && offset > window))
            throw Damaged();
        const bool cut = k > cap - out;
        const int64_t n = cut ? cap - out : k;
        uint8_t* d = dst + out;
        if (offset >= n) {
            std::memcpy(d, d - offset, static_cast<size_t>(n));
        } else {  // the match overlaps what it writes: byte by byte
            for (int64_t i = 0; i < n; ++i) d[i] = d[i - static_cast<int64_t>(offset)];
        }
        out += n;
        if (cut) throw Full();
    }

    int64_t literals(const uint8_t* s, int64_t n) {
        if (n < 1) throw Damaged();
        const int type = s[0] & 3, fmt = (s[0] >> 2) & 3;
        int64_t regen, comp = 0, head;
        if (type < 2) {
            if (fmt == 0 || fmt == 2) {
                regen = s[0] >> 3;
                head = 1;
            } else if (fmt == 1) {
                if (n < 2) throw Damaged();
                regen = (s[0] >> 4) | (s[1] << 4);
                head = 2;
            } else {
                if (n < 3) throw Damaged();
                regen = (s[0] >> 4) | (s[1] << 4) | (static_cast<int64_t>(s[2]) << 12);
                head = 3;
            }
            lit.resize(static_cast<size_t>(regen));
            if (type == 0) {
                if (head + regen > n) throw Damaged();
                if (regen) std::memcpy(lit.data(), s + head, static_cast<size_t>(regen));
                return head + regen;
            }
            if (head + 1 > n) throw Damaged();
            if (regen) std::memset(lit.data(), s[head], static_cast<size_t>(regen));
            return head + 1;
        }
        int streams = fmt == 0 ? 1 : 4;
        if (fmt < 2) {
            if (n < 3) throw Damaged();
            regen = (s[0] >> 4) | ((s[1] & 0x3F) << 4);
            comp = (s[1] >> 6) | (s[2] << 2);
            head = 3;
        } else if (fmt == 2) {
            if (n < 4) throw Damaged();
            regen = (s[0] >> 4) | (s[1] << 4) | ((s[2] & 3) << 12);
            comp = (s[2] >> 2) | (s[3] << 6);
            head = 4;
        } else {
            if (n < 5) throw Damaged();
            regen = (s[0] >> 4) | (s[1] << 4) | ((s[2] & 0x3F) << 12);
            comp = (s[2] >> 6) | (s[3] << 2) | (static_cast<int64_t>(s[4]) << 10);
            head = 5;
        }
        if (head + comp > n) throw Damaged();
        const uint8_t* p = s + head;
        int64_t left = comp;
        if (type == 2) {
            int64_t t = huf.read(p, left);
            huf_ok = true;
            p += t;
            left -= t;
        } else if (!huf_ok) {
            throw Damaged();
        }
        lit.resize(static_cast<size_t>(regen));
        if (streams == 1) {
            huf.stream(p, left, lit.data(), regen);
        } else {
            if (left < 6) throw Damaged();
            int64_t sz[4] = {p[0] | (p[1] << 8), p[2] | (p[3] << 8), p[4] | (p[5] << 8), 0};
            sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
            if (sz[3] < 0) throw Damaged();
            const int64_t seg = (regen + 3) / 4;
            if (3 * seg > regen) throw Damaged();
            const uint8_t* q = p + 6;
            for (int i = 0; i < 4; ++i) {
                huf.stream(q, sz[i], lit.data() + i * seg, i < 3 ? seg : regen - 3 * seg);
                q += sz[i];
            }
        }
        return head + comp;
    }

    int64_t table(Fse& t, bool& ok, int mode, const uint8_t* s, int64_t n,
                  const int16_t* def, int ndef, int def_log, int max_log, int max_sym) {
        if (mode == 0) {
            t.build(def, ndef, def_log);
            ok = true;
            return 0;
        }
        if (mode == 1) {
            if (n < 1 || s[0] > max_sym) throw Damaged();
            t.rle(s[0]);
            ok = true;
            return 1;
        }
        if (mode == 2) {
            int64_t used = t.read(s, n, max_log, max_sym);
            ok = true;
            return used;
        }
        if (!ok) throw Damaged();
        return 0;
    }

    void block(const uint8_t* s, int64_t n) {
        int64_t used = literals(s, n);
        const uint8_t* p = s + used;
        int64_t left = n - used;
        if (left < 1) throw Damaged();
        int64_t nseq = p[0];
        int64_t h = 1;
        if (nseq >= 128) {
            if (nseq == 255) {
                if (left < 3) throw Damaged();
                nseq = p[1] + (p[2] << 8) + 0x7F00;
                h = 3;
            } else {
                if (left < 2) throw Damaged();
                nseq = ((nseq - 128) << 8) + p[1];
                h = 2;
            }
        }
        p += h;
        left -= h;
        int64_t lpos = 0;
        if (nseq > 0) {
            if (left < 1) throw Damaged();
            const int modes = p[0];
            if (modes & 3) throw Damaged();
            ++p;
            --left;
            int64_t k = table(ll, ll_ok, modes >> 6, p, left, kLLDefault, 36, 6, 9, 35);
            p += k;
            left -= k;
            k = table(of, of_ok, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, 8, 31);
            p += k;
            left -= k;
            k = table(ml, ml_ok, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, 9, 52);
            p += k;
            left -= k;
            if (left < 1) throw Damaged();
            Backward b(p, left);
            uint32_t sl = ll.init(b), so = of.init(b), sm = ml.init(b);
            for (int64_t i = 0; i < nseq; ++i) {
                const int oc = of.sym[so], mc = ml.sym[sm], lc = ll.sym[sl];
                if (oc > 31 || mc > 52 || lc > 35) throw Damaged();
                uint32_t ofv = (1u << oc) + static_cast<uint32_t>(b.read(oc));
                const int64_t mlen = kMLBase[mc] + b.read(kMLBits[mc]);
                const int64_t llen = kLLBase[lc] + b.read(kLLBits[lc]);
                uint32_t offset;
                if (ofv > 3) {
                    offset = ofv - 3;
                    rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                } else {
                    const uint32_t idx = ofv + (llen == 0 ? 1 : 0);
                    if (idx == 1) {
                        offset = rep[0];
                    } else if (idx == 2) {
                        offset = rep[1];
                        rep[1] = rep[0];
                        rep[0] = offset;
                    } else {
                        offset = idx == 3 ? rep[2] : rep[0] - 1;
                        rep[2] = rep[1];
                        rep[1] = rep[0];
                        rep[0] = offset;
                    }
                }
                if (i + 1 < nseq) {
                    sl = ll.update(sl, b);
                    sm = ml.update(sm, b);
                    so = of.update(so, b);
                }
                if (llen > static_cast<int64_t>(lit.size()) - lpos) throw Damaged();
                put(lit.data() + lpos, llen);
                lpos += llen;
                match(offset, mlen);
            }
            if (b.pos != 0) throw Damaged();
        } else if (left != 0) {
            throw Damaged();
        }
        put(lit.data() + lpos, static_cast<int64_t>(lit.size()) - lpos);
    }
};

// XXH64 with seed 0
uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
               P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
               P5 = 2870177450012600261ull;
uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}
uint64_t round64(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
uint64_t xxh64(const uint8_t* p, int64_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        while (end - p >= 32) {
            v1 = round64(v1, rd64(p));
            v2 = round64(v2, rd64(p + 8));
            v3 = round64(v3, rd64(p + 16));
            v4 = round64(v4, rd64(p + 24));
            p += 32;
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round64(0, v)) * P1 + P4;
    } else {
        h = P5;
    }
    h += static_cast<uint64_t>(n);
    while (end - p >= 8) {
        h ^= round64(0, rd64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        uint32_t v;
        std::memcpy(&v, p, 4);
        h ^= static_cast<uint64_t>(v) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p++) * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

uint32_t rd32(const uint8_t* p) {
    return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" int64_t zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t pos = 0, out = 0;
    try {
        while (pos < n && out < cap) {
            if (n - pos < 4) throw Damaged();
            const uint32_t magic = rd32(src + pos);
            if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // a skippable frame
                if (n - pos < 8) throw Damaged();
                pos += 8 + static_cast<int64_t>(rd32(src + pos + 4));
                continue;
            }
            if (magic != 0xFD2FB528u) throw Damaged();
            pos += 4;
            if (pos >= n) throw Damaged();
            const int fd = src[pos++];
            const int fcs_flag = fd >> 6, single = (fd >> 5) & 1, checksum = (fd >> 2) & 1,
                      did_flag = fd & 3;
            if (fd & 8) throw Damaged();
            Frame f;
            f.dst = dst;
            f.cap = cap;
            f.out = f.frame_start = out;
            if (!single) {
                if (pos >= n) throw Damaged();
                const int wd = src[pos++];
                const int64_t wbase = 1ll << (10 + (wd >> 3));
                f.window = wbase + (wbase / 8) * (wd & 7);
            }
            const int did_size[4] = {0, 1, 2, 4};
            uint32_t did = 0;
            for (int i = 0; i < did_size[did_flag]; ++i) {
                if (pos >= n) throw Damaged();
                did |= static_cast<uint32_t>(src[pos++]) << (8 * i);
            }
            if (did) throw Dictionary();
            const int fcs_size[4] = {single ? 1 : 0, 2, 4, 8};
            pos += fcs_size[fcs_flag];
            const int64_t block_max = f.window && f.window < (128 << 10) ? f.window : (128 << 10);
            bool full = false;
            for (bool last = false; !last;) {
                if (n - pos < 3) throw Damaged();
                const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
                pos += 3;
                last = bh & 1;
                const int type = (bh >> 1) & 3;
                const int64_t size = bh >> 3;
                try {
                    if (type == 0) {
                        if (size > n - pos || size > block_max) throw Damaged();
                        f.put(src + pos, size);
                        pos += size;
                    } else if (type == 1) {
                        if (pos >= n || size > block_max) throw Damaged();
                        f.fill(src[pos], size);
                        pos += 1;
                    } else if (type == 2) {
                        if (size > n - pos || size > block_max) throw Damaged();
                        f.block(src + pos, size);
                        pos += size;
                    } else {
                        throw Damaged();
                    }
                } catch (const Full&) {
                    full = true;
                    break;
                }
            }
            out = f.out;
            if (full) return out;
            if (checksum) {
                if (n - pos < 4) throw Damaged();
                const uint64_t h = xxh64(dst + f.frame_start, out - f.frame_start);
                if (static_cast<uint32_t>(h) != rd32(src + pos)) throw Damaged();
                pos += 4;
            }
        }
        return out;
    } catch (const Dictionary&) {
        return -2;
    } catch (const Damaged&) {
        return -1;
    } catch (const std::exception&) {
        return -1;
    }
}
