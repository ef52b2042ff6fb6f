// A JPEG 2000 Part 1 decoder for data/jpeg2000.py: the codestream that PIL
// and cv2 read through OpenJPEG, decoded to the samples OpenJPEG's decoder
// gives, written from ITU-T T.800 and following OpenJPEG's j2k.c (marker
// segments, tile-parts), tcd.c (the tile, resolution, band, precinct and
// code-block geometry of B.5-B.7, band stepsizes), pi.c (the five
// progression orders), t2.c and bio.c (packet headers with their tag trees,
// coding-pass and length codewords, SOP and EPH), t1.c and mqc.c (the MQ
// decoder, the significance, refinement and cleanup passes with OpenJPEG's
// flag words and context tables, reconstruction at the midpoint of what a
// block's passes left), dwt.c (the 5/3 inverse in integers and the 9/7
// inverse in float32 with OpenJPEG's lifting constants, K and 2/K scaling),
// and mct.c (the RCT and the ICT), then the DC level shift with round-half-
// to-even and clamping to the precision.  The JP2 boxes and each reader's
// rules are data/jpeg2000.py's.
//
// The float operations of the 9/7 transform, the dequantisation and the ICT
// are done in OpenJPEG's order, one rounding each; the library is built with
// -ffp-contract=off so that no compiler fuses them into FMA.
//
// Refused by name: code-block styles other than the default (BYPASS, RESET,
// TERMALL, VSC, PTERM, SEGSYM, HT), RGN, POC, PPM and PPT markers, HTJ2K
// and Part 2 markers and Rsiz bits, precisions above 16 bits, more than 4
// components, an MCT over components that differ; and what OpenJPEG
// refuses (a segment running past its tile's data, bit-planes from 31 up).
// Packets that start past the end of their tile's data, which no encoder
// writes and OpenJPEG reads as empty, are refused too, and so are images
// over 178956970 pixels (PIL's decompression-bomb limit) and tiles of more
// than 2^22 code-blocks, before their buffers are allocated.
//
// j2k_info reads the headers and every tile-part's markers without decoding;
// j2k_decode writes each component's samples as OpenJPEG's tile data holds
// them (one byte a sample up to 8 bits, else two; signed ones in two's
// complement) and, given ``stats``, what the stream used.  j2k_tables gives
// the constant tables for the tests to hold against the installed
// libopenjp2.  Each returns 0, or -1 with the reason in err.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

void set_error(char* err, int64_t cap, const char* what) {
    if (cap <= 0) return;
    std::strncpy(err, what, static_cast<size_t>(cap - 1));
    err[cap - 1] = 0;
}

template <typename... A>
[[noreturn]] void fail(const char* fmt, A... args) {
    char buf[256];
    std::snprintf(buf, sizeof buf, fmt, args...);
    throw Error(buf);
}

constexpr uint64_t kMaxPixels = 178956970;  // PIL's DecompressionBombError limit
constexpr uint64_t kMaxCblks = 1u << 22;    // code-blocks of one tile
constexpr uint64_t kMaxSteps = 1u << 27;    // progression iterations of one tile

// ----- tables -------------------------------------------------------------------

// T.800 Table C.2: the MQ coder's probability states
const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// OpenJPEG's mqc_states: entry 2k + mps is state k with that MPS
struct MqState {
    uint32_t qe, mps;
    const MqState* nmps;
    const MqState* nlps;
};

// OpenJPEG's flag word (t1.h): significance of a 3 x 6 window, the signs
// (CHI) of 6 rows, and the refined (MU) and visited (PI) bits of 4 rows
constexpr uint32_t SIGMA_0 = 1u << 0, SIGMA_1 = 1u << 1, SIGMA_2 = 1u << 2, SIGMA_3 = 1u << 3,
                   SIGMA_4 = 1u << 4, SIGMA_5 = 1u << 5, SIGMA_6 = 1u << 6, SIGMA_7 = 1u << 7,
                   SIGMA_8 = 1u << 8, SIGMA_10 = 1u << 10, SIGMA_13 = 1u << 13,
                   SIGMA_15 = 1u << 15, SIGMA_16 = 1u << 16, SIGMA_17 = 1u << 17;
constexpr uint32_t CHI_0_I = 18, CHI_1_I = 19, CHI_2_I = 22, CHI_5_I = 31;
constexpr uint32_t MU_0 = 1u << 20, PI_0 = 1u << 21, PI_1 = 1u << 24, PI_2 = 1u << 27,
                   PI_3 = 1u << 30;
constexpr uint32_t SIGMA_NEIGHBOURS =
    SIGMA_0 | SIGMA_1 | SIGMA_2 | SIGMA_3 | SIGMA_5 | SIGMA_6 | SIGMA_7 | SIGMA_8;
constexpr uint32_t PI_ALL = PI_0 | PI_1 | PI_2 | PI_3;
// the bits of a sign-context index (t1.h's T1_LUT_*)
constexpr uint32_t LUT_SGN_W = 1u << 0, LUT_SIG_N = 1u << 1, LUT_SGN_E = 1u << 2,
                   LUT_SIG_W = 1u << 3, LUT_SGN_N = 1u << 4, LUT_SIG_E = 1u << 5,
                   LUT_SGN_S = 1u << 6, LUT_SIG_S = 1u << 7;
// contexts (T.800 Table D.1 and D.3-D.5)
constexpr uint32_t CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19;

// the 9/7 lifting constants and scalings of OpenJPEG's dwt.c, and its ICT
const float kAlpha = 1.586134342f, kBeta = 0.052980118f, kGamma = -0.882911075f,
            kDelta = -0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;
const float kIctRv = 1.402f, kIctGu = 0.34413f, kIctGv = 0.71414f, kIctBu = 1.772f;

struct Tables {
    MqState states[94];
    uint8_t zc[4 * 512], sc[256], spb[256];

    Tables() {
        for (int k = 0; k < 47; ++k)
            for (int m = 0; m < 2; ++m) {
                MqState& s = states[2 * k + m];
                s.qe = kQe[k];
                s.mps = static_cast<uint32_t>(m);
                s.nmps = &states[2 * kNmps[k] + m];
                s.nlps = &states[2 * kNlps[k] + (m ^ kSwitch[k])];
            }
        for (uint32_t orient = 0; orient < 4; ++orient)
            for (uint32_t f = 0; f < 512; ++f) zc[(orient << 9) | f] = zc_context(f, orient);
        for (uint32_t f = 0; f < 256; ++f) {
            int hc, vc;
            sign_contributions(f, hc, vc);
            int h = hc, v = vc;
            if (h < 0) {
                h = -h;
                v = -v;
            }
            int n = h == 0 ? (v == 0 ? 0 : 1) : (v == -1 ? 2 : v == 0 ? 3 : 4);
            sc[f] = static_cast<uint8_t>(CTX_SC + n);
            spb[f] = (hc == 0 && vc == 0) ? 0 : !(hc > 0 || (hc == 0 && vc > 0));
        }
    }

    // t1_generate_luts.c's t1_init_ctxno_zc: the zero-coding context of a
    // neighbourhood in a band of orientation 0 (LL), 1 (HL), 2 (LH), 3 (HH)
    static uint8_t zc_context(uint32_t f, uint32_t orient) {
        int h = ((f & SIGMA_3) != 0) + ((f & SIGMA_5) != 0);
        int v = ((f & SIGMA_1) != 0) + ((f & SIGMA_7) != 0);
        int d = ((f & SIGMA_0) != 0) + ((f & SIGMA_2) != 0) + ((f & SIGMA_8) != 0) +
                ((f & SIGMA_6) != 0);
        int n = 0;
        if (orient == 1) std::swap(h, v);
        if (orient == 3) {
            int hv = h + v;
            if (d == 0)
                n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
            else if (d == 1)
                n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
            else if (d == 2)
                n = hv == 0 ? 6 : 7;
            else
                n = 8;
        } else if (h == 0) {
            n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
        } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
        } else {
            n = 8;
        }
        return static_cast<uint8_t>(n);
    }

    // the horizontal and vertical sign contributions of T.800 Table D.2
    static void sign_contributions(uint32_t f, int& hc, int& vc) {
        auto pos = [f](uint32_t sig, uint32_t sgn) { return (f & (sig | sgn)) == sig; };
        auto neg = [f](uint32_t sig, uint32_t sgn) { return (f & (sig | sgn)) == (sig | sgn); };
        hc = std::min(pos(LUT_SIG_E, LUT_SGN_E) + pos(LUT_SIG_W, LUT_SGN_W), 1) -
             std::min(neg(LUT_SIG_E, LUT_SGN_E) + neg(LUT_SIG_W, LUT_SGN_W), 1);
        vc = std::min(pos(LUT_SIG_N, LUT_SGN_N) + pos(LUT_SIG_S, LUT_SGN_S), 1) -
             std::min(neg(LUT_SIG_N, LUT_SGN_N) + neg(LUT_SIG_S, LUT_SGN_S), 1);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ----- integer helpers (OpenJPEG's opj_int_* on non-negative coordinates) --------

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, uint32_t b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, uint32_t b) { return a >> b; }
inline uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) {
        a >>= 1;
        ++l;
    }
    return l;
}
// two's-complement int32 arithmetic, as the hardware does OpenJPEG's
inline int32_t wadd(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t wsub(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// ----- the codestream's headers -----------------------------------------------------

struct Comp {
    uint32_t prec = 0, sgnd = 0, dx = 1, dy = 1;
};

struct StepSize {
    int32_t expn = 0, mant = 0;
};

struct Tccp {  // one component's coding and quantization parameters
    uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    uint32_t qntsty = 0, numgbits = 0, nsteps = 0;
    uint32_t prcw[33] = {}, prch[33] = {};
    StepSize steps[97];
};

struct Tcp {  // a tile's coding parameters
    uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
    std::vector<Tccp> tccps;
};

struct Reader {
    const uint8_t* p;
    size_t n, pos = 0;

    Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
    void need(size_t k) const {
        if (pos + k > n)
            fail("a marker segment runs past its end: the codestream is cut or damaged");
    }
    uint32_t u8() {
        need(1);
        return p[pos++];
    }
    uint32_t u16() {
        need(2);
        uint32_t v = uint32_t(p[pos]) << 8 | p[pos + 1];
        pos += 2;
        return v;
    }
    uint32_t u32() {
        uint32_t hi = u16();
        return hi << 16 | u16();
    }
};

const char* const kStyleNames[8] = {"BYPASS", "RESET", "TERMALL", "VSC",
                                    "PTERM",  "SEGSYM", "HT",    "HT mixed"};

struct Codestream {
    const uint8_t* src = nullptr;
    size_t n = 0;
    uint32_t rsiz = 0, x0 = 0, y0 = 0, x1 = 0, y1 = 0, tdx = 0, tdy = 0, tx0 = 0, ty0 = 0;
    uint32_t tw = 0, th = 0;
    std::vector<Comp> comps;
    Tcp def;
    std::vector<Tcp> tcps;
    // per tile: its tile-parts' data, and the count its SOT markers declare
    std::vector<std::vector<std::pair<size_t, size_t>>> parts;
    std::vector<uint32_t> declared;

    void parse(const uint8_t* s, size_t len) {
        src = s;
        n = len;
        Reader r(s, len);
        if (r.u16() != 0xFF4F) fail("not a JPEG 2000 codestream (no SOC marker)");
        if (r.u16() != 0xFF51) fail("a codestream whose first marker is not SIZ");
        read_siz(r);
        bool cod = false, qcd = false;
        for (;;) {
            uint32_t m = r.u16();
            if (m == 0xFF90) break;
            size_t end = segment(r, m);
            switch (m) {
                case 0xFF52:
                    read_cod(r, def, end);
                    cod = true;
                    break;
                case 0xFF53:
                    read_coc(r, def, end);
                    break;
                case 0xFF5C:
                    read_qcd(r, def, end);
                    qcd = true;
                    break;
                case 0xFF5D:
                    read_qcc(r, def, end);
                    break;
                case 0xFF64: case 0xFF55: case 0xFF57: case 0xFF63:  // COM, TLM, PLM, CRG
                    r.pos = end;
                    break;
                default:
                    refuse_marker(m, "main header");
            }
            if (r.pos != end) fail("a marker segment of another length than its contents");
        }
        if (!cod || !qcd) fail("a main header without its %s marker", cod ? "QCD" : "COD");
        tcps.assign(size_t(tw) * th, def);
        parts.assign(tcps.size(), {});
        declared.assign(tcps.size(), 0);
        read_tile_parts(r.pos - 2);
    }

    static size_t segment(Reader& r, uint32_t m) {
        if (m < 0xFF00) fail("a marker was expected and 0x%04x found", m);
        uint32_t len = r.u16();
        if (len < 2) fail("a marker segment of length %u", len);
        r.need(len - 2);
        return r.pos + len - 2;
    }

    [[noreturn]] static void refuse_marker(uint32_t m, const char* where) {
        switch (m) {
            case 0xFF5E:
                fail("an RGN marker (region of interest), which the port does not decode");
            case 0xFF5F:
                fail("a POC marker (progression order change), which the port does not decode");
            case 0xFF60:
                fail("a PPM marker (packed packet headers), which the port does not decode");
            case 0xFF61:
                fail("a PPT marker (packed packet headers), which the port does not decode");
            case 0xFF50: case 0xFF59:
                fail("an HTJ2K marker (CAP or CPF, Part 15), which the port does not decode");
            default:
                if (m >= 0xFF70 && m <= 0xFF7F)
                    fail("a Part 2 marker 0x%04x, which the port does not decode", m);
                fail("a marker 0x%04x in the %s, which the port does not read", m, where);
        }
    }

    void read_siz(Reader& r) {
        uint32_t len = r.u16();
        if (len < 41 || (len - 38) % 3) fail("a SIZ marker of length %u", len);
        rsiz = r.u16();
        if (rsiz & 0x8000)
            fail("a Part 2 codestream (Rsiz 0x%04x), which the port does not decode", rsiz);
        if (rsiz & 0x4000)
            fail("an HTJ2K codestream (Rsiz 0x%04x), which the port does not decode", rsiz);
        x1 = r.u32();
        y1 = r.u32();
        x0 = r.u32();
        y0 = r.u32();
        tdx = r.u32();
        tdy = r.u32();
        tx0 = r.u32();
        ty0 = r.u32();
        uint32_t csiz = r.u16();
        if (csiz != (len - 38) / 3)
            fail("a SIZ marker whose length disagrees with its %u components", csiz);
        if (csiz == 0) fail("a SIZ marker of no component");
        if (csiz > 4) fail("%u components (PIL and cv2 read at most 4)", csiz);
        if (x0 >= x1 || y0 >= y1) fail("an image of no area (SIZ %u..%u x %u..%u)", x0, x1, y0, y1);
        if (!tdx || !tdy) fail("tiles of no area");
        if (tx0 > x0 || ty0 > y0 || uint64_t(tx0) + tdx <= x0 || uint64_t(ty0) + tdy <= y0)
            fail("a tile grid offset past the image's origin");
        uint64_t area = uint64_t(x1 - x0) * (y1 - y0);
        if (area > kMaxPixels)
            fail("an image of %u x %u, over the %llu pixels the port reads (PIL's limit)",
                 x1 - x0, y1 - y0, static_cast<unsigned long long>(kMaxPixels));
        comps.resize(csiz);
        for (auto& c : comps) {
            uint32_t s = r.u8();
            c.prec = (s & 0x7F) + 1;
            c.sgnd = s >> 7;
            c.dx = r.u8();
            c.dy = r.u8();
            if (c.prec > 16) fail("%u-bit samples, which the port does not decode", c.prec);
            if (!c.dx || !c.dy) fail("a component subsampling of 0");
        }
        uint64_t tw64 = ceildiv(uint64_t(x1) - tx0, tdx), th64 = ceildiv(uint64_t(y1) - ty0, tdy);
        if (tw64 * th64 > 65535) fail("%llu x %llu tiles (T.800 allows 65535)",
                                      static_cast<unsigned long long>(tw64),
                                      static_cast<unsigned long long>(th64));
        tw = static_cast<uint32_t>(tw64);
        th = static_cast<uint32_t>(th64);
        def.tccps.assign(csiz, Tccp());
    }

    // SPcod / SPcoc into ``t``
    static void read_spcod(Reader& r, Tccp& t, size_t end) {
        t.numres = r.u8() + 1;
        if (t.numres > 33) fail("%u decomposition levels (T.800 allows 32)", t.numres - 1);
        t.cblkw = r.u8() + 2;
        t.cblkh = r.u8() + 2;
        if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
            fail("code-blocks of 2^%u x 2^%u", t.cblkw, t.cblkh);
        t.cblksty = r.u8();
        if (t.cblksty) {
            std::string names;
            for (int b = 0; b < 8; ++b)
                if (t.cblksty >> b & 1)
                    names += std::string(names.empty() ? "" : ", ") + kStyleNames[b];
            fail("code-block style %s, which the port does not decode", names.c_str());
        }
        t.qmfbid = r.u8();
        if (t.qmfbid > 1) fail("a wavelet transform %u", t.qmfbid);
        if (t.csty & 1) {
            if (end - r.pos < t.numres) fail("a COD or COC marker short of its precinct sizes");
            for (uint32_t i = 0; i < t.numres; ++i) {
                uint32_t v = r.u8();
                if (i && (!(v & 0xF) || !(v >> 4)))
                    fail("a precinct size of 2^0 above resolution 0");
                t.prcw[i] = v & 0xF;
                t.prch[i] = v >> 4;
            }
        } else {
            for (uint32_t i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
        }
    }

    static void read_cod(Reader& r, Tcp& tcp, size_t end) {
        tcp.csty = r.u8();
        if (tcp.csty & ~7u) fail("a COD coding style 0x%02x", tcp.csty);
        tcp.prg = r.u8();
        if (tcp.prg > 4) fail("progression order %u", tcp.prg);
        tcp.numlayers = r.u16();
        if (!tcp.numlayers) fail("a COD marker of no layer");
        tcp.mct = r.u8();
        if (tcp.mct > 1) fail("a multiple component transform %u", tcp.mct);
        for (auto& t : tcp.tccps) t.csty = tcp.csty & 1;
        read_spcod(r, tcp.tccps[0], end);
        for (size_t c = 1; c < tcp.tccps.size(); ++c) {
            Tccp& t = tcp.tccps[c];
            const Tccp& s = tcp.tccps[0];
            t.numres = s.numres;
            t.cblkw = s.cblkw;
            t.cblkh = s.cblkh;
            t.cblksty = s.cblksty;
            t.qmfbid = s.qmfbid;
            std::memcpy(t.prcw, s.prcw, sizeof t.prcw);
            std::memcpy(t.prch, s.prch, sizeof t.prch);
        }
    }

    uint32_t component_index(Reader& r) const {
        uint32_t c = comps.size() <= 256 ? r.u8() : r.u16();
        if (c >= comps.size()) fail("a COC or QCC marker of component %u", c);
        return c;
    }

    void read_coc(Reader& r, Tcp& tcp, size_t end) const {
        uint32_t c = component_index(r);
        tcp.tccps[c].csty = r.u8();
        if (tcp.tccps[c].csty & ~1u) fail("a COC coding style 0x%02x", tcp.tccps[c].csty);
        read_spcod(r, tcp.tccps[c], end);
    }

    static void read_sqcd(Reader& r, Tccp& t, size_t end) {
        uint32_t v = r.u8();
        t.qntsty = v & 0x1F;
        t.numgbits = v >> 5;
        if (t.qntsty > 2) fail("a quantization style %u", t.qntsty);
        size_t left = end - r.pos;
        size_t bands = t.qntsty == 1 ? 1 : t.qntsty == 0 ? left : left / 2;
        if (t.qntsty != 0 && left != bands * 2) fail("a QCD or QCC marker of an odd length");
        if (bands > 97) fail("%zu quantization step sizes (T.800 allows 97)", bands);
        for (size_t b = 0; b < bands; ++b) {
            if (t.qntsty == 0) {
                t.steps[b].expn = static_cast<int32_t>(r.u8() >> 3);
                t.steps[b].mant = 0;
            } else {
                uint32_t s = r.u16();
                t.steps[b].expn = static_cast<int32_t>(s >> 11);
                t.steps[b].mant = static_cast<int32_t>(s & 0x7FF);
            }
        }
        if (t.qntsty == 1)  // scalar derived: E.1, equation E-5
            for (int b = 1; b < 97; ++b) {
                t.steps[b].expn = std::max(t.steps[0].expn - (b - 1) / 3, 0);
                t.steps[b].mant = t.steps[0].mant;
            }
        t.nsteps = t.qntsty == 1 ? 97 : uint32_t(bands);
    }

    static void read_qcd(Reader& r, Tcp& tcp, size_t end) {
        read_sqcd(r, tcp.tccps[0], end);
        for (size_t c = 1; c < tcp.tccps.size(); ++c) {
            Tccp& t = tcp.tccps[c];
            t.qntsty = tcp.tccps[0].qntsty;
            t.numgbits = tcp.tccps[0].numgbits;
            t.nsteps = tcp.tccps[0].nsteps;
            std::memcpy(t.steps, tcp.tccps[0].steps, sizeof t.steps);
        }
    }

    void read_qcc(Reader& r, Tcp& tcp, size_t end) const {
        uint32_t c = component_index(r);
        read_sqcd(r, tcp.tccps[c], end);
    }

    // the tile-parts from the first SOT at ``pos`` to EOC
    void read_tile_parts(size_t pos) {
        for (;;) {
            if (pos + 2 > n) fail("the codestream ends before its EOC marker: the file is cut");
            uint32_t m = uint32_t(src[pos]) << 8 | src[pos + 1];
            if (m == 0xFFD9) break;
            if (m != 0xFF90) fail("a marker 0x%04x where a tile-part or EOC was expected", m);
            Reader r(src, n);
            r.pos = pos + 2;
            if (r.u16() != 10) fail("an SOT marker of another length than 10");
            uint32_t tile = r.u16(), psot = r.u32(), part = r.u8(), nparts = r.u8();
            if (tile >= tcps.size()) fail("a tile-part of tile %u of %zu", tile, tcps.size());
            if (part != parts[tile].size())
                fail("tile %u's tile-part %u where %zu was expected", tile, part,
                     parts[tile].size());
            if (nparts) {
                if (declared[tile] && declared[tile] != nparts)
                    fail("tile %u's tile-parts declaring %u and %u parts", tile, declared[tile],
                         nparts);
                if (part >= nparts) fail("tile-part %u of a tile of %u", part, nparts);
                declared[tile] = nparts;
            }
            size_t end;
            if (psot == 0) {
                if (n < 2 || src[n - 2] != 0xFF || src[n - 1] != 0xD9)
                    fail("a last tile-part (Psot 0) not ended by EOC: the file is cut");
                end = n - 2;
            } else {
                if (psot < 14) fail("a tile-part of %u bytes", psot);
                if (pos + psot > n)
                    fail("a tile-part running past the codestream's end: the file is cut");
                end = pos + psot;
            }
            Reader h(src, end);
            h.pos = r.pos;
            Tcp& tcp = tcps[tile];
            for (;;) {
                uint32_t mk = h.u16();
                if (mk == 0xFF93) break;
                size_t seg_end = segment(h, mk);
                switch (mk) {
                    case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D:
                        if (part)
                            fail("a coding marker in tile-part %u (only the first may hold one)",
                                 part);
                        if (mk == 0xFF52) read_cod(h, tcp, seg_end);
                        else if (mk == 0xFF53) read_coc(h, tcp, seg_end);
                        else if (mk == 0xFF5C) read_qcd(h, tcp, seg_end);
                        else read_qcc(h, tcp, seg_end);
                        break;
                    case 0xFF58: case 0xFF64:  // PLT, COM
                        h.pos = seg_end;
                        break;
                    default:
                        refuse_marker(mk, "tile-part header");
                }
                if (h.pos != seg_end) fail("a marker segment of another length than its contents");
            }
            parts[tile].emplace_back(h.pos, end - h.pos);
            pos = end;
        }
        for (size_t t = 0; t < parts.size(); ++t) {
            if (parts[t].empty()) fail("no tile-part of tile %zu: the file is cut or damaged", t);
            if (declared[t] && parts[t].size() != declared[t])
                fail("tile %zu of %zu of its %u tile-parts: the file is cut", t, parts[t].size(),
                     declared[t]);
        }
    }

    // the image area of component c: (x0, y0, width, height)
    void comp_area(size_t c, int64_t* out) const {
        int64_t cx0 = ceildiv(x0, comps[c].dx), cy0 = ceildiv(y0, comps[c].dy);
        out[0] = cx0;
        out[1] = cy0;
        out[2] = ceildiv(x1, comps[c].dx) - cx0;
        out[3] = ceildiv(y1, comps[c].dy) - cy0;
    }
};

// ----- tile geometry (tcd.c's opj_tcd_init_tile) ------------------------------------

struct TagTree {  // tgt.c: leaves cw x ch, each level halved (rounded up)
    struct Node {
        int32_t value, low;
        int32_t parent;
    };
    std::vector<Node> nodes;

    void build(uint32_t w, uint32_t h) {
        nodes.clear();
        if (!w || !h) return;
        std::vector<std::pair<uint32_t, uint32_t>> levels;
        uint32_t lw = w, lh = h;
        size_t total = 0;
        for (;;) {
            levels.emplace_back(lw, lh);
            total += size_t(lw) * lh;
            if (lw * lh <= 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        nodes.resize(total);
        size_t base = 0;
        for (size_t l = 0; l < levels.size(); ++l) {
            uint32_t cw = levels[l].first, ch = levels[l].second;
            size_t up = base + size_t(cw) * ch;
            for (uint32_t j = 0; j < ch; ++j)
                for (uint32_t i = 0; i < cw; ++i)
                    nodes[base + size_t(j) * cw + i].parent =
                        l + 1 < levels.size()
                            ? static_cast<int32_t>(up + size_t(j / 2) * levels[l + 1].first + i / 2)
                            : -1;
            base = up;
        }
        reset();
    }
    void reset() {
        for (auto& nd : nodes) {
            nd.value = 999;
            nd.low = 0;
        }
    }
};

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
             newlen = 0;
};

struct Cblk {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    int32_t first_chunk = -1, last_chunk = -1;
    uint32_t layers = 0;
};

struct Chunk {
    size_t off, len;
    int32_t next;
};

struct Precinct {
    int32_t x0, y0, x1, y1;
    uint32_t cw, ch;
    size_t first;  // index of its first code-block in the tile's list
    TagTree incl, imsb;
};

struct Band {
    uint32_t bandno;
    int32_t x0, y0, x1, y1;
    float stepsize;
    int32_t numbps;
    std::vector<Precinct> precincts;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
    int32_t x0, y0, x1, y1;
    uint32_t pw, ph, pdx, pdy, numbands;
    Band bands[3];
};

struct TileComp {
    int32_t x0, y0, x1, y1;
    uint32_t numres;
    std::vector<Resolution> res;
    std::vector<int32_t> idata;  // reversible
    std::vector<float> fdata;    // irreversible
    uint32_t width() const { return static_cast<uint32_t>(x1 - x0); }
    uint32_t height() const { return static_cast<uint32_t>(y1 - y0); }
};

// ----- the MQ decoder (mqc.c, mqc_inl.h) --------------------------------------------

struct Mqc {
    const uint8_t* bp;
    uint32_t a, c, ct;
    const MqState* ctx[NUM_CTX];

    void reset_states() {
        const Tables& t = tables();
        for (auto& s : ctx) s = &t.states[0];
        ctx[CTX_UNI] = &t.states[46 * 2];
        ctx[CTX_AGG] = &t.states[3 * 2];
        ctx[0] = &t.states[4 * 2];
    }
    // INITDEC over ``len`` bytes followed by OpenJPEG's artificial 0xFF 0xFF
    void init(const uint8_t* data, uint32_t len) {
        bp = data;
        c = len == 0 ? 0xFFu << 16 : uint32_t(data[0]) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void bytein() {
        if (bp[0] == 0xFF) {
            if (bp[1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += uint32_t(bp[0]) << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += uint32_t(bp[0]) << 8;
            ct = 8;
        }
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    uint32_t decode(uint32_t cx) {
        const MqState*& s = ctx[cx];
        uint32_t d;
        a -= s->qe;
        if ((c >> 16) < s->qe) {
            if (a < s->qe) {
                a = s->qe;
                d = s->mps;
                s = s->nmps;
            } else {
                a = s->qe;
                d = !s->mps;
                s = s->nlps;
            }
            renorm();
        } else {
            c -= s->qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s->qe) {
                    d = !s->mps;
                    s = s->nlps;
                } else {
                    d = s->mps;
                    s = s->nmps;
                }
                renorm();
            } else {
                d = s->mps;
            }
        }
        return d;
    }
};

// ----- tier 1 (t1.c's decoder) ------------------------------------------------------

struct T1 {
    uint32_t w = 0, h = 0;
    std::vector<int32_t> data;
    std::vector<uint32_t> flags;
    const uint8_t* zc = nullptr;
    Mqc mqc;
    int64_t run_modes = 0;

    void allocate(uint32_t w_, uint32_t h_) {
        w = w_;
        h = h_;
        data.assign(size_t(w) * h, 0);
        uint32_t stride = w + 2, fh = (h + 3) / 4;
        flags.assign(size_t(stride) * (fh + 2), 0);
        for (uint32_t x = 0; x < stride; ++x) {
            flags[x] = PI_ALL;
            flags[size_t(fh + 1) * stride + x] = PI_ALL;
        }
        if (h % 4) {
            uint32_t v = h % 4 == 1 ? PI_1 | PI_2 | PI_3 : h % 4 == 2 ? PI_2 | PI_3 : PI_3;
            for (uint32_t x = 0; x < stride; ++x) flags[size_t(fh) * stride + x] = v;
        }
    }

    static uint32_t sc_index(uint32_t fx, uint32_t pfx, uint32_t nfx, uint32_t ci) {
        uint32_t lu = (fx >> (ci * 3)) & (SIGMA_1 | SIGMA_3 | SIGMA_5 | SIGMA_7);
        lu |= (pfx >> (CHI_1_I + ci * 3)) & (1u << 0);
        lu |= (nfx >> (CHI_1_I - 2 + ci * 3)) & (1u << 2);
        if (ci == 0)
            lu |= (fx >> (CHI_0_I - 4)) & (1u << 4);
        else
            lu |= (fx >> (CHI_1_I - 4 + (ci - 1) * 3)) & (1u << 4);
        lu |= (fx >> (CHI_2_I - 6 + ci * 3)) & (1u << 6);
        return lu;
    }

    static void update_flags(uint32_t& fl, uint32_t* fp, uint32_t ci, uint32_t s, uint32_t stride) {
        fp[-1] |= SIGMA_5 << (3 * ci);
        fl |= ((s << CHI_1_I) | SIGMA_4) << (3 * ci);
        fp[1] |= SIGMA_3 << (3 * ci);
        if (ci == 0) {
            uint32_t* north = fp - stride;
            *north |= (s << CHI_5_I) | SIGMA_16;
            north[-1] |= SIGMA_17;
            north[1] |= SIGMA_15;
        }
        if (ci == 3) {
            uint32_t* south = fp + stride;
            *south |= (s << CHI_0_I) | SIGMA_1;
            south[-1] |= SIGMA_2;
            south[1] |= SIGMA_0;
        }
    }

    void sign(uint32_t& fl, uint32_t* fp, int32_t* dp, uint32_t ci, int32_t oph) {
        const Tables& t = tables();
        uint32_t lu = sc_index(fl, fp[-1], fp[1], ci);
        uint32_t v = mqc.decode(t.sc[lu]) ^ t.spb[lu];
        *dp = v ? -oph : oph;
        update_flags(fl, fp, ci, v, w + 2);
    }

    void sig_step(uint32_t& fl, uint32_t* fp, int32_t* dp, uint32_t ci, int32_t oph) {
        if ((fl & ((SIGMA_4 | PI_0) << (ci * 3))) == 0 &&
            (fl & (SIGMA_NEIGHBOURS << (ci * 3))) != 0) {
            if (mqc.decode(zc[(fl >> (ci * 3)) & SIGMA_NEIGHBOURS])) sign(fl, fp, dp, ci, oph);
            fl |= PI_0 << (ci * 3);
        }
    }

    void ref_step(uint32_t& fl, int32_t* dp, uint32_t ci, int32_t poshalf) {
        if ((fl & ((SIGMA_4 | PI_0) << (ci * 3))) == (SIGMA_4 << (ci * 3))) {
            uint32_t f = fl >> (ci * 3);
            uint32_t cx = (f & MU_0) ? CTX_MAG + 2 : (f & SIGMA_NEIGHBOURS) ? CTX_MAG + 1 : CTX_MAG;
            uint32_t v = mqc.decode(cx);
            *dp = wadd(*dp, (v ^ (*dp < 0)) ? poshalf : -poshalf);
            fl |= MU_0 << (ci * 3);
        }
    }

    void cln_step(bool check, bool partial, uint32_t& fl, uint32_t* fp, int32_t* dp, uint32_t ci,
                  int32_t oph) {
        if (check && (fl & ((SIGMA_4 | PI_0) << (ci * 3)))) return;
        if (!partial && !mqc.decode(zc[(fl >> (ci * 3)) & SIGMA_NEIGHBOURS])) return;
        sign(fl, fp, dp, ci, oph);
    }

    void sigpass(int32_t bpno) {
        int32_t one = 1 << bpno, oph = one | (one >> 1);
        uint32_t stride = w + 2, k;
        int32_t* dp = data.data();
        uint32_t* fp = &flags[stride + 1];
        for (k = 0; k < (h & ~3u); k += 4, dp += 3 * w, fp += 2)
            for (uint32_t i = 0; i < w; ++i, ++dp, ++fp) {
                uint32_t fl = *fp;
                if (!fl) continue;
                for (uint32_t ci = 0; ci < 4; ++ci) sig_step(fl, fp, dp + ci * w, ci, oph);
                *fp = fl;
            }
        if (k < h)
            for (uint32_t i = 0; i < w; ++i, ++dp, ++fp)
                for (uint32_t j = 0; j < h - k; ++j) sig_step(*fp, fp, dp + j * w, j, oph);
    }

    void refpass(int32_t bpno) {
        int32_t poshalf = (1 << bpno) >> 1;
        uint32_t stride = w + 2, k;
        int32_t* dp = data.data();
        uint32_t* fp = &flags[stride + 1];
        for (k = 0; k < (h & ~3u); k += 4, dp += 3 * w, fp += 2)
            for (uint32_t i = 0; i < w; ++i, ++dp, ++fp) {
                uint32_t fl = *fp;
                if (!(fl & (SIGMA_4 | SIGMA_7 | SIGMA_10 | SIGMA_13))) continue;
                for (uint32_t ci = 0; ci < 4; ++ci) ref_step(fl, dp + ci * w, ci, poshalf);
                *fp = fl;
            }
        if (k < h)
            for (uint32_t i = 0; i < w; ++i, ++dp, ++fp)
                for (uint32_t j = 0; j < h - k; ++j) ref_step(*fp, dp + j * w, j, poshalf);
    }

    void clnpass(int32_t bpno) {
        int32_t one = 1 << bpno, oph = one | (one >> 1);
        uint32_t stride = w + 2, k;
        int32_t* dp = data.data();
        uint32_t* fp = &flags[stride + 1];
        for (k = 0; k < (h & ~3u); k += 4, dp += 3 * w, fp += 2)
            for (uint32_t i = 0; i < w; ++i, ++dp, ++fp) {
                uint32_t fl = *fp;
                if (fl == 0) {  // run mode
                    ++run_modes;
                    if (!mqc.decode(CTX_AGG)) continue;
                    uint32_t run = mqc.decode(CTX_UNI);
                    run = (run << 1) | mqc.decode(CTX_UNI);
                    for (uint32_t ci = run; ci < 4; ++ci)
                        cln_step(false, ci == run, fl, fp, dp + ci * w, ci, oph);
                } else {
                    for (uint32_t ci = 0; ci < 4; ++ci)
                        cln_step(true, false, fl, fp, dp + ci * w, ci, oph);
                }
                *fp = fl & ~PI_ALL;
            }
        if (k < h)
            for (uint32_t i = 0; i < w; ++i, ++fp, ++dp) {
                for (uint32_t j = 0; j < h - k; ++j)
                    cln_step(true, false, *fp, fp, dp + j * w, j, oph);
                *fp &= ~PI_ALL;
            }
    }
};

// ----- the inverse wavelet transforms (dwt.c) -----------------------------------------

// one row or column of the 5/3 inverse: ``x`` holds sn low then dn high
// coefficients; opj_idwt53_h's cases, written back in place
void idwt53_1d(int32_t* x, size_t stride, int32_t sn, int32_t dn, int32_t cas,
               std::vector<int32_t>& tmp) {
    int32_t len = sn + dn;
    auto at = [&](int32_t i) -> int32_t& { return x[size_t(i) * stride]; };
    if (cas == 0) {
        if (len <= 1) return;
        tmp.resize(size_t(len));
        // in_even = low (x[0..sn)), in_odd = high (x[sn..))
        int32_t s1n = at(0), d1n = at(sn), s0n = wsub(s1n, (wadd(d1n, 1)) >> 1), d1c, s0c;
        int32_t i = 0, j = 1;
        for (; i < len - 3; i += 2, ++j) {
            d1c = d1n;
            s0c = s0n;
            s1n = at(j);
            d1n = at(sn + j);
            s0n = wsub(s1n, wadd(wadd(d1c, d1n), 2) >> 2);
            tmp[size_t(i)] = s0c;
            tmp[size_t(i) + 1] = wadd(d1c, wadd(s0c, s0n) >> 1);
        }
        tmp[size_t(i)] = s0n;
        if (len & 1) {
            tmp[size_t(len) - 1] = wsub(at((len - 1) / 2), wadd(d1n, 1) >> 1);
            tmp[size_t(len) - 2] = wadd(d1n, wadd(s0n, tmp[size_t(len) - 1]) >> 1);
        } else {
            tmp[size_t(len) - 1] = wadd(d1n, s0n);
        }
    } else {
        if (len == 1) {
            at(0) /= 2;
            return;
        }
        if (len == 0) return;
        tmp.resize(size_t(len));
        if (len == 2) {  // in_odd = low x[0], in_even = high x[sn]
            tmp[1] = wsub(at(0), wadd(at(sn), 1) >> 1);
            tmp[0] = wadd(at(sn), tmp[1]);
        } else {
            // in_even = high (x[sn..)), in_odd = low (x[0..sn))
            int32_t s1 = at(sn + 1), dc = wsub(at(0), wadd(wadd(at(sn), s1), 2) >> 2), s2, dnv;
            tmp[0] = wadd(at(sn), dc);
            int32_t i = 1, j = 1;
            for (; i < len - 2 - !(len & 1); i += 2, ++j) {
                s2 = at(sn + j + 1);
                dnv = wsub(at(j), wadd(wadd(s1, s2), 2) >> 2);
                tmp[size_t(i)] = dc;
                tmp[size_t(i) + 1] = wadd(s1, wadd(dnv, dc) >> 1);
                dc = dnv;
                s1 = s2;
            }
            tmp[size_t(i)] = dc;
            if (!(len & 1)) {
                dnv = wsub(at(len / 2 - 1), wadd(s1, 1) >> 1);
                tmp[size_t(len) - 2] = wadd(s1, wadd(dnv, dc) >> 1);
                tmp[size_t(len) - 1] = dnv;
            } else {
                tmp[size_t(len) - 1] = wadd(s1, dc);
            }
        }
    }
    for (int32_t i = 0; i < len; ++i) at(i) = tmp[size_t(i)];
}

// opj_v8dwt_decode_step1: every other sample from ``w`` scaled by c
void dwt97_step1(float* w, uint32_t end, float c) {
    for (uint32_t i = 0; i < end; ++i) w[2 * i] = w[2 * i] * c;
}

// opj_v8dwt_decode_step2: w[2i - 1] += (l + w[2i]) c, the last with 2c
void dwt97_step2(float* l, float* w, uint32_t end, uint32_t m, float c) {
    uint32_t imax = std::min(end, m);
    float* fl = l;
    float* fw = w;
    for (uint32_t i = 0; i < imax; ++i) {
        fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
        fl = fw;
        fw += 2;
    }
    if (m < end) {
        float c2 = c + c;
        fw[-1] = fw[-1] + fl[0] * c2;
    }
}

void idwt97_1d(float* x, size_t stride, int32_t sn, int32_t dn, int32_t cas,
               std::vector<float>& wv) {
    int32_t len = sn + dn;
    wv.assign(size_t(len) + 2, 0.0f);
    for (int32_t i = 0; i < sn; ++i) wv[size_t(cas + 2 * i)] = x[size_t(i) * stride];
    for (int32_t i = 0; i < dn; ++i) wv[size_t(1 - cas + 2 * i)] = x[size_t(sn + i) * stride];
    int32_t a, b;
    bool run;
    if (cas == 0) {
        run = dn > 0 || sn > 1;
        a = 0;
        b = 1;
    } else {
        run = sn > 0 || dn > 1;
        a = 1;
        b = 0;
    }
    if (run) {
        float* w = wv.data();
        dwt97_step1(w + a, uint32_t(sn), kK);
        dwt97_step1(w + b, uint32_t(dn), kTwoInvK);
        dwt97_step2(w + b, w + a + 1, uint32_t(sn), uint32_t(std::min(sn, dn - a)), kDelta);
        dwt97_step2(w + a, w + b + 1, uint32_t(dn), uint32_t(std::min(dn, sn - b)), kGamma);
        dwt97_step2(w + b, w + a + 1, uint32_t(sn), uint32_t(std::min(sn, dn - a)), kBeta);
        dwt97_step2(w + a, w + b + 1, uint32_t(dn), uint32_t(std::min(dn, sn - b)), kAlpha);
    }
    for (int32_t i = 0; i < len; ++i) x[size_t(i) * stride] = wv[size_t(i)];
}

// opj_dwt_decode_tile / opj_dwt_decode_tile_97: every level, rows then columns
void inverse_dwt(TileComp& tc, bool reversible) {
    uint32_t w = tc.width();
    if (tc.numres <= 1 || w == 0) return;
    std::vector<int32_t> itmp;
    std::vector<float> ftmp;
    const Resolution* tr = &tc.res[0];
    uint32_t rw = uint32_t(tr->x1 - tr->x0), rh = uint32_t(tr->y1 - tr->y0);
    for (uint32_t r = 1; r < tc.numres; ++r) {
        int32_t hsn = int32_t(rw), vsn = int32_t(rh);
        ++tr;
        rw = uint32_t(tr->x1 - tr->x0);
        rh = uint32_t(tr->y1 - tr->y0);
        int32_t hdn = int32_t(rw) - hsn, hcas = tr->x0 % 2;
        int32_t vdn = int32_t(rh) - vsn, vcas = tr->y0 % 2;
        for (uint32_t j = 0; j < rh; ++j) {
            if (reversible)
                idwt53_1d(&tc.idata[size_t(j) * w], 1, hsn, hdn, hcas, itmp);
            else
                idwt97_1d(&tc.fdata[size_t(j) * w], 1, hsn, hdn, hcas, ftmp);
        }
        for (uint32_t i = 0; i < rw; ++i) {
            if (reversible)
                idwt53_1d(&tc.idata[i], w, vsn, vdn, vcas, itmp);
            else
                idwt97_1d(&tc.fdata[i], w, vsn, vdn, vcas, ftmp);
        }
    }
}

// ----- the decoder ------------------------------------------------------------------

enum Stat {
    ST_PROGRESSIONS,  // bit p: a tile of progression order p
    ST_RUN_MODES,     // cleanup-pass columns coded in run mode
    ST_53,            // tile-components through the 5/3 inverse
    ST_97,            // tile-components through the 9/7 inverse
    ST_RCT,
    ST_ICT,
    ST_CUT_SHORT,     // code-blocks whose passes stop above the last bit-plane
    ST_MULTI_LAYER,   // code-blocks of data from more than one layer
    ST_TILE_OFFSET,   // tiles of a grid offset from the origin, or of an image offset
    ST_SUBSAMPLED,    // tile-components of a component subsampled
    ST_SOP,           // packets after an SOP marker
    ST_TILES,
    ST_COUNT
};

struct Decoder {
    const Codestream& cs;
    int64_t* stats;
    uint8_t* out;
    size_t out_size;
    uint32_t bytes;  // per sample of the output
    std::vector<int64_t> offsets;  // each component's plane in ``out``

    Decoder(const Codestream& c, int64_t* st, uint8_t* o, size_t sz)
        : cs(c), stats(st), out(o), out_size(sz) {
        uint32_t maxprec = 0;
        for (auto& cm : cs.comps) maxprec = std::max(maxprec, cm.prec);
        bytes = maxprec > 8 ? 2 : 1;
        int64_t off = 0;
        for (size_t c2 = 0; c2 < cs.comps.size(); ++c2) {
            int64_t a[4];
            cs.comp_area(c2, a);
            offsets.push_back(off);
            off += a[2] * a[3] * bytes;
        }
        if (size_t(off) != out_size)
            fail("an output buffer of %zu bytes for %lld", out_size, (long long)off);
    }

    void stat(Stat s, int64_t v = 1) {
        if (stats) stats[s] += v;
    }

    void run() {
        for (size_t t = 0; t < cs.tcps.size(); ++t) decode_tile(uint32_t(t));
    }

    void decode_tile(uint32_t t) {
        const Tcp& tcp = cs.tcps[t];
        uint32_t p = t % cs.tw, q = t / cs.tw;
        int64_t tx0 = int64_t(cs.tx0) + int64_t(p) * cs.tdx;
        int64_t ty0 = int64_t(cs.ty0) + int64_t(q) * cs.tdy;
        int64_t x0 = std::max<int64_t>(tx0, cs.x0), y0 = std::max<int64_t>(ty0, cs.y0);
        int64_t x1 = std::min<int64_t>(tx0 + cs.tdx, cs.x1);
        int64_t y1 = std::min<int64_t>(ty0 + cs.tdy, cs.y1);
        if (x1 <= x0 || y1 <= y0) fail("tile %u of no area", t);
        if (cs.tx0 || cs.ty0 || cs.x0 || cs.y0) stat(ST_TILE_OFFSET);
        stat(ST_TILES);
        if (stats) stats[ST_PROGRESSIONS] |= int64_t(1) << tcp.prg;

        // the tile's data: its tile-parts joined
        std::vector<uint8_t> data;
        for (auto& pt : cs.parts[t])
            data.insert(data.end(), cs.src + pt.first, cs.src + pt.first + pt.second);

        size_t nc = cs.comps.size();
        std::vector<TileComp> tcs(nc);
        std::vector<Cblk> cblks;
        uint64_t npackets = 0;
        for (size_t c = 0; c < nc; ++c)
            init_tilecomp(tcs[c], cs.comps[c], tcp.tccps[c], x0, y0, x1, y1, cblks, npackets);
        npackets *= tcp.numlayers;
        if (npackets > data.size())
            fail("tile %u of %llu packets in %zu bytes: the file is cut or its headers damaged", t,
                 (unsigned long long)npackets, data.size());

        std::vector<Chunk> chunks;
        tier2(t, tcp, tcs, cblks, data, x0, y0, x1, y1, chunks);

        // tier 1, into each tile-component's buffer
        T1 t1;
        std::vector<uint8_t> buf;
        for (size_t c = 0; c < nc; ++c) {
            TileComp& tc = tcs[c];
            const Tccp& tccp = tcp.tccps[c];
            bool rev = tccp.qmfbid == 1;
            size_t area = size_t(tc.width()) * tc.height();
            if (rev) tc.idata.assign(area, 0);
            else tc.fdata.assign(area, 0.0f);
            for (uint32_t r = 0; r < tc.numres; ++r) {
                Resolution& res = tc.res[r];
                for (uint32_t b = 0; b < res.numbands; ++b) {
                    Band& band = res.bands[b];
                    t1.zc = &tables().zc[size_t(band.bandno) << 9];
                    for (auto& prc : band.precincts)
                        for (size_t k = 0; k < size_t(prc.cw) * prc.ch; ++k) {
                            Cblk& cb = cblks[prc.first + k];
                            decode_cblk(t1, cb, data, chunks, buf);
                            place(tc, r, band, cb, t1, rev);
                        }
                }
            }
            inverse_dwt(tc, rev);
            stat(rev ? ST_53 : ST_97);
            if (cs.comps[c].dx > 1 || cs.comps[c].dy > 1) stat(ST_SUBSAMPLED);
        }
        if (tcp.mct == 1 && nc >= 3) mct(tcp, tcs);
        for (size_t c = 0; c < nc; ++c) store(tcs[c], tcp.tccps[c], c);
    }

    void init_tilecomp(TileComp& tc, const Comp& comp, const Tccp& tccp, int64_t x0, int64_t y0,
                       int64_t x1, int64_t y1, std::vector<Cblk>& cblks, uint64_t& npackets) {
        tc.x0 = int32_t(ceildiv(x0, comp.dx));
        tc.y0 = int32_t(ceildiv(y0, comp.dy));
        tc.x1 = int32_t(ceildiv(x1, comp.dx));
        tc.y1 = int32_t(ceildiv(y1, comp.dy));
        tc.numres = tccp.numres;
        tc.res.resize(tc.numres);
        uint32_t level = tc.numres;
        for (uint32_t r = 0; r < tc.numres; ++r) {
            Resolution& res = tc.res[r];
            --level;
            res.x0 = int32_t(ceildivpow2(tc.x0, level));
            res.y0 = int32_t(ceildivpow2(tc.y0, level));
            res.x1 = int32_t(ceildivpow2(tc.x1, level));
            res.y1 = int32_t(ceildivpow2(tc.y1, level));
            res.pdx = tccp.prcw[r];
            res.pdy = tccp.prch[r];
            int64_t tlx = floordivpow2(res.x0, res.pdx) << res.pdx;
            int64_t tly = floordivpow2(res.y0, res.pdy) << res.pdy;
            int64_t brx = ceildivpow2(res.x1, res.pdx) << res.pdx;
            int64_t bry = ceildivpow2(res.y1, res.pdy) << res.pdy;
            res.pw = res.x0 == res.x1 ? 0 : uint32_t((brx - tlx) >> res.pdx);
            res.ph = res.y0 == res.y1 ? 0 : uint32_t((bry - tly) >> res.pdy);
            uint64_t nprec = uint64_t(res.pw) * res.ph;
            npackets += nprec;
            if (npackets > kMaxCblks)
                fail("more than %llu precincts in a tile", (unsigned long long)kMaxCblks);
            int64_t cbgx, cbgy;
            uint32_t cbgw, cbgh;
            if (r == 0) {
                cbgx = tlx;
                cbgy = tly;
                cbgw = res.pdx;
                cbgh = res.pdy;
                res.numbands = 1;
            } else {
                cbgx = ceildivpow2(tlx, 1);
                cbgy = ceildivpow2(tly, 1);
                cbgw = res.pdx - 1;
                cbgh = res.pdy - 1;
                res.numbands = 3;
            }
            uint32_t cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (r == 0) {
                    band.bandno = 0;
                    band.x0 = res.x0;
                    band.y0 = res.y0;
                    band.x1 = res.x1;
                    band.y1 = res.y1;
                } else {
                    band.bandno = b + 1;
                    int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
                    band.x0 = int32_t(ceildivpow2(tc.x0 - (x0b << level), level + 1));
                    band.y0 = int32_t(ceildivpow2(tc.y0 - (y0b << level), level + 1));
                    band.x1 = int32_t(ceildivpow2(tc.x1 - (x0b << level), level + 1));
                    band.y1 = int32_t(ceildivpow2(tc.y1 - (y0b << level), level + 1));
                }
                uint32_t si = r == 0 ? 0 : 3 * (r - 1) + b + 1;
                if (si >= tccp.nsteps)
                    fail("%u quantization step sizes for %u bands", tccp.nsteps,
                         3 * (tc.numres - 1) + 1);
                const StepSize& ss = tccp.steps[si];
                int32_t gain =
                    tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
                int32_t rb = int32_t(comp.prec) + gain;
                band.stepsize = float((1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
                band.numbps = ss.expn + int32_t(tccp.numgbits) - 1;
                band.precincts.resize(size_t(nprec));
                for (uint64_t pn = 0; pn < nprec; ++pn) {
                    Precinct& prc = band.precincts[size_t(pn)];
                    int64_t sx = cbgx + int64_t(pn % res.pw) * (int64_t(1) << cbgw);
                    int64_t sy = cbgy + int64_t(pn / res.pw) * (int64_t(1) << cbgh);
                    prc.x0 = int32_t(std::max<int64_t>(sx, band.x0));
                    prc.y0 = int32_t(std::max<int64_t>(sy, band.y0));
                    prc.x1 = int32_t(std::min<int64_t>(sx + (int64_t(1) << cbgw), band.x1));
                    prc.y1 = int32_t(std::min<int64_t>(sy + (int64_t(1) << cbgh), band.y1));
                    int64_t bx0 = floordivpow2(prc.x0, cbw) << cbw;
                    int64_t by0 = floordivpow2(prc.y0, cbh) << cbh;
                    int64_t bx1 = ceildivpow2(prc.x1, cbw) << cbw;
                    int64_t by1 = ceildivpow2(prc.y1, cbh) << cbh;
                    if (bx1 < bx0 || by1 < by0) fail("a precinct outside its band");
                    prc.cw = uint32_t((bx1 - bx0) >> cbw);
                    prc.ch = uint32_t((by1 - by0) >> cbh);
                    uint64_t nb = uint64_t(prc.cw) * prc.ch;
                    if (cblks.size() + nb > kMaxCblks)
                        fail("more than %llu code-blocks in a tile", (unsigned long long)kMaxCblks);
                    prc.first = cblks.size();
                    for (uint64_t k = 0; k < nb; ++k) {
                        Cblk cb;
                        int64_t cx = bx0 + int64_t(k % prc.cw) * (int64_t(1) << cbw);
                        int64_t cy = by0 + int64_t(k / prc.cw) * (int64_t(1) << cbh);
                        cb.x0 = int32_t(std::max<int64_t>(cx, prc.x0));
                        cb.y0 = int32_t(std::max<int64_t>(cy, prc.y0));
                        cb.x1 = int32_t(std::min<int64_t>(cx + (int64_t(1) << cbw), prc.x1));
                        cb.y1 = int32_t(std::min<int64_t>(cy + (int64_t(1) << cbh), prc.y1));
                        cblks.push_back(std::move(cb));
                    }
                    prc.incl.build(prc.cw, prc.ch);
                    prc.imsb.build(prc.cw, prc.ch);
                }
            }
        }
    }

    // ----- tier 2 -----

    struct Bio {  // bio.c
        const uint8_t *start, *end, *bp;
        uint32_t buf = 0, ct = 0;
        Bio(const uint8_t* s, const uint8_t* e) : start(s), end(e), bp(s) {}
        void bytein() {
            buf = (buf << 8) & 0xFFFF;
            ct = buf == 0xFF00 ? 7 : 8;
            if (bp < end) buf |= *bp++;
        }
        uint32_t bit() {
            if (ct == 0) bytein();
            --ct;
            return (buf >> ct) & 1;
        }
        uint32_t read(uint32_t n) {
            uint32_t v = 0;
            for (uint32_t i = n - 1; i < n; --i) v |= bit() << i;
            return v;
        }
        void inalign() {
            if ((buf & 0xFF) == 0xFF) bytein();
            ct = 0;
        }
    };

    static uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
        int32_t stk[32];
        int sp = 0;
        int32_t node = int32_t(leaf);
        while (tree.nodes[size_t(node)].parent >= 0) {
            stk[sp++] = node;
            node = tree.nodes[size_t(node)].parent;
        }
        int32_t low = 0;
        for (;;) {
            TagTree::Node& nd = tree.nodes[size_t(node)];
            if (low > nd.low) nd.low = low;
            else low = nd.low;
            while (low < threshold && low < nd.value) {
                if (bio.read(1)) nd.value = low;
                else ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
        return tree.nodes[size_t(node)].value < threshold ? 1 : 0;
    }

    static uint32_t numpasses(Bio& bio) {
        if (!bio.read(1)) return 1;
        if (!bio.read(1)) return 2;
        uint32_t n = bio.read(2);
        if (n != 3) return 3 + n;
        n = bio.read(5);
        if (n != 31) return 6 + n;
        return 37 + bio.read(7);
    }

    static void init_seg(Cblk& cb, uint32_t index) {
        if (cb.segs.size() <= index) cb.segs.resize(index + 1);
        cb.segs[index] = Seg();
        cb.segs[index].maxpasses = 109;
    }

    // the packet of (layer, resolution, component, precinct) at data[pos..]:
    // the bytes it takes
    size_t packet(const Tcp& tcp, TileComp& tc, uint32_t layno, uint32_t resno, uint32_t precno,
                  std::vector<Cblk>& cblks, const std::vector<uint8_t>& data, size_t pos,
                  std::vector<Chunk>& chunks) {
        Resolution& res = tc.res[resno];
        if (layno == 0)
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                Precinct& prc = band.precincts[precno];
                prc.incl.reset();
                prc.imsb.reset();
                for (size_t k = 0; k < size_t(prc.cw) * prc.ch; ++k) {
                    cblks[prc.first + k].numsegs = 0;
                    cblks[prc.first + k].real_num_segs = 0;
                }
            }
        const uint8_t* base = data.data();
        size_t max_end = data.size(), cur = pos;
        if (tcp.csty & 2) {  // SOP: optional, skipped where present
            if (max_end - cur >= 6 && base[cur] == 0xFF && base[cur + 1] == 0x91) {
                cur += 6;
                stat(ST_SOP);
            }
        }
        Bio bio(base + cur, base + max_end);
        bool present = bio.read(1);
        if (present) {
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                Precinct& prc = band.precincts[precno];
                for (uint32_t k = 0; k < prc.cw * prc.ch; ++k) {
                    Cblk& cb = cblks[prc.first + k];
                    uint32_t included =
                        cb.numsegs ? bio.read(1) : tgt_decode(bio, prc.incl, k, int32_t(layno + 1));
                    if (!included) {
                        cb.numnewpasses = 0;
                        continue;
                    }
                    if (!cb.numsegs) {
                        uint32_t i = 0;
                        while (!tgt_decode(bio, prc.imsb, k, int32_t(i))) ++i;
                        cb.numbps = uint32_t(band.numbps) + 1 - i;
                        cb.numlenbits = 3;
                    }
                    cb.numnewpasses = numpasses(bio);
                    uint32_t inc = 0;
                    while (bio.read(1)) ++inc;
                    cb.numlenbits += inc;
                    uint32_t segno = 0;
                    if (!cb.numsegs) {
                        init_seg(cb, 0);
                    } else {
                        segno = cb.numsegs - 1;
                        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses)
                            init_seg(cb, ++segno);
                    }
                    int32_t n = int32_t(cb.numnewpasses);
                    do {
                        Seg& sg = cb.segs[segno];
                        sg.numnewpasses =
                            uint32_t(std::min<int32_t>(int32_t(sg.maxpasses - sg.numpasses), n));
                        uint32_t bits = cb.numlenbits + floorlog2(sg.numnewpasses);
                        if (bits > 32)
                            fail("a code-block length of %u bits in a packet header", bits);
                        sg.newlen = bio.read(bits);
                        n -= int32_t(sg.numnewpasses);
                        if (n > 0) init_seg(cb, ++segno);
                    } while (n > 0);
                }
            }
        }
        bio.inalign();
        cur += size_t(bio.bp - bio.start);
        if (tcp.csty & 4) {  // EPH
            if (max_end - cur >= 2 && base[cur] == 0xFF && base[cur + 1] == 0x92) cur += 2;
        }
        if (!present) return cur - pos;
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& prc = band.precincts[precno];
            for (uint32_t k = 0; k < prc.cw * prc.ch; ++k) {
                Cblk& cb = cblks[prc.first + k];
                if (!cb.numnewpasses) continue;
                uint32_t s;
                if (!cb.numsegs) {
                    s = 0;
                    cb.numsegs = 1;
                } else {
                    s = cb.numsegs - 1;
                    if (cb.segs[s].numpasses == cb.segs[s].maxpasses) {
                        ++s;
                        ++cb.numsegs;
                    }
                }
                ++cb.layers;
                do {
                    Seg& sg = cb.segs[s];
                    if (sg.newlen > max_end - cur)
                        fail("a code-block's %u bytes run past its tile's data: the file is cut "
                             "or damaged", sg.newlen);
                    int32_t ci = int32_t(chunks.size());
                    chunks.push_back({cur, sg.newlen, -1});
                    if (cb.last_chunk >= 0) chunks[size_t(cb.last_chunk)].next = ci;
                    else cb.first_chunk = ci;
                    cb.last_chunk = ci;
                    cur += sg.newlen;
                    sg.len += sg.newlen;
                    sg.numpasses += sg.numnewpasses;
                    cb.numnewpasses -= sg.numnewpasses;
                    sg.real_num_passes = sg.numpasses;
                    if (cb.numnewpasses > 0) {
                        ++s;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
                cb.real_num_segs = cb.numsegs;
            }
        }
        return cur - pos;
    }

    // pi.c: the packets in the tile's progression order
    void tier2(uint32_t t, const Tcp& tcp, std::vector<TileComp>& tcs, std::vector<Cblk>& cblks,
               const std::vector<uint8_t>& data, int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1,
               std::vector<Chunk>& chunks) {
        uint32_t nc = uint32_t(tcs.size()), maxres = 0, maxprec = 0;
        for (auto& tc : tcs) {
            maxres = std::max(maxres, tc.numres);
            for (auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
        }
        uint64_t step_c = maxprec, step_r = uint64_t(nc) * step_c;
        uint64_t step_l = uint64_t(maxres) * step_r;
        std::vector<uint8_t> include(size_t(step_l * tcp.numlayers), 0);
        size_t pos = 0;
        uint64_t steps = 0;
        auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t pr) {
            uint8_t& seen = include[size_t(l * step_l + r * step_r + c * step_c + pr)];
            if (seen) return;
            seen = 1;
            if (pos >= data.size())
                fail("tile %u's packets run past the end of its data: the file is cut or damaged",
                     t);
            pos += packet(tcp, tcs[c], l, r, pr, cblks, data, pos, chunks);
        };
        auto tick = [&]() {
            if (++steps > kMaxSteps)
                fail("a progression of more than %llu steps", (unsigned long long)kMaxSteps);
        };
        uint32_t L = tcp.numlayers;
        switch (tcp.prg) {
            case 0:  // LRCP
                for (uint32_t l = 0; l < L; ++l)
                    for (uint32_t r = 0; r < maxres; ++r)
                        for (uint32_t c = 0; c < nc; ++c) {
                            if (r >= tcs[c].numres) continue;
                            const Resolution& res = tcs[c].res[r];
                            for (uint32_t pr = 0; pr < res.pw * res.ph; ++pr) emit(l, r, c, pr);
                        }
                break;
            case 1:  // RLCP
                for (uint32_t r = 0; r < maxres; ++r)
                    for (uint32_t l = 0; l < L; ++l)
                        for (uint32_t c = 0; c < nc; ++c) {
                            if (r >= tcs[c].numres) continue;
                            const Resolution& res = tcs[c].res[r];
                            for (uint32_t pr = 0; pr < res.pw * res.ph; ++pr) emit(l, r, c, pr);
                        }
                break;
            default: {  // RPCL, PCRL, CPRL: by position
                auto min_steps = [&](uint32_t c0, uint32_t c1, uint64_t& dx, uint64_t& dy) {
                    dx = dy = 0;
                    for (uint32_t c = c0; c < c1; ++c) {
                        const Comp& cm = cs.comps[c];
                        for (uint32_t r = 0; r < tcs[c].numres; ++r) {
                            const Resolution& res = tcs[c].res[r];
                            uint32_t ex = res.pdx + tcs[c].numres - 1 - r;
                            uint32_t ey = res.pdy + tcs[c].numres - 1 - r;
                            if (ex < 32 && cm.dx <= UINT32_MAX / (1u << ex)) {
                                uint64_t v = uint64_t(cm.dx) << ex;
                                dx = dx ? std::min(dx, v) : v;
                            }
                            if (ey < 32 && cm.dy <= UINT32_MAX / (1u << ey)) {
                                uint64_t v = uint64_t(cm.dy) << ey;
                                dy = dy ? std::min(dy, v) : v;
                            }
                        }
                    }
                    if (!dx || !dy) fail("a progression of no position step");
                };
                // the precinct of component c, resolution r at position (x, y), or -1
                auto precinct_at = [&](uint32_t c, uint32_t r, uint64_t x, uint64_t y) -> int64_t {
                    const TileComp& tc = tcs[c];
                    const Comp& cm = cs.comps[c];
                    const Resolution& res = tc.res[r];
                    uint32_t level = tc.numres - 1 - r;
                    uint64_t cdx = uint64_t(cm.dx) << level, cdy = uint64_t(cm.dy) << level;
                    if (level >= 32 || cdx > INT32_MAX || cdy > INT32_MAX) return -1;
                    uint64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
                    uint64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
                    uint32_t rpx = res.pdx + level, rpy = res.pdy + level;
                    if (rpx >= 31 || rpy >= 31 || (uint64_t(cm.dx) << rpx) > UINT32_MAX ||
                        (uint64_t(cm.dy) << rpy) > UINT32_MAX)
                        return -1;
                    if (!(y % (uint64_t(cm.dy) << rpy) == 0 ||
                          (y == uint64_t(ty0) && ((try0 << level) % (uint64_t(1) << rpy)))))
                        return -1;
                    if (!(x % (uint64_t(cm.dx) << rpx) == 0 ||
                          (x == uint64_t(tx0) && ((trx0 << level) % (uint64_t(1) << rpx)))))
                        return -1;
                    if (res.pw == 0 || res.ph == 0) return -1;
                    if (trx0 == trx1 || try0 == try1) return -1;
                    uint64_t prci = (ceildiv(x, cdx) >> res.pdx) - (trx0 >> res.pdx);
                    uint64_t prcj = (ceildiv(y, cdy) >> res.pdy) - (try0 >> res.pdy);
                    return int64_t(prci + prcj * res.pw);
                };
                auto positions = [&](uint64_t dx, uint64_t dy, auto&& body) {
                    for (uint64_t y = uint64_t(ty0); y < uint64_t(ty1); y += dy - (y % dy))
                        for (uint64_t x = uint64_t(tx0); x < uint64_t(tx1); x += dx - (x % dx)) {
                            tick();
                            body(x, y);
                        }
                };
                uint64_t dx, dy;
                if (tcp.prg == 2) {  // RPCL
                    min_steps(0, nc, dx, dy);
                    for (uint32_t r = 0; r < maxres; ++r)
                        positions(dx, dy, [&](uint64_t x, uint64_t y) {
                            for (uint32_t c = 0; c < nc; ++c) {
                                if (r >= tcs[c].numres) continue;
                                int64_t pr = precinct_at(c, r, x, y);
                                if (pr < 0) continue;
                                for (uint32_t l = 0; l < L; ++l) emit(l, r, c, uint32_t(pr));
                            }
                        });
                } else if (tcp.prg == 3) {  // PCRL
                    min_steps(0, nc, dx, dy);
                    positions(dx, dy, [&](uint64_t x, uint64_t y) {
                        for (uint32_t c = 0; c < nc; ++c)
                            for (uint32_t r = 0; r < std::min(maxres, tcs[c].numres); ++r) {
                                int64_t pr = precinct_at(c, r, x, y);
                                if (pr < 0) continue;
                                for (uint32_t l = 0; l < L; ++l) emit(l, r, c, uint32_t(pr));
                            }
                    });
                } else {  // CPRL
                    for (uint32_t c = 0; c < nc; ++c) {
                        min_steps(c, c + 1, dx, dy);
                        positions(dx, dy, [&](uint64_t x, uint64_t y) {
                            for (uint32_t r = 0; r < std::min(maxres, tcs[c].numres); ++r) {
                                int64_t pr = precinct_at(c, r, x, y);
                                if (pr < 0) continue;
                                for (uint32_t l = 0; l < L; ++l) emit(l, r, c, uint32_t(pr));
                            }
                        });
                    }
                }
            }
        }
    }

    // ----- tier 1 of one code-block, and its place in the tile-component -----

    void decode_cblk(T1& t1, Cblk& cb, const std::vector<uint8_t>& data,
                     const std::vector<Chunk>& chunks, std::vector<uint8_t>& buf) {
        t1.allocate(uint32_t(cb.x1 - cb.x0), uint32_t(cb.y1 - cb.y0));
        int32_t bpno = int32_t(cb.numbps);
        if (bpno >= 31) fail("a code-block of %d bit-planes (OpenJPEG decodes up to 30)", bpno);
        if (cb.first_chunk < 0) return;
        if (cb.layers > 1) stat(ST_MULTI_LAYER);
        buf.clear();
        for (int32_t c = cb.first_chunk; c >= 0; c = chunks[size_t(c)].next)
            buf.insert(buf.end(), data.begin() + chunks[size_t(c)].off,
                       data.begin() + chunks[size_t(c)].off + chunks[size_t(c)].len);
        t1.mqc.reset_states();
        uint32_t passtype = 2;
        size_t index = 0;
        for (uint32_t s = 0; s < cb.real_num_segs; ++s) {
            const Seg& sg = cb.segs[s];
            // the segment's bytes, then OpenJPEG's artificial 0xFF 0xFF
            std::vector<uint8_t> seg(buf.begin() + index, buf.begin() + index + sg.len);
            seg.push_back(0xFF);
            seg.push_back(0xFF);
            t1.mqc.init(seg.data(), sg.len);
            index += sg.len;
            for (uint32_t pass = 0; pass < sg.real_num_passes && bpno >= 1; ++pass) {
                if (passtype == 0) t1.sigpass(bpno);
                else if (passtype == 1) t1.refpass(bpno);
                else t1.clnpass(bpno);
                if (++passtype == 3) {
                    passtype = 0;
                    --bpno;
                }
            }
        }
        if (bpno >= 1) stat(ST_CUT_SHORT);
        stat(ST_RUN_MODES, t1.run_modes);
        t1.run_modes = 0;
    }

    static void place(TileComp& tc, uint32_t r, const Band& band, const Cblk& cb, const T1& t1,
                      bool rev) {
        uint32_t x = uint32_t(cb.x0 - band.x0), y = uint32_t(cb.y0 - band.y0);
        if (band.bandno & 1) x += uint32_t(tc.res[r - 1].x1 - tc.res[r - 1].x0);
        if (band.bandno & 2) y += uint32_t(tc.res[r - 1].y1 - tc.res[r - 1].y0);
        size_t tw = tc.width();
        if (rev) {
            for (uint32_t j = 0; j < t1.h; ++j)
                for (uint32_t i = 0; i < t1.w; ++i)
                    tc.idata[(y + j) * tw + x + i] = t1.data[size_t(j) * t1.w + i] / 2;
        } else {
            const float step = 0.5f * band.stepsize;
            for (uint32_t j = 0; j < t1.h; ++j)
                for (uint32_t i = 0; i < t1.w; ++i)
                    tc.fdata[(y + j) * tw + x + i] = float(t1.data[size_t(j) * t1.w + i]) * step;
        }
    }

    // opj_tcd_mct_decode
    void mct(const Tcp& tcp, std::vector<TileComp>& tcs) {
        size_t n = size_t(tcs[0].width()) * tcs[0].height();
        for (int c = 1; c < 3; ++c)
            if (tcs[c].numres != tcs[0].numres || size_t(tcs[c].width()) * tcs[c].height() != n)
                fail("a multiple component transform over components of other sizes");
        if (tcp.tccps[1].qmfbid != tcp.tccps[0].qmfbid ||
            tcp.tccps[2].qmfbid != tcp.tccps[0].qmfbid)
            fail("a multiple component transform over components of other wavelets");
        if (tcp.tccps[0].qmfbid == 1) {
            stat(ST_RCT);
            int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
            for (size_t i = 0; i < n; ++i) {
                int32_t y = c0[i], u = c1[i], v = c2[i];
                int32_t g = wsub(y, wadd(u, v) >> 2);
                c0[i] = wadd(v, g);
                c1[i] = g;
                c2[i] = wadd(u, g);
            }
        } else {
            stat(ST_ICT);
            float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
            for (size_t i = 0; i < n; ++i) {
                float y = c0[i], u = c1[i], v = c2[i];
                float r = y + (v * kIctRv);
                float g = y - (u * kIctGu) - (v * kIctGv);
                float b = y + (u * kIctBu);
                c0[i] = r;
                c1[i] = g;
                c2[i] = b;
            }
        }
    }

    // opj_tcd_dc_level_shift_decode, then opj_tcd_update_tile_data's bytes
    void store(const TileComp& tc, const Tccp& tccp, size_t c) {
        const Comp& cm = cs.comps[c];
        int64_t lo, hi, shift = cm.sgnd ? 0 : int64_t(1) << (cm.prec - 1);
        if (cm.sgnd) {
            lo = -(int64_t(1) << (cm.prec - 1));
            hi = (int64_t(1) << (cm.prec - 1)) - 1;
        } else {
            lo = 0;
            hi = (int64_t(1) << cm.prec) - 1;
        }
        int64_t area[4];
        cs.comp_area(c, area);
        uint32_t w = tc.width(), h = tc.height();
        int64_t ox = tc.x0 - area[0], oy = tc.y0 - area[1];
        uint8_t* plane = out + offsets[c];
        for (uint32_t j = 0; j < h; ++j)
            for (uint32_t i = 0; i < w; ++i) {
                int64_t v;
                size_t k = size_t(j) * w + i;
                if (tccp.qmfbid == 1) {
                    v = std::min(std::max<int64_t>(wadd(tc.idata[k], int32_t(shift)), lo), hi);
                } else {
                    float f = tc.fdata[k];
                    if (f > float(INT32_MAX)) v = hi;
                    else if (f < float(INT32_MIN) || std::isnan(f)) v = lo;
                    else v = std::min(std::max<int64_t>(int64_t(std::lrint(f)) + shift, lo), hi);
                }
                size_t at = size_t((oy + j) * area[2] + ox + i);
                uint32_t u = uint32_t(v);
                if (bytes == 1) plane[at] = uint8_t(u);
                else {
                    plane[2 * at] = uint8_t(u);
                    plane[2 * at + 1] = uint8_t(u >> 8);
                }
            }
    }
};

void fill_info(const Codestream& cs, int64_t* info) {
    info[0] = cs.x0;
    info[1] = cs.y0;
    info[2] = cs.x1;
    info[3] = cs.y1;
    info[4] = int64_t(cs.comps.size());
    info[5] = cs.rsiz;
    info[6] = cs.tx0;
    info[7] = cs.ty0;
    info[8] = cs.tdx;
    info[9] = cs.tdy;
    info[10] = cs.tw;
    info[11] = cs.th;
    for (size_t c = 0; c < cs.comps.size(); ++c) {
        int64_t* ci = info + 12 + 8 * c;
        ci[0] = cs.comps[c].prec;
        ci[1] = cs.comps[c].sgnd;
        ci[2] = cs.comps[c].dx;
        ci[3] = cs.comps[c].dy;
        cs.comp_area(c, ci + 4);
    }
    for (size_t c = cs.comps.size(); c < 4; ++c)
        for (int k = 0; k < 8; ++k) info[12 + 8 * c + k] = 0;
}

}  // namespace

extern "C" {

// info: x0, y0, x1, y1, components, Rsiz, tile grid x0, y0, width, height,
// tiles across, down; then per component (4 slots): precision, signed, dx,
// dy, and its area's x0, y0, width, height (44 int64)
int j2k_info(const uint8_t* src, int64_t n, int64_t* info, char* err, int64_t errcap) {
    try {
        Codestream cs;
        cs.parse(src, size_t(n));
        fill_info(cs, info);
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

// out: each component's plane (its area, as j2k_info gives it), one byte a
// sample where every precision is up to 8 bits, else two (little-endian)
int j2k_decode(const uint8_t* src, int64_t n, uint8_t* out, int64_t out_size, int64_t* stats,
               char* err, int64_t errcap) {
    try {
        Codestream cs;
        cs.parse(src, size_t(n));
        if (stats) std::memset(stats, 0, sizeof(int64_t) * ST_COUNT);
        Decoder d(cs, stats, out, size_t(out_size));
        d.run();
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    } catch (...) {
        set_error(err, errcap, "the decoder failed");
        return -1;
    }
}

// the zero-coding (4 x 512), sign-context (256) and sign-flip (256) tables,
// the 94 MQ states (qe, mps, next-MPS index, next-LPS index as uint32), and
// the float constants alpha, beta, gamma, delta, K, 2/K and the ICT's four
int64_t j2k_tables(uint8_t* out, int64_t cap) {
    const Tables& t = tables();
    std::vector<uint8_t> v(t.zc, t.zc + sizeof t.zc);
    v.insert(v.end(), t.sc, t.sc + 256);
    v.insert(v.end(), t.spb, t.spb + 256);
    for (const MqState& s : t.states) {
        uint32_t w[4] = {s.qe, s.mps, uint32_t(s.nmps - t.states), uint32_t(s.nlps - t.states)};
        v.insert(v.end(), reinterpret_cast<uint8_t*>(w), reinterpret_cast<uint8_t*>(w) + sizeof w);
    }
    const float f[10] = {kAlpha, kBeta,  kGamma, kDelta, kK,
                         kTwoInvK, kIctRv, kIctGu, kIctGv, kIctBu};
    const uint8_t* fb = reinterpret_cast<const uint8_t*>(f);
    v.insert(v.end(), fb, fb + sizeof f);
    if (int64_t(v.size()) > cap) return -int64_t(v.size());
    std::memcpy(out, v.data(), v.size());
    return int64_t(v.size());
}

}  // extern "C"
