// CCITT bilevel decoding of TIFF strips and tiles (compressions 2, 3 and
// 4), read as libtiff's fax3 codec reads them for PIL and cv2, after
// ITU-T T.4 (Modified Huffman, Modified READ) and T.6 (Modified Modified
// READ).
//
// The decoder keeps libtiff's state machine, so that damaged and cut data
// read as they do there: bits enter an accumulator least significant
// first (each byte's bits reversed: FillOrder 1; the caller reverses them
// for FillOrder 2); at the data's end a lookup that still holds some bits
// reads zeros after them, one that holds none ends the data; a code no
// table holds ends the row (the row's runs cleaned up to its width, white
// after its last change) and decoding goes on; an end of data fills the
// row being read the same way and stops.  Group 3 rows start at an EOL,
// searched for through any fill bits; Modified Huffman (compression 2)
// rows start at a byte boundary, without EOLs (CCITT RLEW, compression
// 32771: at a 16-bit word of the strip); a Group 4 strip that ends
// (or meets an EOL) after its first row is read without error, its later
// rows left as they are.  Rows are written with 1 for a black pixel (a
// run of the odd index), most significant bit first.

#include <cstdint>
#include <cstring>

namespace {

enum State : uint8_t {
    kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW, kMakeUpB, kMakeUp,
    kEOL
};

struct Entry {
    uint8_t state = kNull, width = 0;
    uint16_t param = 0;
};

// (code, its length in bits, run length or vertical offset), the code's
// bits as T.4 writes them, first bit most significant
struct Code {
    uint16_t bits;
    uint8_t len;
    uint16_t param;
};

const Code kWhiteTerm[] = {
    {0x35, 8, 0}, {0x7, 6, 1}, {0x7, 4, 2}, {0x8, 4, 3}, {0xB, 4, 4}, {0xC, 4, 5},
    {0xE, 4, 6}, {0xF, 4, 7}, {0x13, 5, 8}, {0x14, 5, 9}, {0x7, 5, 10}, {0x8, 5, 11},
    {0x8, 6, 12}, {0x3, 6, 13}, {0x34, 6, 14}, {0x35, 6, 15}, {0x2A, 6, 16}, {0x2B, 6, 17},
    {0x27, 7, 18}, {0xC, 7, 19}, {0x8, 7, 20}, {0x17, 7, 21}, {0x3, 7, 22}, {0x4, 7, 23},
    {0x28, 7, 24}, {0x2B, 7, 25}, {0x13, 7, 26}, {0x24, 7, 27}, {0x18, 7, 28}, {0x2, 8, 29},
    {0x3, 8, 30}, {0x1A, 8, 31}, {0x1B, 8, 32}, {0x12, 8, 33}, {0x13, 8, 34}, {0x14, 8, 35},
    {0x15, 8, 36}, {0x16, 8, 37}, {0x17, 8, 38}, {0x28, 8, 39}, {0x29, 8, 40}, {0x2A, 8, 41},
    {0x2B, 8, 42}, {0x2C, 8, 43}, {0x2D, 8, 44}, {0x4, 8, 45}, {0x5, 8, 46}, {0xA, 8, 47},
    {0xB, 8, 48}, {0x52, 8, 49}, {0x53, 8, 50}, {0x54, 8, 51}, {0x55, 8, 52}, {0x24, 8, 53},
    {0x25, 8, 54}, {0x58, 8, 55}, {0x59, 8, 56}, {0x5A, 8, 57}, {0x5B, 8, 58}, {0x4A, 8, 59},
    {0x4B, 8, 60}, {0x32, 8, 61}, {0x33, 8, 62}, {0x34, 8, 63}};
const Code kWhiteMakeUp[] = {
    {0x1B, 5, 64}, {0x12, 5, 128}, {0x17, 6, 192}, {0x37, 7, 256}, {0x36, 8, 320},
    {0x37, 8, 384}, {0x64, 8, 448}, {0x65, 8, 512}, {0x68, 8, 576}, {0x67, 8, 640},
    {0xCC, 9, 704}, {0xCD, 9, 768}, {0xD2, 9, 832}, {0xD3, 9, 896}, {0xD4, 9, 960},
    {0xD5, 9, 1024}, {0xD6, 9, 1088}, {0xD7, 9, 1152}, {0xD8, 9, 1216}, {0xD9, 9, 1280},
    {0xDA, 9, 1344}, {0xDB, 9, 1408}, {0x98, 9, 1472}, {0x99, 9, 1536}, {0x9A, 9, 1600},
    {0x18, 6, 1664}, {0x9B, 9, 1728}};
const Code kBlackTerm[] = {
    {0x37, 10, 0}, {0x2, 3, 1}, {0x3, 2, 2}, {0x2, 2, 3}, {0x3, 3, 4}, {0x3, 4, 5},
    {0x2, 4, 6}, {0x3, 5, 7}, {0x5, 6, 8}, {0x4, 6, 9}, {0x4, 7, 10}, {0x5, 7, 11},
    {0x7, 7, 12}, {0x4, 8, 13}, {0x7, 8, 14}, {0x18, 9, 15}, {0x17, 10, 16}, {0x18, 10, 17},
    {0x8, 10, 18}, {0x67, 11, 19}, {0x68, 11, 20}, {0x6C, 11, 21}, {0x37, 11, 22},
    {0x28, 11, 23}, {0x17, 11, 24}, {0x18, 11, 25}, {0xCA, 12, 26}, {0xCB, 12, 27},
    {0xCC, 12, 28}, {0xCD, 12, 29}, {0x68, 12, 30}, {0x69, 12, 31}, {0x6A, 12, 32},
    {0x6B, 12, 33}, {0xD2, 12, 34}, {0xD3, 12, 35}, {0xD4, 12, 36}, {0xD5, 12, 37},
    {0xD6, 12, 38}, {0xD7, 12, 39}, {0x6C, 12, 40}, {0x6D, 12, 41}, {0xDA, 12, 42},
    {0xDB, 12, 43}, {0x54, 12, 44}, {0x55, 12, 45}, {0x56, 12, 46}, {0x57, 12, 47},
    {0x64, 12, 48}, {0x65, 12, 49}, {0x52, 12, 50}, {0x53, 12, 51}, {0x24, 12, 52},
    {0x37, 12, 53}, {0x38, 12, 54}, {0x27, 12, 55}, {0x28, 12, 56}, {0x58, 12, 57},
    {0x59, 12, 58}, {0x2B, 12, 59}, {0x2C, 12, 60}, {0x5A, 12, 61}, {0x66, 12, 62},
    {0x67, 12, 63}};
const Code kBlackMakeUp[] = {
    {0xF, 10, 64}, {0xC8, 12, 128}, {0xC9, 12, 192}, {0x5B, 12, 256}, {0x33, 12, 320},
    {0x34, 12, 384}, {0x35, 12, 448}, {0x6C, 13, 512}, {0x6D, 13, 576}, {0x4A, 13, 640},
    {0x4B, 13, 704}, {0x4C, 13, 768}, {0x4D, 13, 832}, {0x72, 13, 896}, {0x73, 13, 960},
    {0x74, 13, 1024}, {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216},
    {0x52, 13, 1280}, {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472},
    {0x5A, 13, 1536}, {0x5B, 13, 1600}, {0x64, 13, 1664}, {0x65, 13, 1728}};
// the extended make-up codes both colours share (runs of 1792 and more)
const Code kExtMakeUp[] = {
    {0x8, 11, 1792}, {0xC, 11, 1856}, {0xD, 11, 1920}, {0x12, 12, 1984}, {0x13, 12, 2048},
    {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304},
    {0x1C, 12, 2368}, {0x1D, 12, 2432}, {0x1E, 12, 2496}, {0x1F, 12, 2560}};
// the two-dimensional mode codes; an EOL's first 7 zeros (11 in the run
// tables: its last bit is read by the next row's search)
const Code kMain[] = {{0x1, 4, 0}, {0x1, 3, 0}, {0x1, 1, 0}, {0x3, 3, 1}, {0x3, 6, 2},
                      {0x3, 7, 3}, {0x2, 3, 1}, {0x2, 6, 2}, {0x2, 7, 3}, {0x1, 7, 0},
                      {0x0, 7, 0}};
const State kMainStates[] = {kPass, kHoriz, kV0, kVR, kVR, kVR, kVL, kVL, kVL, kExt, kEOL};
const Code kEolRun = {0x0, 11, 0};

struct Tables {
    Entry main[1 << 7], white[1 << 12], black[1 << 13];

    // every index whose first ``len`` bits (least significant first) are
    // the code's
    static void put(Entry* table, int width, const Code& c, State state) {
        uint32_t rev = 0;
        for (int i = 0; i < c.len; ++i) rev |= ((c.bits >> (c.len - 1 - i)) & 1u) << i;
        for (uint32_t s = 0; s < (1u << (width - c.len)); ++s) {
            Entry& e = table[rev | (s << c.len)];
            e.state = state;
            e.width = c.len;
            e.param = c.param;
        }
    }

    Tables() {
        for (int i = 0; i < 11; ++i) put(main, 7, kMain[i], kMainStates[i]);
        for (const Code& c : kWhiteTerm) put(white, 12, c, kTermW);
        for (const Code& c : kWhiteMakeUp) put(white, 12, c, kMakeUpW);
        for (const Code& c : kBlackTerm) put(black, 13, c, kTermB);
        for (const Code& c : kBlackMakeUp) put(black, 13, c, kMakeUpB);
        for (const Code& c : kExtMakeUp) {
            put(white, 12, c, kMakeUp);
            put(black, 13, c, kMakeUp);
        }
        put(white, 12, kEolRun, kEOL);
        put(black, 13, kEolRun, kEOL);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// codes counted into ``stats`` (when given)
enum Stat { kStPass, kStHoriz, kStV0, kStVR1, kStVR2, kStVR3, kStVL1, kStVL2, kStVL3,
            kStTerm, kStMakeUp, kStExtMakeUp, kStEol, kStBad, kStats };

uint8_t reverse_byte(uint8_t b) {
    b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// libtiff's _TIFFFax3fillruns: white runs clear, black runs set, each
// clipped to the row
void fill_runs(uint8_t* row, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int k = 0; k < 2; ++k) {
            uint32_t run = runs[k];
            if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
            for (uint32_t i = x; i < x + run; ++i) {
                const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
                if (k) row[i >> 3] |= bit;
                else row[i >> 3] &= static_cast<uint8_t>(~bit);
            }
            x += run;
        }
    }
}

class Decoder {
 public:
    // ``runs`` holds 2 * nruns(width) + 2 run lengths, kept from strip to
    // strip of a page as libtiff keeps them: a reference line's runs past
    // its end are read by damaged data
    Decoder(const uint8_t* src, int64_t n, int compression, uint32_t width, int t4, bool noeol,
            uint32_t* runs, int64_t* stats)
        : start_(src), cp_(src), ep_(src + n), lastx_(width), compression_(compression),
          stats_(stats), two_d_(compression == 4 || (compression == 3 && (t4 & 1))),
          noeol_(noeol), nruns_(nruns(width, two_d_)), cur_(runs), ref_(runs + nruns_) {
        ref_[0] = width;
        ref_[1] = 0;
    }

    // libtiff's Fax3SetupState: the runs of a row, rounded up to 32, twice
    // over where a reference line is kept
    static uint64_t nruns(uint32_t width, bool two_d) {
        const uint64_t n = (static_cast<uint64_t>(width) + 1 + 31) / 32 * 32;
        return two_d ? 2 * n : n;
    }

    // rows of ``rowbytes`` into dst: the bytes of the rows written (the
    // last one filled, its runs cleaned up), negative (-1 - bytes) where
    // libtiff's decoder fails
    int64_t run(uint8_t* dst, int64_t rows, int64_t rowbytes);
    bool noeol() const { return noeol_; }

 private:
    const uint8_t* start_;
    const uint8_t* cp_;
    const uint8_t* ep_;
    uint32_t acc_ = 0;
    int avail_ = 0;
    int eolcnt_ = 0;
    uint32_t lastx_;
    int compression_;
    int64_t* stats_;
    bool two_d_;
    bool noeol_;  // Group 3 data read without EOLs, from the first one missing
    uint64_t nruns_;
    uint32_t* cur_;
    uint32_t* ref_;
    // the row being decoded
    uint32_t* thisrun_ = nullptr;
    uint32_t* pa_ = nullptr;
    uint32_t* pb_ = nullptr;
    int64_t a0_ = 0, b1_ = 0, run_length_ = 0;

    void count(int k) {
        if (stats_) ++stats_[k];
    }
    // NeedBits8 / NeedBits16: false where the data has ended with no bit
    // held; bits past the end read as zeros
    bool need(int n) {
        while (avail_ < n) {
            if (cp_ >= ep_) {
                if (avail_ == 0) return false;
                avail_ = n;
                return true;
            }
            acc_ |= static_cast<uint32_t>(reverse_byte(*cp_++)) << avail_;
            avail_ += 8;
        }
        return true;
    }
    uint32_t bits(int n) const { return acc_ & ((1u << n) - 1); }
    void clear(int n) {
        avail_ -= n;
        acc_ >>= n;
    }
    const Entry* lookup(const Entry* table, int width) {
        if (!need(width)) return nullptr;
        const Entry* e = table + bits(width);
        clear(e->width);
        return e;
    }
    // SETVALUE: false on a run array overflow
    bool set_value(int64_t x) {
        if (pa_ >= thisrun_ + nruns_) return false;
        *pa_++ = static_cast<uint32_t>(run_length_ + x);
        a0_ += x;
        run_length_ = 0;
        return true;
    }
    bool cleanup() {
        if (run_length_ && !set_value(0)) return false;
        const int64_t lastx = lastx_;
        if (a0_ != lastx) {
            while (a0_ > lastx && pa_ > thisrun_) a0_ -= *--pa_;
            if (a0_ < lastx) {
                if (a0_ < 0) a0_ = 0;
                if (((pa_ - thisrun_) & 1) && !set_value(0)) return false;
                if (!set_value(lastx - a0_)) return false;
            } else if (a0_ > lastx) {
                if (!set_value(lastx) || !set_value(0)) return false;
            }
        }
        return true;
    }
    bool check_b1() {
        if (pa_ != thisrun_) {
            while (b1_ <= a0_ && b1_ < static_cast<int64_t>(lastx_)) {
                if (pb_ + 1 >= ref_ + nruns_) return false;
                b1_ += pb_[0] + pb_[1];
                pb_ += 2;
            }
        }
        return true;
    }
    int sync_eol();
    int expand_1d();
    int expand_2d();
    int colour_run(bool black, bool eol_ends_row);
};

// the codes of one run (make-ups, then a terminating code): 0 done, 1 a
// code the table does not hold (or, ``eol_ends_row``, an EOL), 2 the data
// ended, 3 overflow
int Decoder::colour_run(bool black, bool eol_ends_row) {
    const Tables& t = tables();
    for (;;) {
        const Entry* e = black ? lookup(t.black, 13) : lookup(t.white, 12);
        if (!e) return 2;
        switch (e->state) {
            case kTermW:
            case kTermB:
                count(kStTerm);
                return set_value(e->param) ? 0 : 3;
            case kMakeUpW:
            case kMakeUpB:
            case kMakeUp:
                count(e->state == kMakeUp ? kStExtMakeUp : kStMakeUp);
                a0_ += e->param;
                run_length_ += e->param;
                break;
            case kEOL:
                if (eol_ends_row) {
                    count(kStEol);
                    eolcnt_ = 1;
                    return 1;
                }
                count(kStBad);
                return 1;
            default:
                count(kStBad);
                return 1;
        }
    }
}

// EXPAND1D: 0 the row ended (cleaned up), 2 the data ended (cleaned up),
// 3 overflow
int Decoder::expand_1d() {
    for (;;) {
        int r = colour_run(false, true);
        if (r == 0 && a0_ < static_cast<int64_t>(lastx_)) r = colour_run(true, true);
        if (r == 3) return 3;
        if (r == 2) return cleanup() ? 2 : 3;
        if (r == 1 || a0_ >= static_cast<int64_t>(lastx_)) return cleanup() ? 0 : 3;
        if (pa_ - thisrun_ >= 2 && *(pa_ - 1) == 0 && *(pa_ - 2) == 0) pa_ -= 2;
    }
}

// EXPAND2D, as expand_1d
int Decoder::expand_2d() {
    const Tables& t = tables();
    const int64_t lastx = lastx_;
    while (a0_ < lastx) {
        if (pa_ >= thisrun_ + nruns_) return 3;
        const Entry* e = lookup(t.main, 7);
        if (!e) return cleanup() ? 2 : 3;
        int r;
        switch (e->state) {
            case kPass:
                count(kStPass);
                if (!check_b1() || pb_ + 1 >= ref_ + nruns_) return 3;
                b1_ += *pb_++;
                run_length_ += b1_ - a0_;
                a0_ = b1_;
                b1_ += *pb_++;
                break;
            case kHoriz: {
                count(kStHoriz);
                const bool black = (pa_ - thisrun_) & 1;
                r = colour_run(black, false);
                if (r == 0) r = colour_run(!black, false);
                if (r == 3) return 3;
                if (r == 2) return cleanup() ? 2 : 3;
                if (r == 1) return cleanup() ? 0 : 3;
                if (!check_b1()) return 3;
                break;
            }
            case kV0:
            case kVR:
                count(e->state == kV0 ? kStV0 : kStVR1 + e->param - 1);
                if (!check_b1() || !set_value(b1_ - a0_ + e->param)) return 3;
                if (pb_ >= ref_ + nruns_) return 3;
                b1_ += *pb_++;
                break;
            case kVL:
                count(kStVL1 + e->param - 1);
                if (!check_b1()) return 3;
                if (b1_ < a0_ + e->param) {
                    count(kStBad);
                    return cleanup() ? 0 : 3;
                }
                if (!set_value(b1_ - a0_ - e->param)) return 3;
                b1_ -= *--pb_;
                break;
            case kExt:  // uncompressed mode, which libtiff does not read
                count(kStBad);
                *pa_++ = static_cast<uint32_t>(lastx - a0_);
                return cleanup() ? 0 : 3;
            case kEOL:
                count(kStEol);
                *pa_++ = static_cast<uint32_t>(lastx - a0_);
                if (!need(4)) return cleanup() ? 2 : 3;
                if (bits(4)) count(kStBad);
                clear(4);
                eolcnt_ = 1;
                return cleanup() ? 0 : 3;
            default:
                count(kStBad);
                return cleanup() ? 0 : 3;
        }
    }
    if (run_length_) {
        if (run_length_ + a0_ < lastx) {  // a final V0 is expected
            if (!need(1)) return cleanup() ? 2 : 3;
            if (!bits(1)) {
                count(kStBad);
                return cleanup() ? 0 : 3;
            }
            clear(1);
        }
        if (!set_value(0)) return 3;
    }
    return cleanup() ? 0 : 3;
}

// SYNC_EOL: skip to the bit after the next EOL (past any fill bits): 0,
// or 2 where the data ends in the search for its zeros, or 1 where it
// ends before the EOL's 1 (libtiff then reads the data, from its start,
// as Group 3 without EOLs)
int Decoder::sync_eol() {
    if (eolcnt_ == 0) {
        for (;;) {
            if (!need(11)) return 2;
            if (bits(11) == 0) break;
            clear(1);
        }
    }
    for (;;) {
        if (!need(8)) return 1;
        if (bits(8)) break;
        clear(8);
    }
    while (bits(1) == 0) clear(1);
    clear(1);
    count(kStEol);
    eolcnt_ = 0;
    return 0;
}

int64_t Decoder::run(uint8_t* dst, int64_t rows, int64_t rowbytes) {
    for (int64_t line = 0; line < rows; ++line) {
        uint8_t* row = dst + line * rowbytes;
        a0_ = 0;
        run_length_ = 0;
        thisrun_ = pa_ = cur_;
        int r;
        if (compression_ == 4) {
            pb_ = ref_;
            b1_ = *pb_++;
            r = expand_2d();
            if (r == 3) return -1 - line * rowbytes;
            if (r == 2 || eolcnt_) {  // the end of the data, or of the strip (EOFB)
                fill_runs(row, thisrun_, pa_, lastx_);
                return line ? (line + 1) * rowbytes : -1 - (line + 1) * rowbytes;
            }
        } else {
            const int sync = compression_ == 3 && !noeol_ ? sync_eol() : 0;
            if (sync == 1) {  // from the data's start again, without EOLs
                noeol_ = true;
                cp_ = start_;
                acc_ = 0;
                avail_ = 0;
                eolcnt_ = 0;
                --line;
                continue;
            }
            if (sync == 2) {
                if (!cleanup()) return -1 - line * rowbytes;
                fill_runs(row, thisrun_, pa_, lastx_);
                return -1 - (line + 1) * rowbytes;
            }
            bool one_d = true;
            if (two_d_) {
                if (!need(1)) {
                    if (!cleanup()) return -1 - line * rowbytes;
                    fill_runs(row, thisrun_, pa_, lastx_);
                    return -1 - (line + 1) * rowbytes;
                }
                one_d = bits(1);
                clear(1);
                pb_ = ref_;
                b1_ = *pb_++;
            }
            r = one_d ? expand_1d() : expand_2d();
            if (r == 3) return -1 - line * rowbytes;
            if (r == 2) {
                fill_runs(row, thisrun_, pa_, lastx_);
                return -1 - (line + 1) * rowbytes;
            }
        }
        fill_runs(row, thisrun_, pa_, lastx_);
        if (compression_ == 2) {
            clear(avail_ & 7);  // rows start on a byte
        } else if (compression_ == 32771) {  // on a 16-bit word of the strip
            clear(avail_ & 15);
            if (avail_ == 0 && ((cp_ - start_) & 1)) ++cp_;
        }
        if (two_d_) {
            if (pa_ < thisrun_ + nruns_) {
                set_value(0);  // an imaginary change for the reference line
            } else if (compression_ == 4) {
                return -1 - (line + 1) * rowbytes;
            }
            uint32_t* swap = cur_;
            cur_ = ref_;
            ref_ = swap;
        }
    }
    return rows * rowbytes;
}

}  // namespace

extern "C" {

// CCITT data ``src`` of one strip or tile: compression 2, 3, 4 or 32771; rows of
// ``width`` pixels, ``rows`` of them into ``dst`` (zeroed, each row
// (width + 7) / 8 bytes); ``t4_options`` bit 0 reads Group 3 2D.  A
// Group 4 strip that libtiff reads without error although it ends early
// returns the bytes of its rows written, fewer than its rows hold.
// ``state`` [0] (in and out) is 1 once libtiff reads the page's Group 3
// data without EOLs, and ``runs`` (``n_runs`` of them, zeroed for a
// page's first strip) libtiff's run arrays: its codec keeps both from
// strip to strip.  Returns
// the bytes written, or -1 - the bytes of the rows written before
// libtiff's decoder fails.  ``stats`` (kStats counts, or null) counts the
// codes read.
int64_t ccitt_decode(const uint8_t* src, int64_t n, int compression, int64_t width, int64_t rows,
                     int t4_options, uint8_t* dst, int32_t* state, uint32_t* runs, int64_t n_runs,
                     int64_t* stats) {
    if (width <= 0 || width > 0x7FFFFFF || rows <= 0 ||
        ((compression < 2 || compression > 4) && compression != 32771))
        return -1;
    const bool two_d = compression == 4 || (compression == 3 && (t4_options & 1));
    if (n_runs < static_cast<int64_t>(2 * Decoder::nruns(static_cast<uint32_t>(width), two_d) + 2))
        return -1;
    Decoder d(src, n, compression, static_cast<uint32_t>(width), t4_options, state[0] != 0, runs,
              stats);
    const int64_t got = d.run(dst, rows, (width + 7) / 8);
    state[0] = d.noeol();
    return got;
}

}  // extern "C"
