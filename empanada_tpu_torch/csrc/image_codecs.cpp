// Host decoders of the TIFF compressions zlib does not cover, for
// data/imread.py: LZW (compression 5) and PackBits (compression 32773).
//
// Each call decodes one strip or tile into a buffer of the size the page
// says it holds and never writes past it.  The return value is the number
// of bytes written (less than the capacity when the data runs out), or -1
// when the stream holds a code it cannot (a damaged strip); the caller
// raises on either and names the file, the page and the strip.

#include <cstdint>
#include <cstring>

extern "C" {

// TIFF's LZW: codes of 9 to 12 bits, most significant bit first; 256
// clears the table, 257 ends the strip; the code width grows one code
// early (when the next free entry is 2^n - 1), as libtiff writes it.
int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    const int kClear = 256, kEnd = 257, kFirst = 258, kSize = 4096;
    uint16_t prefix[kSize];
    uint16_t length[kSize];
    uint8_t suffix[kSize];
    uint8_t first[kSize];
    for (int i = 0; i < 256; ++i) {
        prefix[i] = 0;
        length[i] = 1;
        suffix[i] = static_cast<uint8_t>(i);
        first[i] = static_cast<uint8_t>(i);
    }
    if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -1;  // pre-1995 bit order
    int width = 9, next = kFirst, prev = -1, bits = 0;
    uint64_t buf = 0;
    int64_t pos = 0, out = 0;
    while (out < cap) {
        while (bits < width) {
            if (pos >= n) return out;
            buf = (buf << 8) | src[pos++];
            bits += 8;
        }
        bits -= width;
        const int code = static_cast<int>((buf >> bits) & ((1u << width) - 1));
        if (code == kEnd) break;
        if (code == kClear) {
            width = 9;
            next = kFirst;
            prev = -1;
            continue;
        }
        if (prev < 0) {  // the first code after a clear is a byte
            if (code > 255) return -1;
            dst[out++] = static_cast<uint8_t>(code);
            prev = code;
            continue;
        }
        if (code > next || (code == next && next == kSize)) return -1;
        if (next < kSize) {
            prefix[next] = static_cast<uint16_t>(prev);
            length[next] = static_cast<uint16_t>(length[prev] + 1);
            first[next] = first[prev];
            suffix[next] = code < next ? first[code] : first[prev];
            ++next;
            if (next >= (1 << width) - 1 && width < 12) ++width;
        }
        // the string of code, written back to front; cut at the capacity
        const int64_t len = length[code];
        int c = code;
        int64_t i = out + len - 1;
        for (; i >= cap; --i) c = prefix[c];
        for (; i > out; --i) {
            dst[i] = suffix[c];
            c = prefix[c];
        }
        dst[out] = suffix[c];
        out = out + len < cap ? out + len : cap;
        prev = code;
    }
    return out;
}

// PackBits: a header byte h, then h + 1 literal bytes (0 <= h <= 127) or
// one byte repeated 1 - h times (-127 <= h <= -1); -128 is skipped.
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t pos = 0, out = 0;
    while (out < cap && pos < n) {
        const int h = static_cast<int8_t>(src[pos++]);
        if (h >= 0) {
            int64_t count = h + 1;
            if (count > n - pos) count = n - pos;
            if (count > cap - out) count = cap - out;
            std::memcpy(dst + out, src + pos, static_cast<size_t>(count));
            pos += h + 1;
            out += count;
        } else if (h != -128) {
            if (pos >= n) break;
            int64_t count = 1 - h;
            if (count > cap - out) count = cap - out;
            std::memset(dst + out, src[pos++], static_cast<size_t>(count));
            out += count;
        }
    }
    return out;
}

}  // extern "C"
