// Host decoders of the compressions zlib does not cover: for
// data/imread.py, TIFF's LZW (compression 5) and PackBits (compression
// 32773); for data/raster.py, GIF's LZW, BMP's RLE8 and RLE4, TGA's RLE
// and Sun raster's byte encoding.
//
// Each call decodes one strip, tile, frame or image into a buffer of the
// size its header says it holds and never writes past it.  The return
// value is the number of bytes written (less than the capacity when the
// data runs out), or -1 when the stream holds a code it cannot (damaged
// data); the caller raises on either and names the file (and the page,
// strip or frame).

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

// GIF's LZW: codes of min_size + 1 to 12 bits, least significant bit
// first; 1 << min_size clears the table and the width, the code after it
// ends the image; the width grows when the next free entry reaches
// 1 << width (no early change), and a full table (4096 entries) adds
// nothing until the next clear.
int64_t gif_lzw_decode(const uint8_t* src, int64_t n, int min_size, uint8_t* dst,
                       int64_t cap) {
    const int kSize = 4096;
    if (min_size < 2 || min_size > 8) return -1;
    const int clear = 1 << min_size, end = clear + 1;
    uint16_t prefix[kSize];
    uint16_t length[kSize];
    uint8_t suffix[kSize];
    uint8_t first[kSize];
    for (int i = 0; i < clear; ++i) {
        prefix[i] = 0;
        length[i] = 1;
        suffix[i] = static_cast<uint8_t>(i);
        first[i] = static_cast<uint8_t>(i);
    }
    int width = min_size + 1, next = clear + 2, prev = -1, bits = 0;
    uint64_t buf = 0;
    int64_t pos = 0, out = 0;
    while (out < cap) {
        while (bits < width) {
            if (pos >= n) return out;
            buf |= static_cast<uint64_t>(src[pos++]) << bits;
            bits += 8;
        }
        const int code = static_cast<int>(buf & ((1u << width) - 1));
        buf >>= width;
        bits -= width;
        if (code == clear) {
            width = min_size + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == end) break;
        if (prev < 0) {  // the first code after a clear is a pixel
            if (code > clear) return -1;
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
            if (next == (1 << width) && width < 12) ++width;
        }
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

// BMP's RLE8 and RLE4 (rle4 != 0) into h rows of w indices, in the file's
// row order, on a buffer the caller zeroed: (count, value) draws count
// pixels (RLE4: the value's high and low nibbles in turn); (0, 0) ends the
// row, (0, 1) the bitmap, (0, 2, dx, dy) moves dx right and dy rows on;
// (0, n >= 3) is n pixels as they stand (RLE4: two a byte), padded to a
// 16-bit word.  Pixels drawn into a full row go on at the next row, as
// cv2 reads RLE8; pixels skipped keep index 0; codes after the last row
// are ignored.  Returns the pixels up to the last one drawn or skipped
// (h * w after an end of bitmap), or -1 when pixels or a move leave their
// row or the image (damaged data).
int64_t bmp_rle_decode(const uint8_t* src, int64_t n, int64_t w, int64_t h, int rle4,
                       uint8_t* dst) {
    int64_t pos = 0, x = 0, y = 0;
    while (y < h && pos + 1 < n) {
        const int count = src[pos], value = src[pos + 1];
        pos += 2;
        if (count || value > 2) {  // a run, or pixels as they stand
            if (x == w) {
                x = 0;
                if (++y == h) break;
            }
            const int m = count ? count : value;
            if (x + m > w) return -1;
            uint8_t* row = dst + y * w + x;
            if (count) {
                if (rle4) {
                    for (int i = 0; i < m; ++i) row[i] = (i & 1) ? (value & 15) : (value >> 4);
                } else {
                    std::memset(row, value, static_cast<size_t>(m));
                }
            } else {
                const int64_t size = rle4 ? (m + 1) / 2 : m;
                if (pos + size > n) break;
                for (int i = 0; i < m; ++i) {
                    const uint8_t b = src[pos + (rle4 ? i / 2 : i)];
                    row[i] = !rle4 ? b : ((i & 1) ? (b & 15) : (b >> 4));
                }
                pos += size + (size & 1);
            }
            x += m;
        } else if (value == 0) {  // end of row
            x = 0;
            ++y;
        } else if (value == 1) {  // end of bitmap
            return h * w;
        } else {  // delta
            if (pos + 1 >= n) break;
            x += src[pos];
            y += src[pos + 1];
            pos += 2;
            if (x > w || y > h || (y == h && x > 0)) return -1;
        }
    }
    return y >= h ? h * w : y * w + x;
}

// TGA's RLE: a header byte h, then (h & 0x7f) + 1 pixels of bpp bytes: one
// pixel repeated (h & 0x80) or as many pixels as they stand.  A repeated
// pixel's packet must end within its row of row bytes (PIL's decoder
// requires it); a packet of pixels as they stand may cross rows, and one
// past the last row is cut.
int64_t tga_rle_decode(const uint8_t* src, int64_t n, int bpp, int64_t row, uint8_t* dst,
                       int64_t cap) {
    int64_t pos = 0, out = 0;
    while (out < cap && pos < n) {
        const int h = src[pos++];
        const int64_t size = static_cast<int64_t>((h & 0x7f) + 1) * bpp;
        if (h & 0x80) {
            if (pos + bpp > n) break;
            if (out % row + size > row) return -1;
            for (int64_t i = 0; i < size; i += bpp) std::memcpy(dst + out + i, src + pos, bpp);
            pos += bpp;
            out += size;
        } else {
            if (pos + size > n) break;
            const int64_t count = size < cap - out ? size : cap - out;
            std::memcpy(dst + out, src + pos, static_cast<size_t>(count));
            pos += size;
            out += count;
        }
    }
    return out;
}

// Sun raster's byte encoding: 0x80 0x00 is one byte 0x80, 0x80 k v is
// k + 1 bytes v, any other byte stands for itself.
int64_t sun_rle_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t pos = 0, out = 0;
    while (out < cap && pos < n) {
        const uint8_t b = src[pos];
        if (b != 0x80) {
            dst[out++] = b;
            ++pos;
            continue;
        }
        if (pos + 1 >= n) break;
        if (src[pos + 1] == 0) {
            dst[out++] = 0x80;
            pos += 2;
            continue;
        }
        if (pos + 2 >= n) break;
        int64_t count = static_cast<int64_t>(src[pos + 1]) + 1;
        if (count > cap - out) count = cap - out;
        std::memset(dst + out, src[pos + 2], static_cast<size_t>(count));
        out += count;
        pos += 3;
    }
    return out;
}

}  // extern "C"
