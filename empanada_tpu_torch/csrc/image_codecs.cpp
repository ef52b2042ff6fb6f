// Host decoders of the compressions zlib does not cover: for
// data/imread.py, TIFF's LZW (compression 5) and PackBits (compression
// 32773); for data/raster.py, GIF's LZW, BMP's RLE8 and RLE4, TGA's RLE
// and Sun raster's byte encoding; for data/plugins.py, SGI's RLE at 8
// and 16 bits, PCX's RLE, QOI's op stream, MSP version 2 rows, Radiance
// HDR's scanlines and IM's samples of 2 to 31 bits; for data/icons.py,
// PSD's PackBits rows and ICNS's RGB runs.
//
// Each call decodes one strip, tile, frame or image into a buffer of the
// size its header says it holds and never writes past it.  The return
// value is the number of bytes (or pixels, or rows) written (less than
// the capacity when the data runs out), or -1 when the stream holds a
// code it cannot (damaged data); the caller raises on either and names
// the file (and the page, strip or frame).

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
            if (code > 255) return -1 - out;
            dst[out++] = static_cast<uint8_t>(code);
            prev = code;
            continue;
        }
        if (code > next || (code == next && next == kSize)) return -1 - out;
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
// one byte repeated 1 - h times (-127 <= h <= -1); -128 is skipped.  With
// row == 0 (TIFF, as libtiff's PackBitsDecode) the data runs on across rows
// and a packet cut by the data's end is not read; with row > 0, as PIL's
// PackbitsDecode reads it (PSD), a packet's bytes past the end of its row
// of ``row`` bytes are dropped (the next packet starts the next row) and a
// packet cut by the data's end is not read.  ``used`` gets the bytes read.
static int64_t packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int64_t row,
                        int64_t* used) {
    int64_t pos = 0, out = 0;
    while (out < cap && pos < n) {
        const int h = static_cast<int8_t>(src[pos]);
        const int64_t len = h >= 0 ? h + 1 : (h == -128 ? 0 : 1 - h);
        if (pos + 1 + (h >= 0 ? len : (h == -128 ? 0 : 1)) > n) break;
        ++pos;
        int64_t count = len;
        if (row > 0 && count > row - out % row) count = row - out % row;
        if (count > cap - out) count = cap - out;
        if (h >= 0) {
            if (count > n - pos) count = n - pos;
            std::memcpy(dst + out, src + pos, static_cast<size_t>(count));
            pos += len;
            out += count;
        } else if (h != -128) {
            if (pos >= n) break;
            std::memset(dst + out, src[pos++], static_cast<size_t>(count));
            out += count;
        }
    }
    *used = pos < n ? pos : n;
    return out;
}

int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t used;
    return packbits(src, n, dst, cap, 0, &used);
}

// PSD's PackBits channel (PIL's PackbitsDecode): rows of ``row`` bytes
// from src until ``rows`` are full.  Returns the bytes read, or -1 when
// the data ends first (PIL: the file is truncated).
int64_t packbits_rows_decode(const uint8_t* src, int64_t n, int64_t row, int64_t rows,
                             uint8_t* dst) {
    int64_t used;
    return packbits(src, n, dst, row * rows, row, &used) == row * rows ? used : -1;
}

// ICNS's RGB runs (PIL's read_32): for each of the red, green and blue
// planes of ``size`` samples in turn, a header byte h: h & 0x80, one
// sample repeated h - 125 times; else h + 1 samples as they stand.  A
// plane whose packets overshoot it, or data that ends first, is refused
// (PIL raises): returns 0, or -1.
int icns_rle_decode(const uint8_t* src, int64_t n, int64_t size, uint8_t* dst) {
    int64_t pos = 0;
    for (int band = 0; band < 3; ++band) {
        uint8_t* o = dst + band * size;
        int64_t left = size, got = 0;
        while (left > 0 && pos < n) {
            const int h = src[pos++];
            const int64_t count = h & 0x80 ? h - 125 : h + 1;
            if (count > left) return -1;
            if (h & 0x80) {
                if (pos >= n) return -1;
                std::memset(o + got, src[pos++], static_cast<size_t>(count));
            } else {
                if (count > n - pos) return -1;
                std::memcpy(o + got, src + pos, static_cast<size_t>(count));
                pos += count;
            }
            got += count;
            left -= count;
        }
        if (left != 0) return -1;
    }
    return 0;
}

// IM's samples of 2 to 31 bits (PIL's BitDecode with bits, pad 8, fill 3,
// ystep -1): bytes enter a bit buffer above the bits it holds, samples
// leave from its bottom (least significant bit first); at each row's end
// the count of bits held drops to a multiple of 8 but the buffer is not
// cleared, so the next byte is ORed over what it still holds; more than
// 32 bits held refills it from the last byte.  Rows fill bottom-up into
// dst (h x w float32).  Returns 0, or -1 when the data ends first.
int im_bit_decode(const uint8_t* src, int64_t n, int bits, int64_t w, int64_t h, float* dst) {
    const uint64_t mask = (uint64_t{1} << bits) - 1;
    uint64_t buffer = 0;
    int count = 0;
    int64_t x = 0, y = h - 1;
    for (int64_t pos = 0; pos < n; ++pos) {
        const uint8_t byte = src[pos];
        buffer |= static_cast<uint64_t>(byte) << count;
        count += 8;
        while (count >= bits) {
            const uint64_t v = buffer & mask;
            if (count > 32)
                buffer = byte >> (8 - (count - bits));
            else
                buffer >>= bits;
            count -= bits;
            dst[y * w + x] = static_cast<float>(v);
            if (++x >= w) {
                if (--y < 0) return 0;
                x = 0;
                count -= count % 8;
            }
        }
    }
    return -1;
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
        if (code > next || (code == next && next == kSize)) return -1 - out;
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

// SGI's RLE as PIL's SgiRleDecode reads it: for each row of the file
// (bottom-up) and each of its bands channels, the packets at
// starts[row + channel * ysize] - 512 in src (the file after its 512-byte
// header, n bytes): a header byte (bpc 1) or the low byte of a 16-bit
// word (bpc 2) h, count h & 0x7f: 0 ends the row; with 0x80 count samples
// follow, else one sample repeated count times.  lengths[...] counts
// packets, not bytes (PIL's loop; one of 2^31 or more, negative to PIL's
// int, counts none), and bounds nothing else; a last packet
// that is not 0 stops the image there (PIL keeps the rows read so far).
// Samples land in one row buffer kept from row to row (a short row keeps
// the last row's samples, as PIL's buffer does), copied to dst row by row
// in the file's order (xsize * bands * bpc bytes a row, samples of 2 bytes
// as the file holds them).  Returns the rows copied, or -1 where PIL
// refuses the data (a start before the data, a run past its row, a read
// past the data's last byte, or a copy that reaches it).
int64_t sgi_rle_decode(const uint8_t* src, int64_t n, const uint32_t* starts,
                       const uint32_t* lengths, int64_t xsize, int64_t ysize, int bands, int bpc,
                       uint8_t* row, uint8_t* dst) {
    const int64_t stride = xsize * bands * bpc;
    const int64_t last = n - 1;  // PIL's end_of_buffer, as an index
    std::memset(row, 0, static_cast<size_t>(stride));
    for (int64_t y = 0; y < ysize; ++y) {
        for (int c = 0; c < bands; ++c) {
            const int64_t k = y + c * ysize;
            if (starts[k] < 512) return -1;
            int64_t p = static_cast<int64_t>(starts[k]) - 512;
            uint8_t* out = row + c * bpc;
            int64_t x = 0;
            // PIL passes the length as an int: 2^31 or more reads nothing
            for (int64_t left = static_cast<int32_t>(lengths[k]); left > 0; --left) {
                if (p + bpc - 1 > last) return -1;
                const uint8_t h = src[p + bpc - 1];
                p += bpc;
                if (left == 1 && h != 0) return y;
                const int count = h & 0x7f;
                if (!count) break;
                if (x + count > xsize) return -1;
                x += count;
                if (h & 0x80) {
                    if (p + static_cast<int64_t>(count) * bpc > last) return -1;
                    for (int i = 0; i < count; ++i, p += bpc, out += bands * bpc)
                        std::memcpy(out, src + p, static_cast<size_t>(bpc));
                } else {
                    if (p + bpc - 1 + (bpc == 2) > last) return -1;
                    for (int i = 0; i < count; ++i, out += bands * bpc)
                        std::memcpy(out, src + p, static_cast<size_t>(bpc));
                    p += bpc;
                }
            }
        }
        std::memcpy(dst + y * stride, row, static_cast<size_t>(stride));
    }
    return ysize;
}

// PCX's RLE as PIL's PcxDecode reads it, into rows of row_bytes: a byte
// with its top two bits set is a run of (byte & 0x3f) copies of the next,
// any other byte stands for itself; a run may not cross its row (PIL
// refuses it, -1).  Returns the bytes written (rows * row_bytes when the
// data holds them all).
int64_t pcx_rle_decode(const uint8_t* src, int64_t n, int64_t row_bytes, int64_t rows,
                       uint8_t* dst) {
    const int64_t cap = row_bytes * rows;
    int64_t pos = 0, out = 0;
    while (out < cap && pos < n) {
        const uint8_t b = src[pos];
        if ((b & 0xC0) == 0xC0) {
            if (pos + 1 >= n) break;
            const int64_t count = b & 0x3F;
            if (out % row_bytes + count > row_bytes) return -1;
            std::memset(dst + out, src[pos + 1], static_cast<size_t>(count));
            out += count;
            pos += 2;
        } else {
            dst[out++] = b;
            ++pos;
        }
    }
    return out;
}

// QOI's op stream as PIL's QoiDecoder reads it, into npix RGBA pixels:
// the previous pixel starts as (0, 0, 0, 255) and out of the table; RGB
// and RGBA ops, INDEX (a slot never filled is (0, 0, 0, 0)), DIFF and
// LUMA (modulo 256) each put their pixel in the table at its hash (r * 3
// + g * 5 + b * 7 + a * 11) % 64; a RUN repeats the previous pixel and
// fills no slot (PIL's rule; the format's reference decoder fills one).
// Returns the pixels written; fewer than npix when an op is cut short or
// the stream ends.
int64_t qoi_decode(const uint8_t* src, int64_t n, int64_t npix, uint8_t* dst) {
    uint8_t table[64][4] = {};
    uint8_t px[4] = {0, 0, 0, 255};
    int64_t pos = 0, out = 0;
    while (out < npix) {
        if (pos >= n) return out;
        const uint8_t b = src[pos++];
        if (b == 0xFE || b == 0xFF) {
            const int m = b == 0xFE ? 3 : 4;
            if (pos + m > n) return out;
            std::memcpy(px, src + pos, static_cast<size_t>(m));
            pos += m;
        } else if ((b >> 6) == 0) {
            std::memcpy(px, table[b & 0x3F], 4);
        } else if ((b >> 6) == 1) {
            px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
            px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
            px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
        } else if ((b >> 6) == 2) {
            if (pos >= n) return out;
            const uint8_t b2 = src[pos++];
            const int dg = (b & 0x3F) - 32;
            px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) & 15) - 8);
            px[1] = static_cast<uint8_t>(px[1] + dg);
            px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 15) - 8);
        } else {
            int64_t run = (b & 0x3F) + 1;
            if (run > npix - out) run = npix - out;
            for (int64_t i = 0; i < run; ++i, ++out) std::memcpy(dst + out * 4, px, 4);
            continue;
        }
        std::memcpy(table[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
        std::memcpy(dst + out * 4, px, 4);
        ++out;
    }
    return out;
}

// MSP version 2 as PIL's MspDecoder reads it: rows of rowmap[r] bytes
// from src (the file after its header and row map): 0 is a blank row of
// stride 0xFF bytes; in a row, 0, count, value is a run and any other
// byte a count of bytes that follow (cut at the row's end).  The rows'
// bytes run on into dst (cap bytes kept; PIL joins them before it
// unpacks).  Returns the bytes written, or -1 where PIL refuses the row
// (the file ends within it, or a run's count and value leave it).
int64_t msp_decode(const uint8_t* src, int64_t n, const uint16_t* rowmap, int64_t rows,
                   int64_t stride, uint8_t* dst, int64_t cap) {
    int64_t pos = 0, out = 0;
    auto put = [&](const uint8_t* p, int64_t count, int fill) {
        const int64_t m = count < cap - out ? count : cap - out;
        if (m > 0) {
            if (fill >= 0) std::memset(dst + out, fill, static_cast<size_t>(m));
            else std::memcpy(dst + out, p, static_cast<size_t>(m));
            out += m;
        }
    };
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t len = rowmap[r];
        if (len == 0) {
            put(nullptr, stride, 0xFF);
            continue;
        }
        if (pos + len > n) return -1;
        const uint8_t* row = src + pos;
        int64_t i = 0;
        while (i < len) {
            const int kind = row[i++];
            if (kind == 0) {
                if (i + 2 > len) return -1;
                put(nullptr, row[i], row[i + 1]);
                i += 2;
            } else {
                put(row + i, kind < len - i ? kind : len - i, -1);
                i += kind;
            }
        }
        pos += len;
    }
    return out;
}

// Radiance HDR's scanlines as cv2's RGBE_ReadPixels_RLE reads them into
// h rows of w RGBE pixels: scanlines of new RLE (2, 2, then w as a 16-bit
// big-endian count under 0x8000; each of the four channels in turn as
// runs, 128 + count then a byte, and literals, count then the bytes, of
// counts 1 to what is left of the channel) until a scanline that does not
// begin 2, 2 with the top bit of the third byte clear, from which the
// rest of the image is read flat, 4 bytes a pixel (as is all of it when
// w is under 8 or over 0x7fff).  Old-style runs (1, 1, 1, n) are pixels
// to cv2, which does not expand them.  Returns 0, -1 when the data ends
// first, or -2 for a scanline of another width or a count of 0 or past
// its channel.
int hdr_rle_decode(const uint8_t* src, int64_t n, int64_t w, int64_t h, uint8_t* dst,
                   uint8_t* line) {
    int64_t pos = 0;
    auto flat = [&](int64_t from) -> int {
        const int64_t need = (w * h - from) * 4;
        if (pos + need > n) return -1;
        std::memcpy(dst + from * 4, src + pos, static_cast<size_t>(need));
        return 0;
    };
    if (w < 8 || w > 0x7fff) return flat(0);
    for (int64_t y = 0; y < h; ++y) {
        if (pos + 4 > n) return -1;
        const uint8_t* head = src + pos;
        if (head[0] != 2 || head[1] != 2 || (head[2] & 0x80)) return flat(y * w);
        if (((head[2] << 8) | head[3]) != w) return -2;
        pos += 4;
        for (int c = 0; c < 4; ++c) {
            uint8_t* p = line + c * w;
            uint8_t* end = line + (c + 1) * w;
            while (p < end) {
                if (pos + 2 > n) return -1;
                const int b0 = src[pos], b1 = src[pos + 1];
                pos += 2;
                if (b0 > 128) {
                    const int count = b0 - 128;
                    if (count > end - p) return -2;
                    std::memset(p, b1, static_cast<size_t>(count));
                    p += count;
                } else {
                    if (b0 == 0 || b0 > end - p) return -2;
                    *p++ = static_cast<uint8_t>(b1);
                    const int rest = b0 - 1;
                    if (rest > 0) {
                        if (pos + rest > n) return -1;
                        std::memcpy(p, src + pos, static_cast<size_t>(rest));
                        p += rest;
                        pos += rest;
                    }
                }
            }
        }
        uint8_t* row = dst + y * w * 4;
        for (int64_t x = 0; x < w; ++x)
            for (int c = 0; c < 4; ++c) row[x * 4 + c] = line[c * w + x];
    }
    return 0;
}

}  // extern "C"
