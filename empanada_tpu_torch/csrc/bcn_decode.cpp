// Host decoders of the block-compressed texture formats BC1 to BC7, for
// data/textures.py (DDS, FTEX and BLP2's DXT).  Each block is a 4 x 4 tile
// decoded on its own, as the Direct3D 11 and Khronos Data Format
// specifications define BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4, BC5,
// BC6H and BC7, and converted to 8-bit samples as PIL 12.1's decoders do:
//
// - "pil" (PIL's C decoder, for DDS and FTEX): 5-6-5 colours widened by
//   repeating their top bits; BC2 and BC3 colour blocks always of four
//   colours; BC1 of three colours and transparent black where c0 <= c1;
//   a signed BC4/BC5 channel read as its value + 128; BC6H's half floats
//   clamped to [0, 1] and truncated to 255 levels; BC7's reserved mode 8
//   opaque black;
// - "blp" (BlpImagePlugin's decode_dxt1/3/5, BC1 to BC3 alone): 5-6-5
//   colours shifted left, their low bits 0.
//
// bcn_decode writes the whole surface, (height, width, channels) bytes:
// 4 channels (RGBA) for BC1, BC2, BC3 and BC7, 1 for BC4, 3 (RGB) for BC5
// and BC6H; blocks past the right or bottom edge are cut, as PIL cuts
// them.  The "blp" rule writes every block whole, (4 * rows of blocks,
// 4 * blocks a row, 4).  The caller checks that the data holds every
// block; the return value is the number of bytes read.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Rgba {
    uint8_t r, g, b, a;
};

// bit ``at`` (and the ``n`` from it, least significant first) of a
// 128-bit block
inline int bit(const uint8_t* s, int at) { return (s[at >> 3] >> (at & 7)) & 1; }

inline int bits(const uint8_t* s, int at, int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v |= bit(s, at + i) << i;
    return v;
}

inline int load16(const uint8_t* p) { return p[0] | (p[1] << 8); }

Rgba rgb565(int c, bool blp) {
    int r = (c >> 11) & 31, g = (c >> 5) & 63, b = c & 31;
    if (blp) return {uint8_t(r << 3), uint8_t(g << 2), uint8_t(b << 3), 255};
    return {uint8_t((r << 3) | (r >> 2)), uint8_t((g << 2) | (g >> 4)),
            uint8_t((b << 3) | (b >> 2)), 255};
}

// BC1's colour block at ``s`` (8 bytes); ``four`` forces four colours
// (BC2, BC3)
void bc1_colours(Rgba* col, const uint8_t* s, bool four, bool blp) {
    const int c0 = load16(s), c1 = load16(s + 2);
    Rgba p[4];
    p[0] = rgb565(c0, blp);
    p[1] = rgb565(c1, blp);
    if (c0 > c1 || four) {
        p[2] = {uint8_t((2 * p[0].r + p[1].r) / 3), uint8_t((2 * p[0].g + p[1].g) / 3),
                uint8_t((2 * p[0].b + p[1].b) / 3), 255};
        p[3] = {uint8_t((p[0].r + 2 * p[1].r) / 3), uint8_t((p[0].g + 2 * p[1].g) / 3),
                uint8_t((p[0].b + 2 * p[1].b) / 3), 255};
    } else {
        p[2] = {uint8_t((p[0].r + p[1].r) / 2), uint8_t((p[0].g + p[1].g) / 2),
                uint8_t((p[0].b + p[1].b) / 2), 255};
        p[3] = {0, 0, 0, 0};
    }
    const uint32_t lut = uint32_t(s[4]) | (uint32_t(s[5]) << 8) | (uint32_t(s[6]) << 16) |
                         (uint32_t(s[7]) << 24);
    for (int n = 0; n < 16; ++n) col[n] = p[(lut >> (2 * n)) & 3];
}

// BC3's alpha block (BC4's and BC5's channels) at ``s`` into byte
// ``o`` of each of 16 pixels ``stride`` bytes apart; a signed one read as
// its value + 128
void bc3_alpha(uint8_t* dst, const uint8_t* s, int stride, int o, bool sign) {
    const int a0 = sign ? int(int8_t(s[0])) + 128 : s[0];
    const int a1 = sign ? int(int8_t(s[1])) + 128 : s[1];
    int a[8] = {a0, a1};
    if (a0 > a1) {
        for (int k = 1; k < 7; ++k) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
    } else {
        for (int k = 1; k < 5; ++k) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
        a[6] = 0;
        a[7] = 255;
    }
    uint64_t lut = 0;
    for (int k = 0; k < 6; ++k) lut |= uint64_t(s[2 + k]) << (8 * k);
    for (int n = 0; n < 16; ++n) dst[stride * n + o] = uint8_t(a[(lut >> (3 * n)) & 7]);
}

// ----- BC6H -------------------------------------------------------------

// for each mode: regions, whether its endpoints are deltas, partition
// bits, endpoint bits, delta bits of red, green and blue
struct Bc6Mode {
    uint8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// the specification's endpoint bit layout of each mode, bit after bit:
// (endpoint << 4) | bit, endpoints r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3
const uint8_t kBc6Packing[14][75] = {
    {0x74, 0x84, 0xb4, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3},
    {0x75, 0xa4, 0xa5, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0xb0, 0xb1, 0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x85, 0xb2, 0x74, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0xb3, 0xb5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x90, 0x91, 0x92, 0x93, 0x94, 0x95},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x0a, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x1a, 0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x2a, 0xb1, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x0a, 0xa4, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x1a, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x2a, 0xb1, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0xb0, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x74, 0xb3, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x0a, 0x84, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x1a, 0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x2a, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0xb1, 0xb2, 0x90, 0x91, 0x92, 0x93, 0xb4, 0xb3, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x74, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xa4, 0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0xb2, 0x74, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0xb3, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x90, 0x91, 0x92, 0x93, 0x94, 0x95, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xb0, 0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x75, 0x74, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0xa5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xb1, 0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x85, 0x74, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0xb5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0xa4, 0xb0, 0xb1, 0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x75, 0x85, 0xb2, 0x74, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0xa5, 0xb3, 0xb5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x80, 0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x90, 0x91, 0x92, 0x93, 0x94, 0x95, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x36, 0x37, 0x38, 0x0a, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x1a, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x2a, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x36, 0x37, 0x0b, 0x0a, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x1b, 0x1a, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x2b, 0x2a, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x0f, 0x0e, 0x0d, 0x0c, 0x0b, 0x0a, 0x40, 0x41, 0x42, 0x43, 0x1f, 0x1e, 0x1d, 0x1c, 0x1b, 0x1a, 0x50, 0x51, 0x52, 0x53, 0x2f, 0x2e, 0x2d, 0x2c, 0x2b, 0x2a, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00}
};

// the interpolation weights of 2-, 3- and 4-bit indices
const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int n) { return n == 2 ? kWeights2 : n == 3 ? kWeights3 : kWeights4; }

// the two-region partitions (bit i: the region of pixel i), the
// three-region ones (2 bits a pixel), and the anchor pixels of region 2 of
// two, and of regions 2 and 3 of three
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15};
const uint8_t kAnchor3a[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3};
const uint8_t kAnchor3b[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8};

int region(int ns, int partition, int pixel) {
    if (ns == 2) return (kPartition2[partition] >> pixel) & 1;
    if (ns == 3) return (kPartition3[partition] >> (2 * pixel)) & 3;
    return 0;
}

bool anchor(int ns, int partition, int pixel) {
    if (pixel == 0) return true;
    if (ns == 2) return pixel == kAnchor2[partition];
    if (ns == 3) return pixel == kAnchor3a[partition] || pixel == kAnchor3b[partition];
    return false;
}

int sign_extend(int v, int n) { return (v & (1 << (n - 1))) ? v - (1 << n) : v; }

int bc6_unquantize(int v, int epb, bool sign) {
    if (!sign) {
        if (epb >= 15 || v == 0) return v;
        if (v == (1 << epb) - 1) return 0xffff;
        return ((v << 15) + 0x4000) >> (epb - 1);
    }
    v = int16_t(v);  // PIL keeps the endpoints in 16 bits
    if (epb >= 16) return v;
    const bool neg = v < 0;
    int x = neg ? -v : v;
    if (x != 0) x = x >= (1 << (epb - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (epb - 1);
    return neg ? -x : x;
}

// a half float's bits as a float, through the 32-bit pattern
float half_to_float(uint16_t h) {
    uint32_t u = uint32_t(h & 0x7fff) << 13;
    float f;
    std::memcpy(&f, &u, 4);
    f *= 5.192296858534828e33f;  // 2^112
    if (f >= 65536.0f) {
        std::memcpy(&u, &f, 4);
        u |= 255u << 23;
        std::memcpy(&f, &u, 4);
    }
    std::memcpy(&u, &f, 4);
    u |= uint32_t(h & 0x8000) << 16;
    std::memcpy(&f, &u, 4);
    return f;
}

uint8_t bc6_sample(int v, bool sign) {
    uint16_t h;
    if (sign)
        h = v < 0 ? uint16_t(0x8000 | ((-v) * 31 / 32)) : uint16_t(v * 31 / 32);
    else
        h = uint16_t(v * 31 / 64);
    const float f = half_to_float(h);
    if (f < 0.0f) return 0;
    if (f > 1.0f) return 255;
    return uint8_t(f * 255.0f);
}

void bc6_block(uint8_t* col, const uint8_t* s, bool sign) {  // 16 RGB pixels
    int mode = s[0] & 0x1f, at = 5, epbits = 72, ib = 3;
    if ((mode & 3) < 2) {
        mode &= 3;
        at = 2;
        epbits = 75;
    } else if ((mode & 3) == 2) {
        mode = 2 + (mode >> 2);
    } else {
        mode = 10 + (mode >> 2);
        epbits = 60;
        ib = 4;
    }
    if (mode >= 14) {  // a reserved mode: black
        std::memset(col, 0, 48);
        return;
    }
    const Bc6Mode& m = kBc6Modes[mode];
    int e[12] = {0};
    for (int i = 0; i < epbits; ++i) {
        const int d = kBc6Packing[mode][i];
        e[d >> 4] |= bit(s, at + i) << (d & 15);
    }
    at += epbits;
    const int partition = bits(s, at, m.pb);
    at += m.pb;
    const int numep = m.ns == 2 ? 12 : 6, mask = (1 << m.epb) - 1;
    const int db[3] = {m.rb, m.gb, m.bb};
    // PIL: a signed base endpoint is sign-extended; a delta is added to it
    // and cut to the endpoint's bits, and stays unsigned
    if (sign)
        for (int c = 0; c < 3; ++c) e[c] = sign_extend(e[c], m.epb);
    for (int i = 3; i < numep; ++i) {
        if (m.tr)
            e[i] = (e[i % 3] + sign_extend(e[i], db[i % 3])) & mask;
        else if (sign)
            e[i] = sign_extend(e[i], m.epb);
    }
    int u[12];
    for (int i = 0; i < numep; ++i) u[i] = bc6_unquantize(e[i], m.epb, sign);
    const uint8_t* w = weights(ib);
    for (int p = 0; p < 16; ++p) {
        const int r = region(m.ns, partition, p);
        const int n = anchor(m.ns, partition, p) ? ib - 1 : ib;
        const int idx = bits(s, at, n);
        at += n;
        const int* a = u + 6 * r;
        for (int c = 0; c < 3; ++c) {
            const int v = (a[c] * (64 - w[idx]) + a[3 + c] * w[idx]) >> 6;  // PIL: no rounding
            col[3 * p + c] = bc6_sample(v, sign);
        }
    }
}

// ----- BC7 --------------------------------------------------------------

struct Bc7Mode {
    uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

void bc7_block(Rgba* col, const uint8_t* s) {
    if (s[0] == 0) {  // reserved mode 8
        for (int p = 0; p < 16; ++p) col[p] = {0, 0, 0, 255};
        return;
    }
    int mode = 0;
    while (!((s[0] >> mode) & 1)) ++mode;
    const Bc7Mode& m = kBc7Modes[mode];
    int at = mode + 1;
    const int partition = bits(s, at, m.pb);
    at += m.pb;
    const int rotation = bits(s, at, m.rb);
    at += m.rb;
    const int isb = bits(s, at, m.isb);
    at += m.isb;
    int ep[6][4];  // [region * 2 + end][channel]
    for (int c = 0; c < 4; ++c) {
        const int n = c < 3 ? m.cb : m.ab;
        for (int k = 0; k < 2 * m.ns; ++k) {
            ep[k][c] = n ? bits(s, at, n) : 255;
            at += n;
        }
    }
    int pbit[6] = {0};
    if (m.epb)
        for (int k = 0; k < 2 * m.ns; ++k) pbit[k] = bit(s, at++);
    if (m.spb)
        for (int r = 0; r < m.ns; ++r) pbit[2 * r] = pbit[2 * r + 1] = bit(s, at++);
    for (int k = 0; k < 2 * m.ns; ++k)
        for (int c = 0; c < 4; ++c) {
            int n = c < 3 ? m.cb : m.ab;
            if (!n) continue;
            int v = ep[k][c];
            if (m.epb || m.spb) {
                v = (v << 1) | pbit[k];
                ++n;
            }
            v <<= 8 - n;
            ep[k][c] = v | (v >> n);
        }
    int idx[16], idx2[16];
    for (int p = 0; p < 16; ++p) {
        const int n = anchor(m.ns, partition, p) ? m.ib - 1 : m.ib;
        idx[p] = bits(s, at, n);
        at += n;
    }
    for (int p = 0; m.ib2 && p < 16; ++p) {
        const int n = p == 0 ? m.ib2 - 1 : m.ib2;
        idx2[p] = bits(s, at, n);
        at += n;
    }
    for (int p = 0; p < 16; ++p) {
        const int r = region(m.ns, partition, p);
        const int* e0 = ep[2 * r];
        const int* e1 = ep[2 * r + 1];
        int ci = idx[p], cn = m.ib, ai = idx[p], an = m.ib;
        if (m.ib2) {
            if (isb) {
                ci = idx2[p];
                cn = m.ib2;
            } else {
                ai = idx2[p];
                an = m.ib2;
            }
        }
        int v[4];
        for (int c = 0; c < 4; ++c) {
            const int wt = c < 3 ? weights(cn)[ci] : weights(an)[ai];
            v[c] = (e0[c] * (64 - wt) + e1[c] * wt + 32) >> 6;
        }
        if (rotation) std::swap(v[3], v[rotation - 1]);
        col[p] = {uint8_t(v[0]), uint8_t(v[1]), uint8_t(v[2]), uint8_t(v[3])};
    }
}

// one block of ``format`` as ``channels``-byte pixels into ``px``
void decode_block(int format, bool sign, bool blp, const uint8_t* s, uint8_t* px) {
    Rgba* col = reinterpret_cast<Rgba*>(px);
    switch (format) {
        case 1:
            bc1_colours(col, s, false, blp);
            break;
        case 2:
            bc1_colours(col, s + 8, true, blp);
            for (int n = 0; n < 16; ++n) {
                const int a = (s[n >> 1] >> (4 * (n & 1))) & 15;
                col[n].a = uint8_t(a * 17);
            }
            break;
        case 3:
            bc1_colours(col, s + 8, true, blp);
            bc3_alpha(px, s, 4, 3, false);
            break;
        case 4:
            bc3_alpha(px, s, 1, 0, sign);
            break;
        case 5:
            std::memset(px, sign ? 128 : 0, 48);  // blue: 0, or 128 (0 + 128) signed
            bc3_alpha(px, s, 3, 0, sign);
            bc3_alpha(px, s + 8, 3, 1, sign);
            break;
        case 6:
            bc6_block(px, s, sign);
            break;
        default:
            bc7_block(col, s);
    }
}

const int kBlockBytes[8] = {0, 8, 16, 16, 8, 16, 16, 16};
const int kChannels[8] = {0, 4, 4, 4, 1, 3, 3, 4};

}  // namespace

extern "C" {

// (bytes a block, channels a pixel) of ``format`` (1-7: BC1-BC7) in
// ``out``; -1 for a format it does not know.
int bcn_layout(int format, int64_t* out) {
    if (format < 1 || format > 7) return -1;
    out[0] = kBlockBytes[format];
    out[1] = kChannels[format];
    return 0;
}

// The (height, width) surface of ``format`` (1-7: BC1-BC7) at ``src``:
// ``flags`` bit 0 a signed format (BC4, BC5, BC6H), bit 1 the "blp" rule
// (BC1-BC3; every block written whole).  Returns the bytes read, or -1
// for a format it does not know or data that holds too few blocks.
int64_t bcn_decode(const uint8_t* src, int64_t n, int format, int flags, int64_t width,
                   int64_t height, uint8_t* dst) {
    if (format < 1 || format > 7 || width < 0 || height < 0) return -1;
    const bool sign = flags & 1, blp = flags & 2;
    if (blp && format > 3) return -1;
    const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
    const int64_t size = kBlockBytes[format];
    if (n < bw * bh * size) return -1;
    const int ch = kChannels[format];
    const int64_t ow = blp ? 4 * bw : width, oh = blp ? 4 * bh : height;
    auto rows = [&](int64_t y0, int64_t y1) {
        uint8_t px[64];
        for (int64_t by = y0; by < y1; ++by)
            for (int64_t bx = 0; bx < bw; ++bx) {
                decode_block(format, sign, blp, src + (by * bw + bx) * size, px);
                for (int j = 0; j < 4; ++j) {
                    const int64_t y = 4 * by + j;
                    if (y >= oh) break;
                    const int64_t x = 4 * bx, k = std::min<int64_t>(4, ow - x);
                    std::memcpy(dst + (y * ow + x) * ch, px + 4 * j * ch, k * ch);
                }
            }
    };
    const int64_t threads = std::min<int64_t>(
        std::max(1u, std::thread::hardware_concurrency()), (bw * bh) / 4096 + 1);
    if (threads <= 1 || bh < 2) {
        rows(0, bh);
    } else {
        std::vector<std::thread> pool;
        const int64_t step = (bh + threads - 1) / threads;
        for (int64_t y = 0; y < bh; y += step)
            pool.emplace_back(rows, y, std::min(bh, y + step));
        for (auto& t : pool) t.join();
    }
    return bw * bh * size;
}

}  // extern "C"
