// A WebP decoder for data/webp.py: the VP8L (lossless) and VP8 (lossy key
// frame) bitstreams and the ALPH chunk that PIL and cv2 read through
// libwebp, decoded to the same samples.  The container (RIFF, VP8X, ANIM,
// ANMF) and the composing of animation frames are data/webp.py's.
//
// VP8L follows RFC 9649: the header, the four transforms (predictor with its
// 14 modes, cross-colour, subtract-green, colour indexing with pixel
// bundling), simple and normal prefix codes with the code-length code, meta
// prefix codes through the entropy image, LZ77 back-references with the
// 120-entry distance map, the colour cache, and the headerless image stream
// of an ALPH chunk.  Reading past the end of the stream is an error, as in
// libwebp's VP8LBitReader (which reads zeros up to 64 bits of a stream
// shorter than 8 bytes).
//
// VP8 follows RFC 6386 as libwebp's src/dec/ does it: the boolean decoder,
// the frame header (segments, the filter header, the quantizers with
// VP8ParseQuant's clamps, the token-probability updates, the skip
// probability), intra modes, tokens, dequantization, the inverse WHT and
// DCT, the predictors with their 127/129 borders, the normal loop filter
// (libwebp's per-segment strengths, its inner-edge skip, its order of
// edges), and YUV 4:2:0 -> RGB with the fancy upsampler of
// src/dsp/upsampling.c and the fixed-point VP8YUVToR/G/B of src/dsp/yuv.h.
// The forms that no encoder here writes are refused by name: the simple
// loop filter, sharpness, loop-filter deltas, more than one token
// partition; and inter frames and profiles above 3, as libwebp refuses them.
//
// ALPH: the header byte, raw or VP8L-compressed (the green channel) alpha,
// then the unfiltering of src/dsp/filters.c (none, horizontal, vertical,
// gradient).
//
// webp_vp8l_info and webp_vp8_info read a bitstream's headers (VP8L: also
// its transforms and prefix codes) without allocating its pixels, so that
// the caller sizes its buffer from a header the data can back; the decoders
// write RGBA (VP8: alpha 255) and, given ``stats``, what the stream used.
// Each returns 0, or -1 with the reason in err.

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

void set_error(char* err, int64_t cap, const char* what) {
    if (cap <= 0) return;
    std::strncpy(err, what, static_cast<size_t>(cap - 1));
    err[cap - 1] = 0;
}

// RFC 6386 13.5: the default token probabilities [type][band][context][node]
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189, 129, 242, 255,
    227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128,
    128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238,
    254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219,
    128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150,
    247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128,
    128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170,
    139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255,
    255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211,
    171, 128, 128, 128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128,
    128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255,
    194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162, 160,
    145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68, 47,
    146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255,
    255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81,
    99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197,
    242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234,
    255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245, 255, 255, 128, 128,
    128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251,
    219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128,
    128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249,
    255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128,
    128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1, 157,
    247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255,
    255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1,
    1, 251, 255, 213, 255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128,
    128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193,
    185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234,
    128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250,
    211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128,
    128, 128, 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219,
    255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228,
    128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165,
    249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128,
    128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190,
    36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128,
    128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160,
    240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46,
    138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247,
    159, 255, 255, 128, 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39,
    77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199,
    249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219,
    240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128,
    128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252,
    204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128,
    128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248,
    255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255,
    128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121,
    236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255,
    219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1,
    1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 13.4: the probability that each of them is updated
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223, 241, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255,
    255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255, 234, 250,
    241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238,
    253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255,
    255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255,
    255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254,
    249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255,
    255, 255, 255, 255, 246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252,
    254, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 11.5: the key-frame sub-block mode probabilities [above][left][node],
// the modes in libwebp's order (DC TM VE HE RD VR LD VL HD HU)
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
// RFC 6386 14.1: the quantizer steps of the DC and AC coefficients by index
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// RFC 9649 5.2.2: the 120 short distance codes, (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ===== VP8L ================================================================

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// the alphabets of green (+ the colour cache), red, blue, alpha, distance
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// LSB-first bits; reading past the end raises (libwebp's eos_: past 8 *
// max(length, 8) bits)
class LBits {
  public:
    LBits(const uint8_t* p, size_t n) : buf_(p), len_(n), limit_(8 * std::max<uint64_t>(n, 8)) {}
    uint32_t peek(int n) const {
        const uint64_t v = load64(pos_ >> 3) >> (pos_ & 7);
        return static_cast<uint32_t>(v & ((uint64_t{1} << n) - 1));
    }
    void skip(int n) {
        pos_ += static_cast<uint64_t>(n);
        if (pos_ > limit_) throw Error("the VP8L stream ends early");
    }
    uint32_t read(int n) {
        const uint32_t v = peek(n);
        skip(n);
        return v;
    }

  private:
    uint64_t load64(uint64_t at) const {
        uint64_t v = 0;
        if (at + 8 <= len_) {
            for (int i = 7; i >= 0; --i) v = (v << 8) | buf_[at + i];
        } else {
            for (uint64_t i = 0; i < 8 && at + i < len_; ++i)
                v |= uint64_t{buf_[at + i]} << (8 * i);
        }
        return v;
    }
    const uint8_t* buf_;
    uint64_t len_, limit_, pos_ = 0;
};

// a canonical prefix code: a code of one symbol reads no bits; codes up to 8
// bits through the root table, longer ones symbol by symbol
struct Prefix {
    int single = -1;
    uint16_t root[256];  // (length << 12) | symbol; 0 for a longer code
    uint16_t count[16];
    std::vector<uint16_t> sorted;
};

// libwebp's VP8LBuildHuffmanTable: false for lengths all zero, over-subscribed
// or incomplete (a single symbol of any length is a code of no bits)
bool build_prefix(Prefix& h, const int* lens, int n) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) {
        if (lens[i] < 0 || lens[i] > 15) return false;
        ++count[lens[i]];
    }
    if (count[0] == n) return false;
    h.single = -1;
    h.sorted.clear();
    for (int len = 1; len <= 15; ++len)
        for (int i = 0; i < n; ++i)
            if (lens[i] == len) h.sorted.push_back(static_cast<uint16_t>(i));
    if (h.sorted.size() == 1) {
        h.single = h.sorted[0];
        return true;
    }
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
        left = (left << 1) - count[len];
        if (left < 0) return false;
    }
    if (left != 0) return false;
    std::memset(h.root, 0, sizeof(h.root));
    int code = 0, k = 0;
    for (int len = 1; len <= 15; ++len) {
        h.count[len] = static_cast<uint16_t>(count[len]);
        for (int c = 0; c < count[len]; ++c, ++code, ++k) {
            if (len > 8) continue;
            int rev = 0;  // the stream holds the code's first bit first
            for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
            for (int j = rev; j < 256; j += 1 << len)
                h.root[j] = static_cast<uint16_t>((len << 12) | h.sorted[k]);
        }
        code <<= 1;
    }
    return true;
}

inline int read_symbol(const Prefix& h, LBits& br) {
    if (h.single >= 0) return h.single;
    const uint32_t bits = br.peek(15);
    const uint16_t e = h.root[bits & 255];
    if (e) {
        br.skip(e >> 12);
        return e & 0xfff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
        code |= (bits >> (len - 1)) & 1;
        const int c = h.count[len];
        if (code - first < c) {
            br.skip(len);
            return h.sorted[index + code - first];
        }
        index += c;
        first = (first + c) << 1;
        code <<= 1;
    }
    throw Error("a VP8L prefix code out of its table");  // a complete code cannot get here
}

struct Group {
    Prefix code[5];
};

// what an image stream reads before its pixels
struct Entropy {
    int cache_bits = 0;
    int meta_bits = 0, meta_xs = 0;  // meta_bits 0: one group
    std::vector<uint32_t> meta;      // group of each tile
    std::vector<Group> groups;
};

struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t select_pixel(uint32_t a, uint32_t b, uint32_t c) {  // a top, b left, c top-left
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
        const int ca = (a >> s) & 0xff, cb = (b >> s) & 0xff, cc = (c >> s) & 0xff;
        d += std::abs(cb - cc) - std::abs(ca - cc);
    }
    return d <= 0 ? a : b;
}

uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= static_cast<uint32_t>(clip255(static_cast<int>((c0 >> s) & 0xff) +
                                             static_cast<int>((c1 >> s) & 0xff) -
                                             static_cast<int>((c2 >> s) & 0xff))) << s;
    return out;
}

uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
        out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
    }
    return out;
}

// libwebp's VP8LPredictorsAdd: modes 14 and 15 predict black, as 0 does
uint32_t predict(int mode, const uint32_t* p, int width) {
    const uint32_t L = p[-1], T = p[-width], TL = p[-width - 1], TR = p[-width + 1];
    switch (mode) {
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return average2(average2(L, TR), T);
        case 6: return average2(L, TL);
        case 7: return average2(L, T);
        case 8: return average2(TL, T);
        case 9: return average2(T, TR);
        case 10: return average2(average2(L, TL), average2(T, TR));
        case 11: return select_pixel(T, L, TL);
        case 12: return clamped_full(L, T, TL);
        case 13: return clamped_half(L, T, TL);
        default: return 0xff000000u;
    }
}

class VP8L {
  public:
    VP8L(const uint8_t* p, size_t n) : br_(p, n) {}

    // the header of a VP8L chunk: (width, height, alpha hint)
    void header(int& w, int& h, int& alpha) {
        if (br_.read(8) != 0x2f) throw Error("a VP8L chunk without its signature byte 0x2f");
        w = static_cast<int>(br_.read(14)) + 1;
        h = static_cast<int>(br_.read(14)) + 1;
        alpha = static_cast<int>(br_.read(1));
        if (br_.read(3) != 0) throw Error("a VP8L stream of a version other than 0");
    }

    // the transforms and prefix codes of the level-0 image stream of w x h
    void prelude(int w, int h) {
        h_ = h;
        xs_ = w;
        while (br_.read(1)) read_transform();
        main_ = read_entropy(xs_, h_, true);
    }

    // the w x h ARGB pixels after prelude
    void pixels(uint32_t* argb) {
        std::vector<uint32_t> cur(static_cast<size_t>(xs_) * h_);
        decode(main_, cur.data(), xs_, h_);
        for (auto t = transforms_.rbegin(); t != transforms_.rend(); ++t) inverse(*t, cur);
        std::memcpy(argb, cur.data(), cur.size() * sizeof(uint32_t));
    }

  private:
    void read_transform() {
        const int type = static_cast<int>(br_.read(2));
        if (seen_ & (1u << type)) throw Error("a VP8L transform that appears twice");
        seen_ |= 1u << type;
        stats[0] |= 1 << type;
        Transform t{type, 0, xs_, h_, {}};
        if (type == 0 || type == 1) {  // predictor, cross-colour
            t.bits = static_cast<int>(br_.read(3)) + 2;
            t.data = sub_image(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits));
        } else if (type == 3) {  // colour indexing
            const int n = static_cast<int>(br_.read(8)) + 1;
            t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
            stats[2] |= 1 << t.bits;
            std::vector<uint32_t> deltas = sub_image(n, 1);
            t.data.assign(size_t{1} << (8 >> t.bits), 0);  // transparent black past the palette
            t.data[0] = deltas[0];
            for (int i = 1; i < n; ++i) t.data[i] = add_pixels(deltas[i], t.data[i - 1]);
            xs_ = subsample(xs_, t.bits);
        }
        transforms_.push_back(std::move(t));
    }

    std::vector<uint32_t> sub_image(int xs, int ys) {
        Entropy e = read_entropy(xs, ys, false);
        std::vector<uint32_t> data(static_cast<size_t>(xs) * ys);
        decode(e, data.data(), xs, ys);
        return data;
    }

    Entropy read_entropy(int xs, int ys, bool level0) {
        Entropy e;
        if (br_.read(1)) {
            e.cache_bits = static_cast<int>(br_.read(4));
            if (e.cache_bits < 1 || e.cache_bits > 11)
                throw Error("a VP8L colour cache of " + std::to_string(e.cache_bits) + " bits");
            stats[3] = std::max<int64_t>(stats[3], e.cache_bits);
        }
        int ngroups = 1;
        if (level0 && br_.read(1)) {
            e.meta_bits = static_cast<int>(br_.read(3)) + 2;
            e.meta_xs = subsample(xs, e.meta_bits);
            e.meta = sub_image(e.meta_xs, subsample(ys, e.meta_bits));
            for (uint32_t& g : e.meta) {
                g = (g >> 8) & 0xffff;
                ngroups = std::max(ngroups, static_cast<int>(g) + 1);
            }
        }
        // groups the entropy image never names are read and checked, not
        // kept; the kept ones in the order of their numbers
        std::vector<int> slot(ngroups, e.meta.empty() ? 0 : -1);
        for (uint32_t g : e.meta) slot[g] = 0;
        for (int g = 0, kept = 0; g < ngroups; ++g)
            if (slot[g] >= 0) slot[g] = kept++;
        for (uint32_t& g : e.meta) g = static_cast<uint32_t>(slot[g]);
        Group scratch;
        for (int g = 0; g < ngroups; ++g) {
            if (slot[g] >= 0) e.groups.emplace_back();
            Group& into = slot[g] >= 0 ? e.groups.back() : scratch;
            for (int j = 0; j < 5; ++j) {
                const int cache = j == 0 && e.cache_bits ? 1 << e.cache_bits : 0;
                read_code(kAlphabet[j] + cache, into.code[j]);
            }
        }
        stats[4] = std::max<int64_t>(stats[4], static_cast<int64_t>(e.groups.size()));
        return e;
    }

    void read_code(int n, Prefix& out) {
        std::vector<int> lens(n, 0);
        if (br_.read(1)) {  // simple: one or two symbols
            const int nsym = static_cast<int>(br_.read(1)) + 1;
            const int first = static_cast<int>(br_.read(br_.read(1) ? 8 : 1));
            if (first < n) lens[first] = 1;
            if (nsym == 2) {
                const int second = static_cast<int>(br_.read(8));
                if (second < n) lens[second] = 1;
            }
        } else {
            int cl[19] = {0};
            const int num = static_cast<int>(br_.read(4)) + 4;
            for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
            Prefix lc;
            if (!build_prefix(lc, cl, 19))
                throw Error("a VP8L code-length code that is not a prefix code");
            int max_symbol = n;
            if (br_.read(1)) {
                const int nb = 2 + 2 * static_cast<int>(br_.read(3));
                max_symbol = 2 + static_cast<int>(br_.read(nb));
                if (max_symbol > n) throw Error("a VP8L code with more lengths than symbols");
            }
            int prev = 8, sym = 0;
            while (sym < n) {
                if (max_symbol-- == 0) break;
                const int c = read_symbol(lc, br_);
                if (c < 16) {
                    lens[sym++] = c;
                    if (c) prev = c;
                } else {
                    static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
                    int rep = static_cast<int>(br_.read(kExtra[c - 16])) + kOffset[c - 16];
                    if (sym + rep > n) throw Error("a VP8L run of code lengths past the alphabet");
                    const int v = c == 16 ? prev : 0;
                    while (rep-- > 0) lens[sym++] = v;
                }
            }
        }
        if (!build_prefix(out, lens.data(), n))
            throw Error("a VP8L prefix code that is not complete");
    }

    int copy_value(int sym) {
        if (sym < 4) return sym + 1;
        const int extra = (sym - 2) >> 1;
        return ((2 + (sym & 1)) << extra) + static_cast<int>(br_.read(extra)) + 1;
    }

    void decode(const Entropy& e, uint32_t* data, int w, int h) {
        const size_t total = static_cast<size_t>(w) * h;
        const int cache_size = e.cache_bits ? 1 << e.cache_bits : 0;
        std::vector<uint32_t> cache(cache_size);
        size_t pos = 0, cached = 0;
        int x = 0, y = 0;
        while (pos < total) {
            const Group& g = e.meta.empty()
                ? e.groups[0]
                : e.groups[e.meta[static_cast<size_t>(y >> e.meta_bits) * e.meta_xs +
                                  (x >> e.meta_bits)]];
            const int code = read_symbol(g.code[0], br_);
            if (code < 256) {
                const uint32_t r = read_symbol(g.code[1], br_);
                const uint32_t b = read_symbol(g.code[2], br_);
                const uint32_t a = read_symbol(g.code[3], br_);
                data[pos++] = (a << 24) | (r << 16) | (static_cast<uint32_t>(code) << 8) | b;
                if (++x == w) x = 0, ++y;
            } else if (code < 256 + 24) {
                const int length = copy_value(code - 256);
                const int dcode = copy_value(read_symbol(g.code[4], br_));
                size_t dist;
                if (dcode > 120) {
                    dist = static_cast<size_t>(dcode - 120);
                } else {
                    const int c = kCodeToPlane[dcode - 1];
                    const int d = (c >> 4) * w + 8 - (c & 0xf);
                    dist = d >= 1 ? static_cast<size_t>(d) : 1;
                }
                if (pos < dist || total - pos < static_cast<size_t>(length))
                    throw Error("a VP8L back-reference outside the image");
                for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
                ++stats[5];
                x += length;
                while (x >= w) x -= w, ++y;
            } else if (code < 256 + 24 + cache_size) {
                for (; cached < pos; ++cached)
                    cache[(0x1e35a7bdu * data[cached]) >> (32 - e.cache_bits)] = data[cached];
                data[pos++] = cache[code - 256 - 24];
                ++stats[6];
                if (++x == w) x = 0, ++y;
            } else {
                throw Error("a VP8L symbol past its alphabet");
            }
        }
    }

    void inverse(const Transform& t, std::vector<uint32_t>& cur) {
        const int w = t.xsize, h = t.ysize;
        uint32_t* d = cur.data();
        if (t.type == 0) {  // predictor: row 0 left (its first pixel black), column 0 top
            const int tiles = subsample(w, t.bits);
            d[0] = add_pixels(d[0], 0xff000000u);
            for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
            for (int y = 1; y < h; ++y) {
                uint32_t* row = d + static_cast<size_t>(y) * w;
                const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
                row[0] = add_pixels(row[0], row[-w]);
                for (int x = 1; x < w; ++x) {
                    const int mode = (modes[x >> t.bits] >> 8) & 0xf;
                    stats[1] |= 1 << mode;
                    row[x] = add_pixels(row[x], predict(mode, row + x, w));
                }
            }
        } else if (t.type == 1) {  // cross-colour
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < h; ++y) {
                uint32_t* row = d + static_cast<size_t>(y) * w;
                const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
                for (int x = 0; x < w; ++x) {
                    const uint32_t m = codes[x >> t.bits];
                    const int g2r = static_cast<int8_t>(m & 0xff);
                    const int g2b = static_cast<int8_t>((m >> 8) & 0xff);
                    const int r2b = static_cast<int8_t>((m >> 16) & 0xff);
                    const uint32_t argb = row[x];
                    const int green = static_cast<int8_t>((argb >> 8) & 0xff);
                    int red = (argb >> 16) & 0xff, blue = argb & 0xff;
                    red = (red + ((g2r * green) >> 5)) & 0xff;
                    blue += (g2b * green) >> 5;
                    blue = (blue + ((r2b * static_cast<int8_t>(red)) >> 5)) & 0xff;
                    row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
                             static_cast<uint32_t>(blue);
                }
            }
        } else if (t.type == 2) {  // subtract green
            for (size_t i = 0; i < cur.size(); ++i) {
                const uint32_t argb = d[i], g = (argb >> 8) & 0xff;
                const uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
                d[i] = (argb & 0xff00ff00u) | rb;
            }
        } else {  // colour indexing, unbundling 2, 4 or 8 pixels a byte
            const int in_w = subsample(w, t.bits);
            std::vector<uint32_t> out(static_cast<size_t>(w) * h);
            const int bpp = 8 >> t.bits, per = 1 << t.bits;
            const uint32_t mask = (1u << bpp) - 1;
            for (int y = 0; y < h; ++y) {
                const uint32_t* src = d + static_cast<size_t>(y) * in_w;
                uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
                uint32_t packed = 0;
                for (int x = 0; x < w; ++x) {
                    if ((x & (per - 1)) == 0) packed = (src[x >> t.bits] >> 8) & 0xff;
                    dst[x] = t.data[packed & mask];
                    packed >>= bpp;
                }
            }
            cur.swap(out);
        }
    }

    LBits br_;
    int h_ = 0, xs_ = 0;
    unsigned seen_ = 0;

  public:
    // what the stream used, for the tests' coverage: transform types,
    // predictor modes and bundling widths (bit masks), the colour cache's
    // bits, the most prefix-code groups, back-references, cache lookups
    int64_t stats[8] = {0};

  private:
    std::vector<Transform> transforms_;
    Entropy main_;
};

// ===== VP8 =================================================================

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the sub-block mode tree of RFC 6386 11.2, libwebp's numbering of the modes
enum {
    B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
    DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT  // the DC modes of a macroblock on the frame's edge
};
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// RFC 6386 7.3, with libwebp's eof_: set when the decoder needs a byte past
// the end (then it shifts in zeros)
class BoolDec {
  public:
    BoolDec() = default;
    BoolDec(const uint8_t* p, size_t n) : p_(p), end_(p + n) { load(); }
    int get(int prob) {
        uint32_t range = range_;
        if (bits_ < 0) load();
        const int pos = bits_;
        const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
        const uint32_t value = static_cast<uint32_t>(value_ >> pos);
        const int bit = value > split;
        if (bit) {
            range -= split;
            value_ -= static_cast<uint64_t>(split + 1) << pos;
        } else {
            range = split + 1;
        }
        int shift = 0;
        while ((range << shift) < 128) ++shift;
        range <<= shift;
        bits_ -= shift;
        range_ = range - 1;
        return bit;
    }
    int value(int n) {
        int v = 0;
        while (n-- > 0) v |= get(0x80) << n;
        return v;
    }
    int signed_value(int n) {
        const int v = value(n);
        return get(0x80) ? -v : v;
    }
    bool eof = false;

  private:
    void load() {
        if (p_ < end_) {
            bits_ += 8;
            value_ = (value_ << 8) | *p_++;
        } else if (!eof) {
            value_ <<= 8;
            bits_ += 8;
            eof = true;
        } else {
            bits_ = 0;
        }
    }
    const uint8_t* p_ = nullptr;
    const uint8_t* end_ = nullptr;
    uint64_t value_ = 0;
    int bits_ = -8;
    uint32_t range_ = 255 - 1;
};

inline int clip(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// libwebp's work buffer: BPS-wide rows, Y with its top row and left column,
// then U and V side by side
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i, ++in, tmp += 4) {  // vertical pass
        const int a = in[0] + in[8], b = in[0] - in[8];
        const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {  // horizontal pass
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8], b = dc - tmp[8];
        const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i, out += 64) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = static_cast<int16_t>((a0 + a1) >> 3);
        out[16] = static_cast<int16_t>((a3 + a2) >> 3);
        out[32] = static_cast<int16_t>((a0 - a1) >> 3);
        out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    }
}

// ----- predictors (src/dsp/dec.c) -----
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y, dst += BPS)
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int v, int size) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void predict_luma4(int mode, uint8_t* dst) {
    const uint8_t* top = dst - BPS;
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    switch (mode) {
        case B_DC: {
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
            fill(dst, dc >> 3, 4);
            break;
        }
        case B_TM: true_motion(dst, 4); break;
        case B_VE: {
            const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE: {
            const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
            for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
            break;
        }
        case B_RD:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HU:
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
                static_cast<uint8_t>(L);
            break;
        case B_HD:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
    }
}
#undef DST

// 16x16 luma (size 16) and 8x8 chroma (size 8) whole-block modes
void predict_block(int mode, uint8_t* dst, int size) {
    const int shift = size == 16 ? 4 : 3;
    int dc = 0;
    switch (mode) {
        case B_DC:
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, (dc + size) >> (shift + 1), size);
            break;
        case DC_NOTOP:
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
            fill(dst, (dc + size / 2) >> shift, size);
            break;
        case DC_NOLEFT:
            for (int i = 0; i < size; ++i) dc += dst[i - BPS];
            fill(dst, (dc + size / 2) >> shift, size);
            break;
        case DC_NOTOPLEFT: fill(dst, 0x80, size); break;
        case B_TM: true_motion(dst, size); break;
        case B_VE:
            for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
            break;
        case B_HE:
            for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
            break;
    }
}

int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != B_DC) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
}

// ----- the normal loop filter (src/dsp/dec.c) -----
inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// an edge of `size` pixels: across it by hstride, along it by vstride; six
// taps on macroblock edges, four on inner ones
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
    const int thresh2 = 2 * thresh + 1;
    for (; size-- > 0; p += vstride) {
        if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
        if (hev(p, hstride, hev_thresh))
            do_filter2(p, hstride);
        else if (mb_edge)
            do_filter6(p, hstride);
        else
            do_filter4(p, hstride);
    }
}

struct FInfo {
    int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
    uint32_t non_zero_y, non_zero_uv;
};

class VP8 {
  public:
    VP8(const uint8_t* p, size_t n) : data_(p), size_(n) {}

    // the frame header and partition 0's header, with the refusals
    void header() {
        if (size_ < 10) throw Error("a VP8 chunk too short for its frame header");
        const uint32_t bits = data_[0] | (data_[1] << 8) | (data_[2] << 16);
        if (bits & 1) throw Error("a VP8 inter frame, which WebP does not hold");
        const int profile = (bits >> 1) & 7;
        if (profile > 3)
            throw Error("a VP8 frame of profile " + std::to_string(profile) + " (above 3)");
        if (!((bits >> 4) & 1)) throw Error("a VP8 frame that is not shown");
        const uint32_t part0 = bits >> 5;
        if (data_[3] != 0x9d || data_[4] != 0x01 || data_[5] != 0x2a)
            throw Error("a VP8 key frame without its start code");
        w_ = ((data_[7] << 8) | data_[6]) & 0x3fff;  // the upper two bits scale, which
        h_ = ((data_[9] << 8) | data_[8]) & 0x3fff;  // libwebp does not apply
        if (w_ == 0 || h_ == 0) throw Error("a VP8 frame of width or height 0");
        mbw_ = (w_ + 15) >> 4;
        mbh_ = (h_ + 15) >> 4;
        if (part0 > size_ - 10) throw Error("a VP8 first partition longer than its chunk");
        // each macroblock reads more than a bit of partition 0 (its prediction
        // size and chroma mode at fixed probabilities)
        if (static_cast<uint64_t>(mbw_) * mbh_ > 8 * static_cast<uint64_t>(part0) + 16)
            throw Error("a VP8 frame of " + std::to_string(w_) + " x " + std::to_string(h_) +
                        " whose first partition (" + std::to_string(part0) +
                        " bytes) cannot hold its macroblocks");
        br_ = BoolDec(data_ + 10, part0);
        br_.get(0x80);  // colour space and clamping type, which libwebp ignores
        br_.get(0x80);
        // segments
        use_segment_ = br_.get(0x80);
        if (use_segment_) {
            update_map_ = br_.get(0x80);
            if (br_.get(0x80)) {
                absolute_delta_ = br_.get(0x80);
                for (int s = 0; s < 4; ++s)
                    quantizer_[s] = br_.get(0x80) ? br_.signed_value(7) : 0;
                for (int s = 0; s < 4; ++s)
                    filter_strength_[s] = br_.get(0x80) ? br_.signed_value(6) : 0;
            }
            if (update_map_)
                for (int s = 0; s < 3; ++s) seg_proba_[s] = br_.get(0x80) ? br_.value(8) : 255;
        }
        // filter
        const int simple = br_.get(0x80);
        level_ = br_.value(6);
        const int sharpness = br_.value(3);
        const int use_lf_delta = br_.get(0x80);
        filter_type_ = level_ == 0 ? 0 : simple ? 1 : 2;
        if (filter_type_ == 1) throw Error("a VP8 frame of the simple loop filter");
        if (filter_type_ && sharpness)
            throw Error("a VP8 frame of loop-filter sharpness " + std::to_string(sharpness));
        if (filter_type_ && use_lf_delta) throw Error("a VP8 frame of loop-filter deltas");
        if (use_lf_delta && br_.get(0x80))  // the deltas, unused at level 0
            for (int i = 0; i < 8; ++i)
                if (br_.get(0x80)) br_.signed_value(6);
        const int parts = 1 << br_.value(2);
        if (parts > 1) throw Error("a VP8 frame of " + std::to_string(parts) + " token partitions");
        if (part0 >= size_ - 10) throw Error("a VP8 frame without its token partition");
        tokens_ = BoolDec(data_ + 10 + part0, size_ - 10 - part0);
        parse_quant();
        br_.get(0x80);  // refresh entropy probabilities, which a single frame ignores
        for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
            proba_[i] = br_.get(kCoeffsUpdateProba[i]) ? br_.value(8) : kCoeffsProba0[i];
        use_skip_ = br_.get(0x80);
        if (use_skip_) skip_p_ = br_.value(8);
        if (br_.eof) throw Error("a VP8 frame header past its first partition");
        precompute_filter();
    }

    int width() const { return w_; }
    int height() const { return h_; }

    // what the frame used, for the tests' coverage: a segment map, the
    // segments seen (bit mask), 4x4 and 16x16 macroblocks, macroblocks
    // skipped by their flag, the filter type
    int64_t stats[8] = {0};

    // the RGBA samples of the frame, alpha 255
    void decode(uint8_t* rgba) {
        const int ys = mbw_ * 16, uvs = mbw_ * 8;
        Y_.assign(static_cast<size_t>(ys) * mbh_ * 16, 0);
        U_.assign(static_cast<size_t>(uvs) * mbh_ * 8, 0);
        V_.assign(U_.size(), 0);
        finfo_.assign(static_cast<size_t>(mbw_) * mbh_, FInfo());
        std::vector<uint8_t> intra_t(4 * mbw_, B_DC), top_y(16 * mbw_);
        std::vector<uint8_t> top_u(8 * mbw_), top_v(8 * mbw_);
        std::vector<uint8_t> nz_top(mbw_, 0), nz_dc_top(mbw_, 0);
        std::vector<MBData> row(mbw_);
        for (int mb_y = 0; mb_y < mbh_; ++mb_y) {
            uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
            for (int mb_x = 0; mb_x < mbw_; ++mb_x)
                parse_modes(row[mb_x], &intra_t[4 * mb_x], intra_l);
            if (br_.eof) throw Error("a VP8 first partition that ends early");
            uint8_t nz_left = 0, nz_dc_left = 0;
            for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
                MBData& b = row[mb_x];
                int skip = use_skip_ ? b.skip : 0;
                stats[0] = update_map_;
                stats[1] |= 1 << b.segment;
                ++stats[b.is_i4x4 ? 2 : 3];
                stats[4] += skip;
                stats[5] = filter_type_;
                if (!skip) {
                    skip = parse_residuals(b, nz_top[mb_x], nz_dc_top[mb_x], nz_left, nz_dc_left);
                } else {
                    nz_left = nz_top[mb_x] = 0;
                    if (!b.is_i4x4) nz_dc_left = nz_dc_top[mb_x] = 0;
                    b.non_zero_y = b.non_zero_uv = 0;
                }
                if (filter_type_ > 0) {
                    FInfo& f = finfo_[static_cast<size_t>(mb_y) * mbw_ + mb_x];
                    f = fstrengths_[b.segment][b.is_i4x4];
                    f.inner |= !skip;
                }
                if (tokens_.eof) throw Error("a VP8 token partition that ends early");
            }
            reconstruct_row(mb_y, row, top_y, top_u, top_v);
        }
        if (filter_type_ > 0) filter();
        emit_rgba(rgba);
    }

  private:
    void parse_quant() {
        const int base_q0 = br_.value(7);
        int dq[5];
        for (int& d : dq) d = br_.get(0x80) ? br_.signed_value(4) : 0;
        const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2];
        const int dquv_dc = dq[3], dquv_ac = dq[4];
        for (int i = 0; i < 4; ++i) {
            int q;
            if (use_segment_) {
                q = quantizer_[i];
                if (!absolute_delta_) q += base_q0;
            } else {
                if (i > 0) {
                    dqm_[i] = dqm_[0];
                    continue;
                }
                q = base_q0;
            }
            Quant& m = dqm_[i];
            m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m.y1[1] = kAcTable[clip(q + 0, 127)];
            m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
    }

    void precompute_filter() {
        if (filter_type_ == 0) return;
        for (int s = 0; s < 4; ++s) {
            int level = level_;
            if (use_segment_) {
                level = filter_strength_[s];
                if (!absolute_delta_) level += level_;
            }
            level = clip(level, 63);
            for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
                FInfo& f = fstrengths_[s][i4x4];
                if (level > 0) {
                    const int ilevel = level;  // sharpness 0: the level itself
                    f.ilevel = ilevel;
                    f.limit = 2 * level + ilevel;
                    f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                } else {
                    f.limit = 0;
                }
                f.inner = i4x4;
            }
        }
    }

    void parse_modes(MBData& b, uint8_t* top, uint8_t* left) {
        if (update_map_)
            b.segment = !br_.get(seg_proba_[0]) ? br_.get(seg_proba_[1])
                                                 : br_.get(seg_proba_[2]) + 2;
        else
            b.segment = 0;
        b.skip = use_skip_ ? br_.get(skip_p_) : 0;
        b.is_i4x4 = !br_.get(145);
        if (!b.is_i4x4) {
            const int ymode =
                br_.get(156) ? (br_.get(128) ? B_TM : B_HE) : (br_.get(163) ? B_VE : B_DC);
            b.imodes[0] = static_cast<uint8_t>(ymode);
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            uint8_t* modes = b.imodes;
            for (int y = 0; y < 4; ++y) {
                int ymode = left[y];
                for (int x = 0; x < 4; ++x) {
                    const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
                    int i = kYModesIntra4[br_.get(prob[0])];
                    while (i > 0) i = kYModesIntra4[2 * i + br_.get(prob[i])];
                    ymode = -i;
                    top[x] = static_cast<uint8_t>(ymode);
                }
                std::memcpy(modes, top, 4);
                modes += 4;
                left[y] = static_cast<uint8_t>(ymode);
            }
        }
        b.uvmode = !br_.get(142) ? B_DC : !br_.get(114) ? B_VE : br_.get(183) ? B_TM : B_HE;
    }

    int large_value(const uint8_t* p) {
        int v;
        if (!tokens_.get(p[3])) {
            v = !tokens_.get(p[4]) ? 2 : 3 + tokens_.get(p[5]);
        } else if (!tokens_.get(p[6])) {
            if (!tokens_.get(p[7])) {
                v = 5 + tokens_.get(159);
            } else {
                v = 7 + 2 * tokens_.get(165);
                v += tokens_.get(145);
            }
        } else {
            const int bit1 = tokens_.get(p[8]);
            const int bit0 = tokens_.get(p[9 + bit1]);
            const int cat = 2 * bit1 + bit0;
            v = 0;
            for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tokens_.get(*tab);
            v += 3 + (8 << cat);
        }
        return v;
    }

    const uint8_t* band(int t, int n, int ctx) const {
        return proba_ + ((t * 8 + kBands[n]) * 3 + ctx) * 11;
    }

    // libwebp's GetCoeffs: the index past the last coefficient read
    int get_coeffs(int t, int ctx, const int* dq, int n, int16_t* out) {
        const uint8_t* p = band(t, n, ctx);
        for (; n < 16; ++n) {
            if (!tokens_.get(p[0])) return n;
            while (!tokens_.get(p[1])) {
                p = band(t, ++n, 0);
                if (n == 16) return 16;
            }
            int v;
            if (!tokens_.get(p[2])) {
                v = 1;
                p = band(t, n + 1, 1);
            } else {
                v = large_value(p);
                p = band(t, n + 1, 2);
            }
            out[kZigzag[n]] = static_cast<int16_t>((tokens_.get(0x80) ? -v : v) * dq[n > 0]);
        }
        return 16;
    }

    static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
        return (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
    }

    // libwebp's ParseResiduals: whether the macroblock has no non-zero coefficient
    int parse_residuals(MBData& b, uint8_t& mb_nz, uint8_t& mb_nz_dc, uint8_t& left_nz,
                        uint8_t& left_nz_dc) {
        const Quant& q = dqm_[b.segment];
        int16_t* dst = b.coeffs;
        std::memset(dst, 0, sizeof(b.coeffs));
        int first, ac_type;
        if (!b.is_i4x4) {
            int16_t dc[16] = {0};
            const int ctx = mb_nz_dc + left_nz_dc;
            const int nz = get_coeffs(1, ctx, q.y2, 0, dc);
            mb_nz_dc = left_nz_dc = nz > 0;
            if (nz > 1) {
                transform_wht(dc, dst);
            } else {
                const int dc0 = (dc[0] + 3) >> 3;
                for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
            }
            first = 1;
            ac_type = 0;
        } else {
            first = 0;
            ac_type = 3;
        }
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        uint8_t tnz = mb_nz & 0x0f, lnz = left_nz & 0x0f;
        for (int y = 0; y < 4; ++y) {
            int l = lnz & 1;
            uint32_t nz_coeffs = 0;
            for (int x = 0; x < 4; ++x) {
                const int ctx = l + (tnz & 1);
                const int nz = get_coeffs(ac_type, ctx, q.y1, first, dst);
                l = nz > first;
                tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 4;
            lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
            non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
            uint32_t nz_coeffs = 0;
            tnz = static_cast<uint8_t>(mb_nz >> (4 + ch));
            lnz = static_cast<uint8_t>(left_nz >> (4 + ch));
            for (int y = 0; y < 2; ++y) {
                int l = lnz & 1;
                for (int x = 0; x < 2; ++x) {
                    const int ctx = l + (tnz & 1);
                    const int nz = get_coeffs(2, ctx, q.uv, 0, dst);
                    l = nz > 0;
                    tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
                    nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                    dst += 16;
                }
                tnz >>= 2;
                lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
            }
            non_zero_uv |= nz_coeffs << (4 * ch);
            out_t_nz |= static_cast<uint32_t>(tnz << 4) << ch;
            out_l_nz |= static_cast<uint32_t>(lnz & 0xf0) << ch;
        }
        mb_nz = static_cast<uint8_t>(out_t_nz);
        left_nz = static_cast<uint8_t>(out_l_nz);
        b.non_zero_y = non_zero_y;
        b.non_zero_uv = non_zero_uv;
        return !(non_zero_y | non_zero_uv);
    }

    // libwebp's ReconstructRow, into the unfiltered planes
    void reconstruct_row(int mb_y, const std::vector<MBData>& row, std::vector<uint8_t>& top_y,
                         std::vector<uint8_t>& top_u, std::vector<uint8_t>& top_v) {
        uint8_t buf[BPS * 17 + BPS * 9];
        std::memset(buf, 0, sizeof(buf));
        uint8_t* const y_dst = buf + Y_OFF;
        uint8_t* const u_dst = buf + U_OFF;
        uint8_t* const v_dst = buf + V_OFF;
        for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(u_dst - BPS - 1, 127, 8 + 1);
            std::memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        const int ys = mbw_ * 16, uvs = mbw_ * 8;
        for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
            const MBData& b = row[mb_x];
            if (mb_x > 0) {  // the left samples from the block before
                for (int j = -1; j < 16; ++j)
                    std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
                for (int j = -1; j < 8; ++j) {
                    std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
                    std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
                }
            }
            uint8_t* const ty = &top_y[16 * mb_x];
            if (mb_y > 0) {
                std::memcpy(y_dst - BPS, ty, 16);
                std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
                std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
            }
            uint32_t bits = b.non_zero_y;
            if (b.is_i4x4) {
                uint8_t* const top_right = y_dst - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mbw_ - 1)
                        std::memset(top_right, ty[15], 4);
                    else
                        std::memcpy(top_right, ty + 16, 4);
                }
                for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
                for (int n = 0; n < 16; ++n, bits <<= 2) {
                    uint8_t* const dst = y_dst + kScan[n];
                    predict_luma4(b.imodes[n], dst);
                    if (bits >> 30) transform_one(b.coeffs + n * 16, dst);
                }
            } else {
                predict_block(check_mode(mb_x, mb_y, b.imodes[0]), y_dst, 16);
                for (int n = 0; n < 16; ++n, bits <<= 2)
                    if (bits >> 30) transform_one(b.coeffs + n * 16, y_dst + kScan[n]);
            }
            const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
            predict_block(uvmode, u_dst, 8);
            predict_block(uvmode, v_dst, 8);
            for (int n = 0; n < 4; ++n) {
                const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
                if ((b.non_zero_uv >> (2 * (3 - n))) & 3)
                    transform_one(b.coeffs + (16 + n) * 16, u_dst + off);
                if ((b.non_zero_uv >> (8 + 2 * (3 - n))) & 3)
                    transform_one(b.coeffs + (20 + n) * 16, v_dst + off);
            }
            if (mb_y < mbh_ - 1) {
                std::memcpy(ty, y_dst + 15 * BPS, 16);
                std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
                std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
            }
            for (int j = 0; j < 16; ++j)
                std::memcpy(&Y_[static_cast<size_t>(mb_y * 16 + j) * ys + mb_x * 16],
                            y_dst + j * BPS, 16);
            for (int j = 0; j < 8; ++j) {
                const size_t at = static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8;
                std::memcpy(&U_[at], u_dst + j * BPS, 8);
                std::memcpy(&V_[at], v_dst + j * BPS, 8);
            }
        }
    }

    // libwebp's DoFilter (complex), macroblock by macroblock in raster order
    void filter() {
        const int ys = mbw_ * 16, uvs = mbw_ * 8;
        for (int mb_y = 0; mb_y < mbh_; ++mb_y)
            for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
                const FInfo& f = finfo_[static_cast<size_t>(mb_y) * mbw_ + mb_x];
                const int limit = f.limit;
                if (limit == 0) continue;
                uint8_t* const y = &Y_[static_cast<size_t>(mb_y * 16) * ys + mb_x * 16];
                uint8_t* const u = &U_[static_cast<size_t>(mb_y * 8) * uvs + mb_x * 8];
                uint8_t* const v = &V_[static_cast<size_t>(mb_y * 8) * uvs + mb_x * 8];
                const int il = f.ilevel, hv = f.hev;
                if (mb_x > 0) {
                    filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
                    filter_loop(u, 1, uvs, 8, limit + 4, il, hv, true);
                    filter_loop(v, 1, uvs, 8, limit + 4, il, hv, true);
                }
                if (f.inner) {
                    for (int k = 4; k < 16; k += 4)
                        filter_loop(y + k, 1, ys, 16, limit, il, hv, false);
                    filter_loop(u + 4, 1, uvs, 8, limit, il, hv, false);
                    filter_loop(v + 4, 1, uvs, 8, limit, il, hv, false);
                }
                if (mb_y > 0) {
                    filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
                    filter_loop(u, uvs, 1, 8, limit + 4, il, hv, true);
                    filter_loop(v, uvs, 1, 8, limit + 4, il, hv, true);
                }
                if (f.inner) {
                    for (int k = 4; k < 16; k += 4)
                        filter_loop(y + k * ys, ys, 1, 16, limit, il, hv, false);
                    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
                    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
                }
            }
    }

    // ----- YUV -> RGB (src/dsp/yuv.h, upsampling.c, io_dec.c) -----
    static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
    static uint8_t yuv_clip8(int v) {
        return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
    }
    static void to_rgba(int y, int u, int v, uint8_t* d) {
        d[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
        d[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
        d[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
        d[3] = 255;
    }

    // libwebp's UPSAMPLE_FUNC: one row (bottom_y null) or a pair of rows
    // between chroma rows tu/tv and cu/cv
    static void upsample(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* tu,
                         const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst,
                         uint8_t* bottom_dst, int len) {
        const int last_pair = (len - 1) >> 1;
        int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
        to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
        if (bottom_y)
            to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
        for (int x = 1; x <= last_pair; ++x) {
            const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
            const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
            const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
            const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
            const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3;
            const int d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
            to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                    top_dst + (2 * x - 1) * 4);
            to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
            if (bottom_y) {
                to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                        bottom_dst + (2 * x - 1) * 4);
                to_rgba(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
                        bottom_dst + 2 * x * 4);
            }
            tl_u = t_u, tl_v = t_v, l_u = c_u, l_v = c_v;
        }
        if (!(len & 1)) {
            to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                    top_dst + (len - 1) * 4);
            if (bottom_y)
                to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                        bottom_dst + (len - 1) * 4);
        }
    }

    // io_dec.c's EmitFancyRGB over the whole frame
    void emit_rgba(uint8_t* rgba) const {
        const int ys = mbw_ * 16, uvs = mbw_ * 8;
        const size_t stride = static_cast<size_t>(w_) * 4;
        auto yrow = [&](int r) { return &Y_[static_cast<size_t>(r) * ys]; };
        auto urow = [&](int r) { return &U_[static_cast<size_t>(r) * uvs]; };
        auto vrow = [&](int r) { return &V_[static_cast<size_t>(r) * uvs]; };
        upsample(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgba, nullptr, w_);
        int y = 0;
        for (; y + 2 < h_; y += 2)
            upsample(yrow(y + 1), yrow(y + 2), urow(y / 2), vrow(y / 2), urow(y / 2 + 1),
                     vrow(y / 2 + 1), rgba + (y + 1) * stride, rgba + (y + 2) * stride, w_);
        if (!(h_ & 1))
            upsample(yrow(y + 1), nullptr, urow(y / 2), vrow(y / 2), urow(y / 2), vrow(y / 2),
                     rgba + (y + 1) * stride, nullptr, w_);
    }

    struct Quant {
        int y1[2], y2[2], uv[2];
    };

    const uint8_t* data_;
    size_t size_;
    int w_ = 0, h_ = 0, mbw_ = 0, mbh_ = 0;
    BoolDec br_, tokens_;
    int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
    int quantizer_[4] = {0}, filter_strength_[4] = {0};
    int seg_proba_[3] = {255, 255, 255};
    int level_ = 0, filter_type_ = 0, use_skip_ = 0, skip_p_ = 0;
    uint8_t proba_[4 * 8 * 3 * 11];
    Quant dqm_[4];
    FInfo fstrengths_[4][2];
    std::vector<FInfo> finfo_;
    std::vector<uint8_t> Y_, U_, V_;
};

// ===== ALPH ================================================================

// src/dsp/filters.c's unfilters, row by row over the previous output row
void unfilter(int filter, uint8_t* a, int w, int h) {
    if (filter == 0) return;
    for (int y = 0; y < h; ++y) {
        uint8_t* row = a + static_cast<size_t>(y) * w;
        const uint8_t* prev = y ? row - w : nullptr;
        if (filter == 1 || !prev) {  // horizontal, and the first row of every filter
            uint8_t pred = prev ? prev[0] : 0;
            for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
        } else if (filter == 2) {  // vertical
            for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
        } else {  // gradient
            int top_left = prev[0], left = prev[0];
            for (int x = 0; x < w; ++x) {
                const int top = prev[x];
                left = static_cast<uint8_t>(row[x] + clip(left + top - top_left, 255));
                top_left = top;
                row[x] = static_cast<uint8_t>(left);
            }
        }
    }
}

}  // namespace

extern "C" {

int webp_vp8l_info(const uint8_t* src, int64_t n, int64_t* info, char* err, int64_t errcap) {
    try {
        if (n < 5) throw Error("a VP8L chunk too short for its header");
        VP8L dec(src, static_cast<size_t>(n));
        int w, h, alpha;
        dec.header(w, h, alpha);
        dec.prelude(w, h);
        info[0] = w;
        info[1] = h;
        info[2] = alpha;
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

int webp_vp8l_decode(const uint8_t* src, int64_t n, uint8_t* rgba, int64_t cap, int64_t* stats,
                     char* err, int64_t errcap) {
    try {
        if (n < 5) throw Error("a VP8L chunk too short for its header");
        VP8L dec(src, static_cast<size_t>(n));
        int w, h, alpha;
        dec.header(w, h, alpha);
        if (static_cast<int64_t>(w) * h * 4 > cap)
            throw Error("the VP8L image is larger than its buffer");
        dec.prelude(w, h);
        std::vector<uint32_t> argb(static_cast<size_t>(w) * h);
        dec.pixels(argb.data());
        if (stats) std::memcpy(stats, dec.stats, sizeof(dec.stats));
        for (size_t i = 0; i < argb.size(); ++i) {
            const uint32_t p = argb[i];
            rgba[4 * i] = static_cast<uint8_t>(p >> 16);
            rgba[4 * i + 1] = static_cast<uint8_t>(p >> 8);
            rgba[4 * i + 2] = static_cast<uint8_t>(p);
            rgba[4 * i + 3] = static_cast<uint8_t>(p >> 24);
        }
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

int webp_vp8_info(const uint8_t* src, int64_t n, int64_t* info, char* err, int64_t errcap) {
    try {
        VP8 dec(src, static_cast<size_t>(n));
        dec.header();
        info[0] = dec.width();
        info[1] = dec.height();
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

int webp_vp8_decode(const uint8_t* src, int64_t n, uint8_t* rgba, int64_t cap, int64_t* stats,
                    char* err, int64_t errcap) {
    try {
        VP8 dec(src, static_cast<size_t>(n));
        dec.header();
        if (static_cast<int64_t>(dec.width()) * dec.height() * 4 > cap)
            throw Error("the VP8 image is larger than its buffer");
        dec.decode(rgba);
        if (stats) std::memcpy(stats, dec.stats, sizeof(dec.stats));
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

// the w x h alpha plane of an ALPH chunk's payload
int webp_alph_decode(const uint8_t* src, int64_t n, int64_t w, int64_t h, uint8_t* alpha, char* err,
                     int64_t errcap) {
    try {
        if (n <= 1) throw Error("an ALPH chunk without data");
        const int method = src[0] & 3, filter = (src[0] >> 2) & 3;
        const int pre = (src[0] >> 4) & 3, rsrv = src[0] >> 6;
        if (method > 1) throw Error("an ALPH chunk of compression " + std::to_string(method));
        if (pre > 1 || rsrv) throw Error("an ALPH chunk whose reserved header bits are set");
        const size_t size = static_cast<size_t>(w) * static_cast<size_t>(h);
        if (method == 0) {
            if (static_cast<size_t>(n - 1) < size)
                throw Error("an ALPH chunk shorter than its plane");
            std::memcpy(alpha, src + 1, size);
        } else {
            VP8L dec(src + 1, static_cast<size_t>(n - 1));
            dec.prelude(static_cast<int>(w), static_cast<int>(h));
            std::vector<uint32_t> argb(size);
            dec.pixels(argb.data());
            for (size_t i = 0; i < size; ++i) alpha[i] = static_cast<uint8_t>(argb[i] >> 8);
        }
        unfilter(filter, alpha, static_cast<int>(w), static_cast<int>(h));
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errcap, e.what());
        return -1;
    }
}

}  // extern "C"
