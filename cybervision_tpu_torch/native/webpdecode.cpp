// WebP pixel decoding (cybervision_tpu_torch/imageio/webp.py parses the
// RIFF container): the lossless VP8L bitstream, the lossy VP8 key frame
// and the ALPH chunk of a lossy image, as libwebp's decoder (the one
// Pillow reads WebP with) decodes them, so the pixels are the same bit
// for bit:
//   * VP8L: libwebp's bit reader (a 64-bit window; a stream is cut only
//     where a read passes its end), its two-level Huffman tables and
//     their validity rules, the code-length code, colour cache, LZ77
//     with the 120-entry distance map, meta prefix codes and the four
//     transforms (predictor with its edge rules, cross-colour,
//     subtract-green, colour indexing with pixel bundling);
//   * VP8: RFC 6386 as libwebp implements it: its boolean decoder,
//     segment and filter headers, token partitions, dequantisation
//     tables, intra prediction (the edge values 127 and 129, B_PRED's
//     top-right rule), the inverse WHT and DCT, the simple and normal
//     loop filters, then the fancy 4:2:0 upsampler and the 14-bit
//     YUV->RGB conversion of libwebp's RGBA output;
//   * ALPH: raw or VP8L-compressed (the green channel of an implicit
//     header stream) alpha, unfiltered (none, horizontal, vertical,
//     gradient) as libwebp's filters.c undoes it.
// libwebp's SIMD paths are bit-equal to its C paths; this follows the C
// paths. Every read is bounds-checked; a corrupt or truncated stream
// returns kCorrupt / kTruncated / kUnsupported and never reads or
// writes out of bounds.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr long kCorrupt = -1;
constexpr long kTruncated = -2;
constexpr long kUnsupported = -3;

// Tables of RFC 6386 in libwebp's layout and mode order.

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

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};

const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};

const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

// VP8L: the distance map, (dy << 4) | (8 - dx) of the 120 nearest pixels.
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ===========================================================================
// VP8L
// ===========================================================================

// libwebp's VP8LBitReader: val holds the next 64 bits from byte pos - 8,
// bit_pos of them consumed. A stream shorter than 8 bytes reads as if
// padded with zeros to 8.
struct LBits {
  const uint8_t *buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t *start, size_t length) {
    buf = start;
    len = length;
    val = 0;
    bit_pos = 0;
    eos = 0;
    size_t n = length < 8 ? length : 8;
    for (size_t i = 0; i < n; i++) val |= (uint64_t)start[i] << (8 * i);
    pos = n;
  }
  bool end_of_stream() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      pos++;
      bit_pos -= 8;
    }
    if (end_of_stream()) set_end();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {
    if (bit_pos < 32) return;
    if (pos + 8 < len) {
      val >>= 32;
      bit_pos -= 32;
      val |= (uint64_t)((uint32_t)buf[pos] | (uint32_t)buf[pos + 1] << 8 |
                        (uint32_t)buf[pos + 2] << 16 | (uint32_t)buf[pos + 3] << 24)
             << 32;
      pos += 4;
      return;
    }
    shift_bytes();
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kMaxCodeLength = 15;
constexpr int kTableBits = 8;
constexpr int kLengthsTableBits = 7;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode *table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int *count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: fills `out` with a root table of
// root_bits and its second-level tables; returns false for an invalid
// code (all lengths zero, over-subscribed or incomplete, unless exactly
// one symbol has a length: then it reads no bits).
bool build_huffman(std::vector<HCode> &out, int root_bits, const int *lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; s++) {
    if (lengths[s] > kMaxCodeLength) return false;
    count[lengths[s]]++;
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; len++) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; s++)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = (uint16_t)s;
  int total = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {
    out.assign(total, HCode{0, sorted[0]});
    return true;
  }
  // First pass: the size of the second-level tables.
  {
    int c[kMaxCodeLength + 1];
    std::memcpy(c, count, sizeof(c));
    uint32_t key = 0, low = 0xffffffffu, mask = (uint32_t)total - 1;
    int num_open = 1, num_nodes = 1, size = total;
    for (int len = 1; len <= root_bits; len++) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= c[len];
      if (num_open < 0) return false;
      for (; c[len] > 0; c[len]--) key = next_key(key, len);
    }
    for (int len = root_bits + 1; len <= kMaxCodeLength; len++) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= c[len];
      if (num_open < 0) return false;
      for (; c[len] > 0; c[len]--) {
        if ((key & mask) != low) {
          size += 1 << next_table_bits(c, len, root_bits);
          low = key & mask;
        }
        key = next_key(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return false;
    out.assign(size, HCode{0, 0});
  }
  HCode *root = out.data(), *table = root;
  int table_bits = root_bits, table_size = 1 << table_bits, symbol = 0;
  uint32_t key = 0, low = 0xffffffffu, mask = (uint32_t)total - 1;
  int step = 2;
  for (int len = 1; len <= root_bits; len++, step <<= 1) {
    for (; count[len] > 0; count[len]--) {
      replicate(&table[key], step, table_size, HCode{(uint8_t)len, sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  step = 2;
  for (int len = root_bits + 1; len <= kMaxCodeLength; len++, step <<= 1) {
    for (; count[len] > 0; count[len]--) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        low = key & mask;
        root[low].bits = (uint8_t)(table_bits + root_bits);
        root[low].value = (uint16_t)((table - root) - low);
      }
      replicate(&table[key >> root_bits], step, table_size,
                HCode{(uint8_t)(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  return true;
}

int read_symbol(const HCode *table, LBits &br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kTableBits) - 1);
  int nbits = table->bits - kTableBits;
  if (nbits > 0) {
    br.bit_pos += kTableBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

constexpr int kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4;
constexpr int kLiterals = 256, kLengthCodes = 24, kDistCodes = 40;
const int kAlphabet[5] = {kLiterals + kLengthCodes, 256, 256, 256, kDistCodes};

struct HGroup {
  std::vector<HCode> trees[5];
  bool trivial_literal = false, trivial_code = false;
  uint32_t literal_arb = 0;
};

// One level's entropy coding: its prefix-code groups, meta image and
// colour cache.
struct LMeta {
  int cache_bits = 0;
  std::vector<uint32_t> cache;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<HGroup> groups;
};

struct LTransform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct LDec {
  LBits br;
  std::vector<LTransform> transforms;
  unsigned seen = 0;
  bool alpha8b = false;  // the 8-bit alpha path's end-of-stream rule
};

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool read_code_lengths(LDec &d, const int *cl_lengths, int num_symbols, int *lengths) {
  std::vector<HCode> table;
  if (!build_huffman(table, kLengthsTableBits, cl_lengths, 19)) return false;
  LBits &br = d.br;
  int max_symbol;
  if (br.read(1)) {
    const int nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int prev = 8, symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HCode &p = table[br.prefetch() & ((1u << kLengthsTableBits) - 1)];
    br.bit_pos += p.bits;
    const int code_len = p.value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = (int)br.read(kExtra[slot]) + kOffset[slot];
      if (symbol + repeat > num_symbols) return false;
      const int value = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = value;
    }
  }
  return true;
}

bool read_huffman_code(LDec &d, int alphabet, std::vector<int> &lengths, std::vector<HCode> &out) {
  LBits &br = d.br;
  std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
  bool ok;
  if (br.read(1)) {  // a simple code of 1 or 2 symbols
    const int num = (int)br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
    ok = true;
  } else {
    static const uint8_t kOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                       7, 8, 9, 10, 11, 12, 13, 14, 15};
    int cl[19] = {0};
    const int num_codes = (int)br.read(4) + 4;
    for (int i = 0; i < num_codes; i++) cl[kOrder[i]] = (int)br.read(3);
    ok = read_code_lengths(d, cl, alphabet, lengths.data());
  }
  ok = ok && !br.eos;
  return ok && build_huffman(out, kTableBits, lengths.data(), alphabet);
}

bool decode_stream(LDec &d, int xsize, int ysize, bool level0, std::vector<uint32_t> *decoded,
                   LMeta &meta, int &out_xsize);

bool read_huffman_codes(LDec &d, int xsize, int ysize, int cache_bits, bool allow_recursion,
                        LMeta &meta) {
  LBits &br = d.br;
  int num_groups = 1;
  if (allow_recursion && br.read(1)) {
    meta.huffman_bits = 2 + (int)br.read(3);
    const int hx = subsample(xsize, meta.huffman_bits), hy = subsample(ysize, meta.huffman_bits);
    LMeta sub;
    int sub_x;
    if (!decode_stream(d, hx, hy, false, &meta.huffman_image, sub, sub_x)) return false;
    meta.huffman_xsize = hx;
    for (auto &v : meta.huffman_image) {
      v = (v >> 8) & 0xffff;
      num_groups = std::max(num_groups, (int)v + 1);
    }
  }
  if (br.eos) return false;
  const int alphabet0 = kAlphabet[0] + (cache_bits > 0 ? 1 << cache_bits : 0);
  std::vector<int> lengths(alphabet0 > 280 ? alphabet0 : 280);
  meta.groups.assign(num_groups, HGroup());
  for (auto &g : meta.groups) {
    int total_bits = 0;
    bool trivial_literal = true;
    for (int j = 0; j < 5; j++) {
      const int alphabet = j == 0 ? alphabet0 : kAlphabet[j];
      if (!read_huffman_code(d, alphabet, lengths, g.trees[j])) return false;
      if (trivial_literal && (j == kRed || j == kBlue || j == kAlpha))
        trivial_literal = g.trees[j][0].bits == 0;
      total_bits += g.trees[j][0].bits;
    }
    g.trivial_literal = trivial_literal;
    if (trivial_literal) {
      g.literal_arb = (uint32_t)g.trees[kAlpha][0].value << 24 |
                      (uint32_t)g.trees[kRed][0].value << 16 | g.trees[kBlue][0].value;
      if (total_bits == 0 && g.trees[kGreen][0].value < kLiterals) {
        g.trivial_code = true;
        g.literal_arb |= (uint32_t)g.trees[kGreen][0].value << 8;
      }
    }
  }
  return true;
}

int copy_distance(int symbol, LBits &br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist_code = kCodeToPlane[code - 1];
  const int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

inline void cache_insert(LMeta &m, uint32_t argb) {
  m.cache[(0x1e35a7bdu * argb) >> (32 - m.cache_bits)] = argb;
}

// libwebp's DecodeImageData (DecodeAlphaData where d.alpha8b): the
// entropy-coded pixels of one level into data (width x height). An
// over-read of the stream is an error, except on the 8-bit alpha path's
// last symbol.
bool decode_pixels(LDec &d, LMeta &m, uint32_t *data, int width, int height) {
  LBits &br = d.br;
  const long end = (long)width * height;
  long pos = 0, cached = 0;
  int col = 0, row = 0;
  const int mask = m.huffman_bits ? (1 << m.huffman_bits) - 1 : ~0;
  const int cache_limit = kLiterals + kLengthCodes + (m.cache_bits ? 1 << m.cache_bits : 0);
  auto group_at = [&](int x, int y) -> const HGroup & {
    if (m.huffman_bits == 0) return m.groups[0];
    return m.groups[m.huffman_image[(y >> m.huffman_bits) * m.huffman_xsize + (x >> m.huffman_bits)]];
  };
  const HGroup *g = end > 0 ? &group_at(0, 0) : nullptr;
  auto flush_cache = [&]() {
    if (m.cache_bits)
      while (cached < pos) cache_insert(m, data[cached++]);
  };
  while (pos < end) {
    if ((col & mask) == 0) g = &group_at(col, row);
    int code;
    if (!d.alpha8b && g->trivial_code) {
      data[pos] = g->literal_arb;
      code = -1;
    } else {
      br.fill();
      code = read_symbol(g->trees[kGreen].data(), br);
      if (!d.alpha8b && br.end_of_stream()) break;
    }
    if (code < 0) {
      // a trivial literal, already stored
    } else if (code < kLiterals) {
      if (d.alpha8b || g->trivial_literal) {
        data[pos] = g->literal_arb | (uint32_t)code << 8;
      } else {
        const int red = read_symbol(g->trees[kRed].data(), br);
        br.fill();
        const int blue = read_symbol(g->trees[kBlue].data(), br);
        const int alpha = read_symbol(g->trees[kAlpha].data(), br);
        if (br.end_of_stream()) break;
        data[pos] = (uint32_t)alpha << 24 | (uint32_t)red << 16 | (uint32_t)code << 8 | blue;
      }
    } else if (code < kLiterals + kLengthCodes) {
      const int length = copy_distance(code - kLiterals, br);
      const int dist_symbol = read_symbol(g->trees[kDist].data(), br);
      br.fill();
      const int dist = plane_to_distance(width, copy_distance(dist_symbol, br));
      if (!d.alpha8b && br.end_of_stream()) break;
      if (pos < dist || end - pos < length) return false;
      for (int k = 0; k < length; k++) data[pos + k] = data[pos + k - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        row++;
      }
      if (pos < end && (col & mask)) g = &group_at(col, row);
      flush_cache();
      if (d.alpha8b) {
        br.eos = br.end_of_stream();
        if (br.eos) break;
      }
      continue;
    } else if (code < cache_limit) {
      flush_cache();
      data[pos] = m.cache[code - kLiterals - kLengthCodes];
    } else {
      return false;
    }
    pos++;
    if (++col >= width) {
      col = 0;
      row++;
      flush_cache();
    }
    if (d.alpha8b) {
      br.eos = br.end_of_stream();
      if (br.eos) break;
    }
  }
  br.eos = br.end_of_stream();
  if (d.alpha8b) return !(br.eos && pos < end);
  return !br.eos;
}

bool read_transform(LDec &d, int &xsize, int ysize) {
  LBits &br = d.br;
  const int type = (int)br.read(2);
  if (d.seen & (1u << type)) return false;
  d.seen |= 1u << type;
  LTransform t{type, 0, xsize, ysize, {}};
  LMeta sub;
  int sub_x;
  bool ok = true;
  if (type == 0 || type == 1) {  // predictor, cross-colour
    t.bits = (int)br.read(3) + 2;
    ok = decode_stream(d, subsample(xsize, t.bits), subsample(ysize, t.bits), false, &t.data, sub,
                       sub_x);
  } else if (type == 3) {  // colour indexing
    const int num_colors = (int)br.read(8) + 1;
    t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    xsize = subsample(t.xsize, t.bits);
    ok = decode_stream(d, num_colors, 1, false, &t.data, sub, sub_x);
    if (ok) {
      const int final_colors = 1 << (8 >> t.bits);
      std::vector<uint32_t> map(final_colors, 0);
      const uint8_t *src = (const uint8_t *)t.data.data();
      uint8_t *dst = (uint8_t *)map.data();
      map[0] = t.data[0];
      for (int i = 4; i < 4 * num_colors; i++) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
      t.data.swap(map);
    }
  }
  d.transforms.push_back(std::move(t));
  return ok;
}

// libwebp's DecodeImageStream: the transforms (level 0 only), the colour
// cache, the prefix codes and, below level 0, the pixels into *decoded.
// Level 0's pixels are decoded by the caller with `meta`.
bool decode_stream(LDec &d, int xsize, int ysize, bool level0, std::vector<uint32_t> *decoded,
                   LMeta &meta, int &out_xsize) {
  LBits &br = d.br;
  int txsize = xsize;
  if (level0) {
    while (br.read(1)) {
      if (!read_transform(d, txsize, ysize)) return false;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  if (!read_huffman_codes(d, txsize, ysize, cache_bits, level0, meta)) return false;
  meta.cache_bits = cache_bits;
  if (cache_bits) meta.cache.assign((size_t)1 << cache_bits, 0);
  out_xsize = txsize;
  if (level0) return true;
  decoded->assign((size_t)txsize * ysize, 0);
  return decode_pixels(d, meta, decoded->data(), txsize, ysize) && !br.eos;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(uint32_t a) { return a < 256 ? (int)a : (int)(~a >> 24); }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff);
    out |= (uint32_t)clip255((uint32_t)v) << s;
  }
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
    out |= (uint32_t)clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

// The predictor of mode `mode` for the pixel whose left neighbour is
// `left` and whose row above starts at `top` (top[-1], top[0], top[1]).
inline uint32_t predict(int mode, uint32_t left, const uint32_t *top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and libwebp's 14 and 15
  }
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// The inverse of transform t over the whole image: in (its input,
// t.xsize wide unless colour indexing) -> out (t.xsize wide).
void inverse_transform(const LTransform &t, const std::vector<uint32_t> &in,
                       std::vector<uint32_t> &out) {
  const int w = t.xsize, h = t.ysize;
  out.assign((size_t)w * h, 0);
  if (t.type == 2) {  // subtract green
    for (size_t i = 0; i < out.size(); i++) {
      const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
      uint32_t rb = argb & 0x00ff00ffu;
      rb += (green << 16) | green;
      out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
  } else if (t.type == 0) {  // predictor
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; y++) {
      const uint32_t *src = &in[(size_t)y * w];
      uint32_t *dst = &out[(size_t)y * w];
      if (y == 0) {
        dst[0] = add_pixels(src[0], 0xff000000u);
        for (int x = 1; x < w; x++) dst[x] = add_pixels(src[x], dst[x - 1]);
        continue;
      }
      const uint32_t *top = dst - w;
      dst[0] = add_pixels(src[0], top[0]);
      const uint32_t *modes = &t.data[(size_t)(y >> t.bits) * tiles];
      for (int x = 1; x < w; x++) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        dst[x] = add_pixels(src[x], predict(mode, dst[x - 1], top + x));
      }
    }
  } else if (t.type == 1) {  // cross-colour
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; y++) {
      for (int x = 0; x < w; x++) {
        const uint32_t code = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
                     r2b = (int8_t)((code >> 16) & 0xff);
        const uint32_t argb = in[(size_t)y * w + x];
        const int8_t green = (int8_t)(argb >> 8);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + color_delta(g2r, green)) & 0xff;
        blue += color_delta(g2b, green);
        blue += color_delta(r2b, (int8_t)red);
        blue &= 0xff;
        out[(size_t)y * w + x] = (argb & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
      }
    }
  } else {  // colour indexing
    const int in_w = subsample(w, t.bits), bits_per_pixel = 8 >> t.bits;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    const int count_mask = (1 << t.bits) - 1;
    for (int y = 0; y < h; y++) {
      const uint32_t *src = &in[(size_t)y * in_w];
      uint32_t *dst = &out[(size_t)y * w];
      uint32_t packed = 0;
      for (int x = 0; x < w; x++) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[t.bits ? (packed & bit_mask) : packed];
        packed >>= bits_per_pixel;
      }
    }
  }
}

// A VP8L image stream: with the 5-byte header (signature, size, alpha
// hint, version) or, for an ALPH chunk, without it at xsize x ysize.
// argb: xsize * ysize.
long vp8l_image(const uint8_t *data, long n, long xsize, long ysize, bool header, bool alpha,
                uint32_t *argb) {
  LDec d;
  d.br.init(data, (size_t)n);
  if (header) {
    LBits &br = d.br;
    if (br.read(8) != 0x2f) return kCorrupt;
    const long w = br.read(14) + 1, h = br.read(14) + 1;
    br.read(1);
    if (br.read(3) != 0 || br.eos) return kCorrupt;
    if (w != xsize || h != ysize) return kCorrupt;
  }
  LMeta meta;
  int txsize;
  if (!decode_stream(d, (int)xsize, (int)ysize, true, nullptr, meta, txsize))
    return d.br.eos ? kTruncated : kCorrupt;
  if (alpha && d.transforms.size() == 1 && d.transforms[0].type == 3 && meta.cache_bits == 0) {
    bool ok8 = true;
    for (const auto &g : meta.groups)
      ok8 = ok8 && g.trees[kRed][0].bits == 0 && g.trees[kBlue][0].bits == 0 &&
            g.trees[kAlpha][0].bits == 0;
    d.alpha8b = ok8;
  }
  std::vector<uint32_t> pixels((size_t)txsize * ysize), tmp;
  if (!decode_pixels(d, meta, pixels.data(), txsize, (int)ysize))
    return d.br.eos ? kTruncated : kCorrupt;
  for (size_t k = d.transforms.size(); k-- > 0;) {
    inverse_transform(d.transforms[k], pixels, tmp);
    pixels.swap(tmp);
  }
  std::memcpy(argb, pixels.data(), sizeof(uint32_t) * (size_t)xsize * ysize);
  return 0;
}

// libwebp's filters.c unfiltering of one row: prev is the row above
// (nullptr for the first).
void unfilter_row(int filter, const uint8_t *prev, const uint8_t *in, uint8_t *out, int width) {
  if (filter == 0) {
    if (in != out) std::memcpy(out, in, width);
    return;
  }
  if (filter == 1 || prev == nullptr) {
    uint8_t pred = (filter == 1 && prev != nullptr) ? prev[0] : 0;
    for (int i = 0; i < width; i++) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
    return;
  }
  if (filter == 2) {
    for (int i = 0; i < width; i++) out[i] = (uint8_t)(prev[i] + in[i]);
    return;
  }
  uint8_t top = prev[0], top_left = top, left = top;
  for (int i = 0; i < width; i++) {
    top = prev[i];
    const int g = left + top - top_left;
    const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
    left = (uint8_t)(in[i] + pred);
    top_left = top;
    out[i] = left;
  }
}

// ===========================================================================
// VP8
// ===========================================================================

// libwebp's VP8BitReader, loading one byte at a time (its bulk loads of
// 7 bytes read the same bits and reach the end at the same read).
struct BoolReader {
  const uint8_t *buf = nullptr, *end = nullptr;
  uint64_t value = 0;
  uint32_t range = 0;
  int bits = 0, eof = 0;

  void init(const uint8_t *start, size_t size) {
    range = 255 - 1;
    value = 0;
    bits = -8;
    eof = 0;
    buf = start;
    end = start + size;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get_value(1) ? -v : v;
  }
};

constexpr int BPS = 32;
constexpr int kYOff = BPS * 1 + 8, kUOff = kYOff + BPS * 16 + BPS, kVOff = kUOff + 16;
constexpr int kYuvSize = BPS * 17 + BPS * 9;

// libwebp's intra modes: 4x4 B_DC..B_HU, and DC/TM/V/H for 16x16 and chroma.
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
constexpr int DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6;

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  uint8_t limit, ilevel, inner, hev_thresh;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t *in, uint8_t *dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; i++) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// libwebp's Transform_SSE2, which x86-64 builds run for the full
// transform: the same operations in 16-bit lanes that wrap, and a
// saturating add to the prediction. On an encoder's coefficients it
// equals transform_one; on a corrupt stream's it may not.
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi16(int16_t x, int k) { return (int16_t)(((int32_t)x * (int16_t)k) >> 16); }

void transform_simd(const int16_t *in, uint8_t *dst) {
  int16_t C[16];
  for (int j = 0; j < 4; j++) {
    const int16_t i0 = in[j], i1 = in[4 + j], i2 = in[8 + j], i3 = in[12 + j];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi16(i1, -30068) - mulhi16(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi16(i1, 20091) + mulhi16(i3, -30068)));
    C[4 * j + 0] = w16(a + d);
    C[4 * j + 1] = w16(b + c);
    C[4 * j + 2] = w16(b - c);
    C[4 * j + 3] = w16(a - d);
  }
  for (int i = 0; i < 4; i++) {
    const int16_t t0 = C[i], t1 = C[4 + i], t2 = C[8 + i], t3 = C[12 + i];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi16(t1, -30068) - mulhi16(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi16(t1, 20091) + mulhi16(t3, -30068)));
    const int16_t out[4] = {(int16_t)(w16(a + d) >> 3), (int16_t)(w16(b + c) >> 3),
                            (int16_t)(w16(b - c) >> 3), (int16_t)(w16(a - d) >> 3)};
    for (int x = 0; x < 4; x++) dst[x] = clip8(w16(dst[x] + out[x]));
    dst += BPS;
  }
}

// The residual of a 4x4 luma block whose coefficient code (libwebp's
// NzCodeBits: 0 none, 1 DC only, 2 up to three coefficients, 3 more) is
// `code`: libwebp's DC-only and three-coefficient transforms (C, in int)
// are transform_one on such blocks; the full one is transform_simd.
inline void add_residual(uint32_t code, const int16_t *in, uint8_t *dst) {
  if (code == 3) {
    transform_simd(in, dst);
  } else if (code) {
    transform_one(in, dst);
  }
}

void true_motion(uint8_t *dst, int size) {
  const uint8_t *top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; y++) {
    const int left = dst[-1];
    for (int x = 0; x < size; x++) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill_block(uint8_t *dst, int v, int size) {
  for (int j = 0; j < size; j++) std::memset(dst + j * BPS, v, size);
}

void predict_luma16(int mode, uint8_t *dst) {
  switch (mode) {
    case B_DC: {
      int dc = 16;
      for (int j = 0; j < 16; j++) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill_block(dst, dc >> 5, 16);
      break;
    }
    case B_TM: true_motion(dst, 16); break;
    case B_VE:
      for (int j = 0; j < 16; j++) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE:
      for (int j = 0; j < 16; j++) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; j++) dc += dst[-1 + j * BPS];
      fill_block(dst, dc >> 4, 16);
      break;
    }
    case DC_NOLEFT: {
      int dc = 8;
      for (int j = 0; j < 16; j++) dc += dst[j - BPS];
      fill_block(dst, dc >> 4, 16);
      break;
    }
    default: fill_block(dst, 0x80, 16); break;
  }
}

void predict_chroma8(int mode, uint8_t *dst) {
  switch (mode) {
    case B_DC: {
      int dc = 8;
      for (int j = 0; j < 8; j++) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill_block(dst, dc >> 4, 8);
      break;
    }
    case B_TM: true_motion(dst, 8); break;
    case B_VE:
      for (int j = 0; j < 8; j++) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE:
      for (int j = 0; j < 8; j++) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_NOTOP: {
      int dc = 4;
      for (int j = 0; j < 8; j++) dc += dst[-1 + j * BPS];
      fill_block(dst, dc >> 3, 8);
      break;
    }
    case DC_NOLEFT: {
      int dc = 4;
      for (int j = 0; j < 8; j++) dc += dst[j - BPS];
      fill_block(dst, dc >> 3, 8);
      break;
    }
    default: fill_block(dst, 0x80, 8); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict_luma4(int mode, uint8_t *dst) {
  const uint8_t *top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C),
                               (uint8_t)avg3(B, C, D), (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; i++) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
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
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
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
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// The loop filters (libwebp's dec.c, C paths).
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // [-112, 112]
inline int uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }          // [-255, 511]

inline void do_filter2(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)uclip(p0 + a2);
  p[0] = (uint8_t)uclip(q0 - a1);
}

inline void do_filter4(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)uclip(p1 + a3);
  p[-step] = (uint8_t)uclip(p0 + a2);
  p[0] = (uint8_t)uclip(q0 - a1);
  p[step] = (uint8_t)uclip(q1 - a3);
}

inline void do_filter6(uint8_t *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)uclip(p2 + a3);
  p[-2 * step] = (uint8_t)uclip(p1 + a2);
  p[-step] = (uint8_t)uclip(p0 + a1);
  p[0] = (uint8_t)uclip(q0 - a1);
  p[step] = (uint8_t)uclip(q1 - a2);
  p[2 * step] = (uint8_t)uclip(q2 - a3);
}

inline bool hev(const uint8_t *p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t *p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t *p, int step, int along, int n, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; i++, p += along)
    if (needs_filter(p, step, t2)) do_filter2(p, step);
}

void filter_loop(uint8_t *p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct VP8Dec {
  BoolReader br, parts[8];
  int num_parts_minus_one = 0;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int dq[4][3][2];  // per segment: y1, y2, uv; dc, ac
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

long vp8_headers(VP8Dec &d, const uint8_t *buf, size_t size) {
  if (size < 4) return kTruncated;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) return kCorrupt;
  if (!show) return kUnsupported;
  buf += 3;
  size -= 3;
  if (key_frame) {
    if (size < 7) return kTruncated;
    if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) return kCorrupt;
    d.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    d.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    d.mb_w = (d.width + 15) >> 4;
    d.mb_h = (d.height + 15) >> 4;
    std::memcpy(d.proba, kCoeffsProba0, sizeof(d.proba));
  }
  if (partition_length > size) return kTruncated;
  BoolReader &br = d.br;
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  if (key_frame) {
    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
  }
  // Segment header.
  d.use_segment = br.get_value(1);
  if (d.use_segment) {
    d.update_map = br.get_value(1);
    if (br.get_value(1)) {
      d.absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; s++) d.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; s++)
        d.filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; s++)
        d.segment_proba[s] = br.get_value(1) ? (uint8_t)br.get_value(8) : 255;
  } else {
    d.update_map = 0;
  }
  if (br.eof) return kCorrupt;
  // Filter header.
  d.simple = br.get_value(1);
  d.level = br.get_value(6);
  d.sharpness = br.get_value(3);
  d.use_lf_delta = br.get_value(1);
  if (d.use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; i++)
      if (br.get_value(1)) d.ref_lf_delta[i] = br.get_signed_value(6);
    for (int i = 0; i < 4; i++)
      if (br.get_value(1)) d.mode_lf_delta[i] = br.get_signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return kCorrupt;
  // Token partitions.
  d.num_parts_minus_one = (1 << br.get_value(2)) - 1;
  const size_t last_part = (size_t)d.num_parts_minus_one;
  if (size < 3 * last_part) return kTruncated;
  const uint8_t *sz = buf, *part_start = buf + last_part * 3, *buf_end = buf + size;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; p++) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last_part].init(part_start, size_left);
  if (part_start >= buf_end) return kTruncated;
  // Quantisers.
  {
    const int base_q0 = br.get_value(7);
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; i++) {
      int q;
      if (d.use_segment) {
        q = d.quantizer[i];
        if (!d.absolute_delta) q += base_q0;
      } else if (i > 0) {
        std::memcpy(d.dq[i], d.dq[0], sizeof(d.dq[0]));
        continue;
      } else {
        q = base_q0;
      }
      d.dq[i][0][0] = kDcTable[clip(q + dqy1_dc, 127)];
      d.dq[i][0][1] = kAcTable[clip(q, 127)];
      d.dq[i][1][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      d.dq[i][1][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (d.dq[i][1][1] < 8) d.dq[i][1][1] = 8;
      d.dq[i][2][0] = kDcTable[clip(q + dquv_dc, 117)];
      d.dq[i][2][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }
  if (!key_frame) return kUnsupported;
  br.get_value(1);  // update_proba, ignored
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++)
          d.proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                    ? (uint8_t)br.get_value(8)
                                    : kCoeffsProba0[t][b][c][p];
  d.use_skip_proba = br.get_value(1);
  if (d.use_skip_proba) d.skip_p = br.get_value(8);
  // Filter strengths per segment and block kind.
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; s++) {
      int base_level;
      if (d.use_segment) {
        base_level = d.filter_strength[s];
        if (!d.absolute_delta) base_level += d.level;
      } else {
        base_level = d.level;
      }
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FInfo &info = d.fstrengths[s][i4x4];
        int level = base_level;
        if (d.use_lf_delta) {
          level += d.ref_lf_delta[0];
          if (i4x4) level += d.mode_lf_delta[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (d.sharpness > 0) {
            ilevel >>= d.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = (uint8_t)ilevel;
          info.limit = (uint8_t)(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
          info.ilevel = 0;
          info.hev_thresh = 0;
        }
        info.inner = (uint8_t)i4x4;
      }
    }
  }
  return 0;
}

void parse_intra_mode(VP8Dec &d, MBData &b, uint8_t *top, uint8_t *left) {
  BoolReader &br = d.br;
  if (d.update_map) {
    b.segment = !br.get_bit(d.segment_proba[0]) ? br.get_bit(d.segment_proba[1])
                                                : br.get_bit(d.segment_proba[2]) + 2;
  } else {
    b.segment = 0;
  }
  b.skip = d.use_skip_proba ? br.get_bit(d.skip_p) : 0;
  b.is_i4x4 = !br.get_bit(145);
  if (!b.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM : B_HE)
                                      : (br.get_bit(163) ? B_VE : B_DC);
    b.imodes[0] = (uint8_t)ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t *modes = b.imodes;
    for (int y = 0; y < 4; y++) {
      int ymode = left[y];
      for (int x = 0; x < 4; x++) {
        const uint8_t *prob = kBModesProba[top[x]][ymode];
        ymode = !br.get_bit(prob[0])   ? B_DC
                : !br.get_bit(prob[1]) ? B_TM
                : !br.get_bit(prob[2]) ? B_VE
                : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE : (!br.get_bit(prob[5]) ? B_RD : B_VR))
                    : (!br.get_bit(prob[6])
                           ? B_LD
                           : (!br.get_bit(prob[7]) ? B_VL : (!br.get_bit(prob[8]) ? B_HD : B_HU)));
        top[x] = (uint8_t)ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  b.uvmode = !br.get_bit(142)   ? B_DC
             : !br.get_bit(114) ? B_VE
             : br.get_bit(183)  ? B_TM
                                : B_HE;
}

int large_value(BoolReader &br, const uint8_t *p) {
  int v;
  if (!br.get_bit(p[3])) {
    v = !br.get_bit(p[4]) ? 2 : 3 + br.get_bit(p[5]);
  } else if (!br.get_bit(p[6])) {
    if (!br.get_bit(p[7])) {
      v = 5 + br.get_bit(159);
    } else {
      v = 7 + 2 * br.get_bit(165);
      v += br.get_bit(145);
    }
  } else {
    const int bit1 = br.get_bit(p[8]);
    const int bit0 = br.get_bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the tokens of one block from position n; returns
// the position after the last non-zero coefficient (16 when a run of
// zeros reaches the end).
int get_coeffs(BoolReader &br, const uint8_t (*bands)[3][11], int ctx, const int *dq, int n,
               int16_t *out) {
  const uint8_t *p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = large_value(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// libwebp's ParseResiduals; returns whether the block has no non-zero
// coefficient.
int parse_residuals(VP8Dec &d, MBData &b, uint8_t &top_nz, uint8_t &top_nz_dc, uint8_t &left_nz,
                    uint8_t &left_nz_dc, BoolReader &br) {
  const int(*q)[2] = d.dq[b.segment];
  int16_t *dst = b.coeffs;
  std::memset(dst, 0, sizeof(b.coeffs));
  const uint8_t(*ac_proba)[3][11];
  int first;
  if (!b.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top_nz_dc + left_nz_dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, q[1], 0, dc);
    top_nz_dc = left_nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; y++) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; x++) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q[0], first, dst);
      l = (nz > first);
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(top_nz >> (4 + ch));
    lnz = (uint8_t)(left_nz >> (4 + ch));
    for (int y = 0; y < 2; y++) {
      int l = lnz & 1;
      for (int x = 0; x < 2; x++) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d.proba[2], ctx, q[2], 0, dst);
        l = (nz > 0);
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  top_nz = (uint8_t)out_t_nz;
  left_nz = (uint8_t)out_l_nz;
  b.non_zero_y = non_zero_y;
  b.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// libwebp's ReconstructRow for macroblock row mb_y into the planes.
void reconstruct_row(VP8Dec &d, std::vector<MBData> &blocks, int mb_y, uint8_t *yuv_b,
                     std::vector<TopSamples> &top_yuv, uint8_t *Y, uint8_t *U, uint8_t *V,
                     int y_stride, int uv_stride) {
  uint8_t *const y_dst = yuv_b + kYOff, *const u_dst = yuv_b + kUOff, *const v_dst = yuv_b + kVOff;
  for (int j = 0; j < 16; j++) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; j++) {
    u_dst[j * BPS - 1] = 129;
    v_dst[j * BPS - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < d.mb_w; mb_x++) {
    const MBData &block = blocks[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; j++) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; j++) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    TopSamples *const top = &top_yuv[mb_x];
    const int16_t *coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top[0].y, 16);
      std::memcpy(u_dst - BPS, top[0].u, 8);
      std::memcpy(v_dst - BPS, top[0].v, 8);
    }
    if (block.is_i4x4) {
      uint8_t *top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= d.mb_w - 1) {
          std::memset(top_right, top[0].y[15], 4);
        } else {
          std::memcpy(top_right, top[1].y, 4);
        }
      }
      // The top-right pixels replicated below, for the blocks of the
      // right column.
      for (int k = 1; k <= 3; k++) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; n++, bits <<= 2) {
        uint8_t *const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict_luma4(block.imodes[n], dst);
        add_residual(bits >> 30, coeffs + n * 16, dst);
      }
    } else {
      predict_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
      if (bits != 0)
        for (int n = 0; n < 16; n++, bits <<= 2)
          add_residual(bits >> 30, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    {
      const uint32_t bits_uv = block.non_zero_uv;
      const int mode = check_mode(mb_x, mb_y, block.uvmode);
      predict_chroma8(mode, u_dst);
      predict_chroma8(mode, v_dst);
      for (int c = 0; c < 2; c++) {
        const uint32_t ub = bits_uv >> (8 * c);
        uint8_t *const dst = c ? v_dst : u_dst;
        if (ub & 0xff) {
          // Any AC coefficient: libwebp's TransformUV (the full
          // transform of all four blocks), else its TransformDCUV.
          void (*fn)(const int16_t *, uint8_t *) = (ub & 0xaa) ? transform_simd : transform_one;
          const int16_t *in = coeffs + (16 + 4 * c) * 16;
          fn(in, dst);
          fn(in + 16, dst + 4);
          fn(in + 32, dst + 4 * BPS);
          fn(in + 48, dst + 4 * BPS + 4);
        }
      }
    }
    if (mb_y < d.mb_h - 1) {
      std::memcpy(top[0].y, y_dst + 15 * BPS, 16);
      std::memcpy(top[0].u, u_dst + 7 * BPS, 8);
      std::memcpy(top[0].v, v_dst + 7 * BPS, 8);
    }
    uint8_t *const y_out = Y + (size_t)mb_y * 16 * y_stride + mb_x * 16;
    uint8_t *const u_out = U + (size_t)mb_y * 8 * uv_stride + mb_x * 8;
    uint8_t *const v_out = V + (size_t)mb_y * 8 * uv_stride + mb_x * 8;
    for (int j = 0; j < 16; j++) std::memcpy(y_out + j * y_stride, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; j++) {
      std::memcpy(u_out + j * uv_stride, u_dst + j * BPS, 8);
      std::memcpy(v_out + j * uv_stride, v_dst + j * BPS, 8);
    }
  }
}

// libwebp's DoFilter for macroblock (mb_x, mb_y) of the planes.
void filter_mb(const VP8Dec &d, const FInfo &f, int mb_x, int mb_y, uint8_t *Y, uint8_t *U,
               uint8_t *V, int y_stride, int uv_stride) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t *const y_dst = Y + (size_t)mb_y * 16 * y_stride + mb_x * 16;
  if (d.filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, y_stride, 16, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; k++) simple_filter(y_dst + 4 * k, 1, y_stride, 16, limit);
    if (mb_y > 0) simple_filter(y_dst, y_stride, 1, 16, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; k++) simple_filter(y_dst + 4 * k * y_stride, y_stride, 1, 16, limit);
    return;
  }
  uint8_t *const u_dst = U + (size_t)mb_y * 8 * uv_stride + mb_x * 8;
  uint8_t *const v_dst = V + (size_t)mb_y * 8 * uv_stride + mb_x * 8;
  const int il = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y_dst, 1, y_stride, 16, limit + 4, il, hev_t, true);
    filter_loop(u_dst, 1, uv_stride, 8, limit + 4, il, hev_t, true);
    filter_loop(v_dst, 1, uv_stride, 8, limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; k++) filter_loop(y_dst + 4 * k, 1, y_stride, 16, limit, il, hev_t, false);
    filter_loop(u_dst + 4, 1, uv_stride, 8, limit, il, hev_t, false);
    filter_loop(v_dst + 4, 1, uv_stride, 8, limit, il, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y_dst, y_stride, 1, 16, limit + 4, il, hev_t, true);
    filter_loop(u_dst, uv_stride, 1, 8, limit + 4, il, hev_t, true);
    filter_loop(v_dst, uv_stride, 1, 8, limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; k++)
      filter_loop(y_dst + 4 * k * y_stride, y_stride, 1, 16, limit, il, hev_t, false);
    filter_loop(u_dst + 4 * uv_stride, uv_stride, 1, 8, limit, il, hev_t, false);
    filter_loop(v_dst + 4 * uv_stride, uv_stride, 1, 8, limit, il, hev_t, false);
  }
}

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's UpsampleRgbaLinePair (the "fancy" upsampler), one channel
// pair at a time: rows top_y (and bottom_y) from the chroma rows above
// (tu, tv) and below (cu, cv).
void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y, const uint8_t *tu,
                   const uint8_t *tv, const uint8_t *cu, const uint8_t *cv, uint8_t *top_dst,
                   uint8_t *bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; x++) {
    const int t_u = tu[x], t_v = tv[x], u = cu[x], v = cv[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 3);
  }
}

}  // namespace

extern "C" {

// A VP8L bitstream (the payload of a VP8L chunk, its header included)
// of xsize x ysize pixels -> argb (xsize * ysize), libwebp's 0xAARRGGBB.
// Returns 0 or an error code.
long webp_vp8l_decode(const uint8_t *data, long n, long xsize, long ysize, uint32_t *argb) {
  if (xsize <= 0 || ysize <= 0 || n < 0) return kCorrupt;
  return vp8l_image(data, n, xsize, ysize, true, false, argb);
}

// An ALPH chunk's payload (its header byte and data) for a width x
// height image -> alpha (width * height). Returns 0 or an error code.
long webp_alph_decode(const uint8_t *data, long n, long width, long height, uint8_t *alpha) {
  if (n <= 1 || width <= 0 || height <= 0) return kCorrupt;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return kCorrupt;
  const size_t count = (size_t)width * height;
  if (method == 0) {
    if ((size_t)(n - 1) < count) return kTruncated;
    std::memcpy(alpha, data + 1, count);
  } else {
    std::vector<uint32_t> argb(count);
    const long code = vp8l_image(data + 1, n - 1, width, height, false, true, argb.data());
    if (code < 0) return code;
    for (size_t i = 0; i < count; i++) alpha[i] = (uint8_t)(argb[i] >> 8);
  }
  for (long y = 0; y < height; y++) {
    uint8_t *row = alpha + y * width;
    unfilter_row(filter, y ? row - width : nullptr, row, row, (int)width);
  }
  return 0;
}

// A VP8 key frame (the payload of a VP8 chunk, padding included) ->
// rgb (height, width, 3), as libwebp's RGBA output gives its colour.
// width and height are the frame header's. Returns 0 or an error code.
long webp_vp8_decode(const uint8_t *data, long n, long width, long height, uint8_t *rgb) {
  if (n < 0) return kCorrupt;
  VP8Dec d;
  const long code = vp8_headers(d, data, (size_t)n);
  if (code < 0) return code;
  if (d.width != width || d.height != height || width <= 0 || height <= 0) return kCorrupt;
  const int y_stride = d.mb_w * 16, uv_stride = d.mb_w * 8;
  std::vector<uint8_t> Y((size_t)y_stride * d.mb_h * 16), U((size_t)uv_stride * d.mb_h * 8),
      V((size_t)uv_stride * d.mb_h * 8);
  std::vector<MBData> blocks(d.mb_w);
  std::vector<FInfo> finfo((size_t)d.mb_w * d.mb_h);
  std::vector<TopSamples> top_yuv(d.mb_w);
  std::vector<uint8_t> intra_t(4 * d.mb_w, B_DC), yuv_b(kYuvSize, 0);
  std::vector<uint8_t> top_nz(d.mb_w, 0), top_nz_dc(d.mb_w, 0);
  for (int mb_y = 0; mb_y < d.mb_h; mb_y++) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < d.mb_w; mb_x++)
      parse_intra_mode(d, blocks[mb_x], &intra_t[4 * mb_x], intra_l);
    if (d.br.eof) return kTruncated;
    BoolReader &token_br = d.parts[mb_y & d.num_parts_minus_one];
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < d.mb_w; mb_x++) {
      MBData &b = blocks[mb_x];
      int skip = d.use_skip_proba ? b.skip : 0;
      if (!skip) {
        skip = parse_residuals(d, b, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc, token_br);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!b.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        b.non_zero_y = b.non_zero_uv = 0;
      }
      if (d.filter_type > 0) {
        FInfo &f = finfo[(size_t)mb_y * d.mb_w + mb_x];
        f = d.fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
      }
      if (token_br.eof) return kTruncated;
    }
    reconstruct_row(d, blocks, mb_y, yuv_b.data(), top_yuv, Y.data(), U.data(), V.data(),
                    y_stride, uv_stride);
  }
  if (d.filter_type > 0)
    for (int mb_y = 0; mb_y < d.mb_h; mb_y++)
      for (int mb_x = 0; mb_x < d.mb_w; mb_x++)
        filter_mb(d, finfo[(size_t)mb_y * d.mb_w + mb_x], mb_x, mb_y, Y.data(), U.data(),
                  V.data(), y_stride, uv_stride);
  // Libwebp's EmitFancyRGB over the whole frame: row 0 alone, then pairs
  // of rows between chroma rows, then the last row of an even height.
  const size_t rs = (size_t)width * 3;
  const uint8_t *u0 = U.data(), *v0 = V.data();
  upsample_pair(Y.data(), nullptr, u0, v0, u0, v0, rgb, nullptr, (int)width);
  int y = 0;
  for (; y + 2 < height; y += 2) {
    const uint8_t *tu = U.data() + (size_t)(y / 2) * uv_stride, *tv = V.data() + (size_t)(y / 2) * uv_stride;
    upsample_pair(Y.data() + (size_t)(y + 1) * y_stride, Y.data() + (size_t)(y + 2) * y_stride, tu,
                  tv, tu + uv_stride, tv + uv_stride, rgb + (y + 1) * rs, rgb + (y + 2) * rs,
                  (int)width);
  }
  if (!(height & 1)) {
    const uint8_t *cu = U.data() + (size_t)(y / 2) * uv_stride, *cv = V.data() + (size_t)(y / 2) * uv_stride;
    upsample_pair(Y.data() + (size_t)(y + 1) * y_stride, nullptr, cu, cv, cu, cv,
                  rgb + (y + 1) * rs, nullptr, (int)width);
  }
  return 0;
}

}  // extern "C"
