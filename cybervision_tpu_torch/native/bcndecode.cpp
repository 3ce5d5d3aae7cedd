// Block-compressed textures (cybervision_tpu_torch/imageio/dds.py, ftex.py,
// blp.py): the BC1-BC7 blocks of DDS and FTEX files as Pillow 12.1's "bcn"
// decoder (libImaging/BcnDecode.c) writes them into its image, and the
// DXT1/3/5 blocks of BLP2 files as BlpImagePlugin.py's Python decoders
// (decode_dxt1/3/5) lay them out. The two differ on purpose: Pillow's C
// decoder widens 5- and 6-bit colours by bit replication, the BLP plugin
// by a shift; the C decoder puts each 4x4 block at its place in the image,
// the BLP plugin emits four rows of the block row's full width, which the
// image then takes as a flat stream of its own width.
// Every function returns a count >= 0 or a negative error code (see
// imageio/__init__.py): -1 corrupt data, -2 truncated data.

#include <cstdint>
#include <cstring>

namespace {

constexpr long kCorrupt = -1;
constexpr long kTruncated = -2;

struct Rgba {
  uint8_t r, g, b, a;
};

// -- BC1-BC5 ------------------------------------------------------------------

inline uint16_t le16(const uint8_t *p) { return uint16_t(p[0] | p[1] << 8); }
inline uint32_t le32(const uint8_t *p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

// A 5:6:5 colour, each field widened to 8 bits by repeating its top bits.
Rgba decode_565(uint16_t v) {
  const uint8_t r = uint8_t((v & 0xf800) >> 8), g = uint8_t((v & 0x07e0) >> 3),
                b = uint8_t((v & 0x1f) << 3);
  return {uint8_t(r | r >> 5), uint8_t(g | g >> 6), uint8_t(b | b >> 5), 0xff};
}

// The colour half of BC1-BC3. BC2 and BC3 (`four_colour`) always take the
// four-colour mode; BC1 takes the three-colour mode with transparent black
// where c0 <= c1.
void bc1_colour(Rgba *col, const uint8_t *src, bool four_colour) {
  const uint16_t c0 = le16(src), c1 = le16(src + 2);
  const uint32_t lut = le32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four_colour) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3),
            0xff};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3),
            0xff};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) col[n] = p[3 & (lut >> (2 * n))];
}

// A BC3 alpha block (BC4 and BC5's channels too) into byte `o` of each of
// 16 pixels `stride` bytes apart; `sign`: the endpoints are signed bytes,
// moved up by 128.
void bc3_alpha(uint8_t *dst, const uint8_t *src, int stride, int o, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = int(int8_t(src[0])) + 128;
    a1 = int(int8_t(src[1])) + 128;
  }
  const uint32_t lut1 = src[2] | src[3] << 8 | src[4] << 16;
  const uint32_t lut2 = src[5] | src[6] << 8 | src[7] << 16;
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int k = 1; k <= 6; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// -- BC7 ----------------------------------------------------------------------

struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
// Subsets, partition bits, rotation bits, index-selection bits, colour
// bits, alpha bits, endpoint p-bits, shared p-bits, index bits, second
// index bits.
constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// The BPTC partitions: bit n of a two-subset entry, bits 2n..2n+1 of a
// three-subset one, is pixel n's subset.
constexpr uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
constexpr uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
// The anchor pixels: the second subset's of two, the second and third
// subset's of three.
constexpr uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,  8, 2,  2, 8,
    8,  15, 2,  8,  2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2, 8,  2, 2,
    2,  15, 15, 6,  6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2, 15};
constexpr uint8_t kAnchor3a[64] = {
    3, 3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5, 3,  3,  3, 3,  8,  15, 3, 3,
    6, 10, 5,  8,  8,  6,  8,  5,  15, 15, 8,  15, 3,  5, 6,  10, 8, 15, 15, 3,  15, 5,
    15, 15, 15, 15, 3, 15, 5,  5,  5,  8,  5,  10, 5, 10, 8,  13, 15, 12, 3,  3};
constexpr uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8, 15, 3,  15, 8,
    15, 8,  3,  15, 6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,  10, 6, 15, 8,  15,
    3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

constexpr uint8_t kWeights2[4] = {0, 21, 43, 64};
constexpr uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t *weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

inline int subset_of(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kPartition2[partition] >> n);
  if (ns == 3) return 3 & (kPartition3[partition] >> (2 * n));
  return 0;
}

inline uint8_t get_bit(const uint8_t *src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

// Up to 8 bits from bit `bit` on, least significant first.
inline uint8_t get_bits(const uint8_t *src, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  const int x = bit + count <= 8 ? src[by] : src[by] | src[by + 1] << 8;
  return uint8_t((x >> bit) & ((1 << count) - 1));
}

inline uint8_t expand_quantized(uint8_t v, int bits) {
  v = uint8_t(v << (8 - bits));
  return uint8_t(v | v >> bits);
}

inline void bc7_lerp(Rgba *dst, const Rgba *e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba *col, const uint8_t *src) {
  if (!src[0]) {  // the reserved mode: no bit of the mode byte set
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 0xff};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) bit++;
  const Bc7Mode &m = kBc7Modes[bit];
  bit++;
  int cb = m.cb, ab = m.ab;
  const uint8_t *cw = weights(m.ib);
  const uint8_t *aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  const int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  const int numep = m.ns * 2;
  Rgba ep[6];
  for (int c = 0; c < 3; c++) {
    for (int i = 0; i < numep; i++) {
      (&ep[i].r)[c] = get_bits(src, bit, cb);
      bit += cb;
    }
  }
  for (int i = 0; i < numep; i++) {
    if (ab) {
      ep[i].a = get_bits(src, bit, ab);
      bit += ab;
    } else {
      ep[i].a = 0xff;
    }
  }
  auto add_p = [&](Rgba &e, int p, bool alpha) {
    e.r = uint8_t(e.r << 1 | p);
    e.g = uint8_t(e.g << 1 | p);
    e.b = uint8_t(e.b << 1 | p);
    if (alpha) e.a = uint8_t(e.a << 1 | p);
  };
  if (m.epb) {  // a p-bit per endpoint
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) add_p(ep[i], get_bit(src, bit++), ab);
  }
  if (m.spb) {  // a p-bit per subset
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      const int p = get_bit(src, bit++);
      add_p(ep[i], p, ab);
      add_p(ep[i + 1], p, ab);
    }
  }
  for (int i = 0; i < numep; i++) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit, aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; i++) {
    const int s = subset_of(m.ns, partition, i) << 1;
    int ib = m.ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition]) ||
        (m.ns == 3 && (i == kAnchor3a[partition] || i == kAnchor3b[partition])))
      ib--;
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && m.ib2) {
      const int ib2 = i == 0 ? m.ib2 - 1 : m.ib2;
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    if (rotation) {
      uint8_t &x = (&col[i].r)[rotation - 1];
      const uint8_t t = x;
      x = col[i].a;
      col[i].a = t;
    }
  }
}

// -- BC6H ---------------------------------------------------------------------

struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
// Subsets, transformed (delta) endpoints, partition bits, endpoint bits,
// and the bits of the other endpoints' red, green and blue.
constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6}, {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// Where each endpoint bit of a mode lies (the BC6H format's bit layouts):
// entry k is the destination of the k-th bit after the mode bits, as
// 16 * endpoint word + bit, the words being the red, green and blue of
// endpoints w, x, y and z. The fields some modes store bit-reversed
// (modes 12 and 13's high bits of w) come out reversed here.
constexpr uint8_t kBc6Bits[14][75] = {
    {116, 132, 180, 0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,
     22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,
     164, 112, 113, 114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,
     84,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0,   1,   2,   3,   4,   5,   6,   176, 177, 132, 16,  17,  18,  19,  20,  21,
     22,  133, 178, 116, 32,  33,  34,  35,  36,  37,  38,  179, 181, 180, 48,  49,  50,  51,  52,
     53,  112, 113, 114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,
     84,  85,  128, 129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,  10,  112, 113,
     114, 115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,  82,  83,  42,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  10,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  26,  160, 161, 162, 163, 80,  81,  82,  83,  42,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  176, 178, 144, 145, 146, 147, 116, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  10,  132, 112, 113,
     114, 115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  42,  128,
     129, 130, 131, 96,  97,  98,  99,  177, 178, 144, 145, 146, 147, 180, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   132, 16,  17,  18,  19,  20,  21,  22,  23,  24,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  40,  180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   164, 132, 16,  17,  18,  19,  20,  21,  22,  23,  178,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  179, 180, 48,  49,  50,  51,  52,  53,  112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   176, 132, 16,  17,  18,  19,  20,  21,  22,  23,  117,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  165, 180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   177, 132, 16,  17,  18,  19,  20,  21,  22,  23,  133,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  181, 180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  85,  128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   164, 176, 177, 132, 16,  17,  18,  19,  20,  21,  117, 133, 178,
     116, 32,  33,  34,  35,  36,  37,  165, 179, 181, 180, 48,  49,  50,  51,  52,  53,  112, 113,
     114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,  84,  85,  128,
     129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
     64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10,
     64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10,
     64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10,
     64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}};

inline uint16_t sign_extend(uint16_t v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  return uint16_t(x);
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = int16_t(v);
  if (prec >= 16) return x;
  const bool negative = x < 0;
  if (negative) x = -x;
  if (x != 0) x = x >= (1 << (prec - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (prec - 1);
  return negative ? -x : x;
}

// A half float's value (its bits widened into a float's, Inf and NaN kept).
float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(uint16_t(0x8000 | ((-v) * 31) / 32));
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

inline uint8_t bc6_clamp(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return uint8_t(value * 255.0f);
}

void bc6_lerp(Rgba *col, const int *e0, const int *e1, int s, bool sign) {
  const int t = 64 - s;
  col->r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void bc6_block(Rgba *col, const uint8_t *src, bool sign) {
  int mode = src[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {  // the reserved modes
    std::memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode &m = kBc6Modes[mode];
  const uint8_t *cw = weights(ib);
  const int numep = m.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; i++) {
    const int d = kBc6Bits[mode][i];
    ep[d >> 4] = uint16_t(ep[d >> 4] | get_bit(src, bit + i) << (d & 15));
  }
  bit += epbits;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr) {
    for (int i = 3; i < numep; i += 3) {
      ep[i] = sign_extend(ep[i], m.rb);
      ep[i + 1] = sign_extend(ep[i + 1], m.gb);
      ep[i + 2] = sign_extend(ep[i + 2], m.bb);
    }
  }
  // Deltas are added and masked to the endpoint's bits; Pillow does not
  // sign-extend the sum again, so a signed block's transformed endpoints
  // unquantize as the non-negative values they are masked to.
  if (m.tr)
    for (int i = 3; i < numep; i++) ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
  int ueps[12];
  for (int i = 0; i < numep; i++) ueps[i] = bc6_unquantize(ep[i], m.epb, sign);
  for (int i = 0; i < 16; i++) {
    const int s = subset_of(m.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition])) ib2--;
    const int i0 = get_bits(src, bit, ib2);
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

// -- BLP2's Python decoders ---------------------------------------------------

// BlpImagePlugin.unpack_565: each field shifted up, no bits repeated.
inline void unpack_565(uint16_t c, int *rgb) {
  rgb[0] = ((c >> 11) & 0x1f) << 3;
  rgb[1] = ((c >> 5) & 0x3f) << 2;
  rgb[2] = (c & 0x1f) << 3;
}

}  // namespace

extern "C" {

// Pillow's "bcn" decoder: `n` bytes of `src`, blocks of kind `kind`
// (1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5, 6 BC6H, 7 BC7; `sign`: BC4/BC5's
// signed bytes, BC6H's signed halves) in rows of (width + 3) / 4, into
// `out`, a width x height image of 4 (BC1-3, BC7: RGBA), 1 (BC4: L) or 3
// (BC5, BC6H: RGB) bytes a pixel, the blocks past the right and bottom
// edges cropped. BC5 leaves blue at 0, signed BC5 at 128. Returns the bytes read, or
// kTruncated when `src` holds fewer blocks than the image.
long bcn_decode(const uint8_t *src, long n, long width, long height, long kind, long sign,
                uint8_t *out) {
  if (kind < 1 || kind > 7 || width <= 0 || height <= 0) return kCorrupt;
  const long block = (kind == 1 || kind == 4) ? 8 : 16;
  const int channels = kind == 4 ? 1 : (kind == 5 || kind == 6) ? 3 : 4;
  const long bx = (width + 3) / 4, by = (height + 3) / 4;
  if (n / block < bx * by) return kTruncated;
  const uint8_t *p = src;
  for (long y = 0; y < by; y++) {
    for (long x = 0; x < bx; x++, p += block) {
      Rgba col[16];
      std::memset(col, 0, sizeof(col));
      uint8_t lum[16];
      switch (kind) {
        case 1:
          bc1_colour(col, p, false);
          break;
        case 2:
          bc1_colour(col, p + 8, true);
          for (int k = 0; k < 16; k++) {
            const int v = 0xf & (p[k >> 1] >> ((k & 1) * 4));
            col[k].a = uint8_t(v << 4 | v);
          }
          break;
        case 3:
          bc1_colour(col, p + 8, true);
          bc3_alpha(&col[0].r, p, 4, 3, false);
          break;
        case 4:
          bc3_alpha(lum, p, 1, 0, sign);
          break;
        case 5:
          if (sign)
            for (auto &c : col) c.b = 128;
          bc3_alpha(&col[0].r, p, 4, 0, sign);
          bc3_alpha(&col[0].r, p + 8, 4, 1, sign);
          break;
        case 6:
          bc6_block(col, p, sign);
          break;
        default:
          bc7_block(col, p);
      }
      for (int j = 0; j < 4; j++) {
        const long yy = 4 * y + j;
        if (yy >= height) break;
        uint8_t *row = out + (yy * width) * channels;
        for (int i = 0; i < 4; i++) {
          const long xx = 4 * x + i;
          if (xx >= width) break;
          if (kind == 4)
            row[xx] = lum[4 * j + i];
          else
            std::memcpy(row + xx * channels, &col[4 * j + i], channels);
        }
      }
    }
  }
  return long(p - src);
}

// BLP2's DXT blocks as BlpImagePlugin.py's decode_dxt1 (`kind` 1; with
// `alpha`, RGBA, else RGB), decode_dxt3 (3) and decode_dxt5 (5) lay them
// out: each row of `blocks` blocks becomes four rows of 4 * blocks pixels,
// appended to `out` (block_rows * 4 rows). Returns the bytes written, or
// kTruncated when `src` holds fewer than block_rows rows of blocks.
long blp_dxt(const uint8_t *src, long n, long blocks, long block_rows, long kind, long alpha,
             uint8_t *out) {
  if (kind != 1 && kind != 3 && kind != 5) return kCorrupt;
  const long block = kind == 1 ? 8 : 16;
  const int bpp = kind == 1 && !alpha ? 3 : 4;
  if (blocks <= 0 || block_rows <= 0) return 0;
  if (n / block / blocks < block_rows) return kTruncated;
  const long row_bytes = 4 * blocks * bpp;
  const uint8_t *p = src;
  for (long yb = 0; yb < block_rows; yb++) {
    uint8_t *rows = out + yb * 4 * row_bytes;
    for (long b = 0; b < blocks; b++, p += block) {
      const uint8_t *colour = kind == 1 ? p : p + 8;
      const uint16_t c0 = le16(colour), c1 = le16(colour + 2);
      const uint32_t code = le32(colour + 4);
      int e0[3], e1[3], pal[4][4];
      unpack_565(c0, e0);
      unpack_565(c1, e1);
      const bool three = kind == 1 && c0 <= c1;
      for (int c = 0; c < 3; c++) {
        pal[0][c] = e0[c];
        pal[1][c] = e1[c];
        pal[2][c] = three ? (e0[c] + e1[c]) / 2 : (2 * e0[c] + e1[c]) / 3;
        pal[3][c] = three ? 0 : (2 * e1[c] + e0[c]) / 3;
      }
      pal[0][3] = pal[1][3] = pal[2][3] = 0xff;
      pal[3][3] = three ? 0 : 0xff;
      int av[8] = {0};
      uint64_t alpha_bits = 0;
      if (kind == 5) {
        const int a0 = p[0], a1 = p[1];
        av[0] = a0;
        av[1] = a1;
        for (int k = 2; k < 8; k++)
          av[k] = a0 > a1 ? ((8 - k) * a0 + (k - 1) * a1) / 7
                  : k == 6 ? 0
                  : k == 7 ? 255
                           : ((6 - k) * a0 + (k - 1) * a1) / 5;
        for (int k = 0; k < 6; k++) alpha_bits |= uint64_t(p[2 + k]) << (8 * k);
      }
      for (int j = 0; j < 4; j++) {
        uint8_t *dst = rows + j * row_bytes + b * 4 * bpp;
        for (int i = 0; i < 4; i++, dst += bpp) {
          const int k = 4 * j + i;
          const int *rgba = pal[(code >> (2 * k)) & 3];
          int a = rgba[3];
          if (kind == 3) a = ((p[k >> 1] >> ((k & 1) * 4)) & 0xf) * 17;
          if (kind == 5) a = av[(alpha_bits >> (3 * k)) & 7];
          dst[0] = uint8_t(rgba[0]);
          dst[1] = uint8_t(rgba[1]);
          dst[2] = uint8_t(rgba[2]);
          if (bpp == 4) dst[3] = uint8_t(a);
        }
      }
    }
  }
  return block_rows * 4 * row_bytes;
}

}  // extern "C"
