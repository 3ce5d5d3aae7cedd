// Pixel loops of the image readers (cybervision_tpu_torch/imageio/).
//
// The JAX package decodes its input files through Pillow's C code; the
// port parses the containers in Python and runs the per-pixel work here:
//   * PNG row unfiltering (None/Sub/Up/Average/Paeth), 8 and 16 bits;
//   * TIFF PackBits, LZW and CCITT (T.4 / T.6) strips;
//   * GIF LZW (Pillow's GifDecode.c);
//   * BMP RLE8 and RLE4;
//   * the run-length codes of TGA (TgaRleDecode.c), SGI (SgiRleDecode.c),
//     PCX (PcxDecode.c), Sun raster (SunRleDecode.c) and Windows Paint
//     (MspImagePlugin.py), IM's packed float samples (BitDecode.c) and
//     QOI's op stream (QoiImagePlugin.py);
//   * sequential and progressive JPEG, Huffman (jdhuff.c, jdphuff.c) or
//     arithmetic coded (jdarith.c), with restart intervals, every
//     progressive scan kind into one coefficient buffer, libjpeg-turbo's
//     block smoothing of incomplete progressive files (jdcoefct.c), its
//     accurate integer IDCT as its SIMD code computes it (jidctint.c's
//     "islow" in 16-bit lanes), its "fancy" triangle upsampling
//     (jdsample.c) and its fixed-point YCbCr->RGB and YCCK->CMYK
//     conversions (jdcolor.c); and 8-bit lossless JPEG (jdlhuff.c,
//     jddiffct.c, jdlossls.c) -- the defaults of the libjpeg-turbo that
//     Pillow decodes with, so the pixels are the same bit for bit.
// Every function returns a count >= 0 or a negative error code (see
// imageio/__init__.py): -1 corrupt data, -2 truncated data,
// -3 unsupported.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr long kCorrupt = -1;
constexpr long kTruncated = -2;
constexpr long kUnsupported = -3;

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// ---------------------------------------------------------------------------
// JPEG

// Zigzag position -> natural (row-major) position in an 8x8 block.
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  // JPEG spec F.2.2.3 decode tables, plus an 8-bit lookahead.
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[256];  // 0: code longer than 8 bits
  uint8_t look_val[256];
  int total = 0;  // symbols defined
  bool defined = false;
};

bool build_huffman(const uint8_t *spec, Huffman &h) {
  // spec: 16 code counts, then up to 256 symbol values.
  const uint8_t *counts = spec;
  int total = 0;
  for (int l = 0; l < 16; l++) total += counts[l];
  if (total == 0) return false;  // not defined for this scan
  if (total > 256) return false;
  h.total = total;
  std::memcpy(h.vals, spec + 16, 256);
  int code = 0, k = 0;
  std::memset(h.look_len, 0, sizeof(h.look_len));
  for (int l = 1; l <= 16; l++) {
    int n = counts[l - 1];
    if (n) {
      h.valoffset[l] = k - code;
      for (int i = 0; i < n; i++, k++, code++) {
        if (l <= 8) {
          int shift = 8 - l;
          for (int j = 0; j < (1 << shift); j++) {
            int idx = (code << shift) | j;
            if (idx < 256) {
              h.look_len[idx] = (uint8_t)l;
              h.look_val[idx] = h.vals[k];
            }
          }
        }
      }
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;  // sentinel: ends the search
  h.defined = true;
  return true;
}

class BitReader {
 public:
  BitReader(const uint8_t *p, long n) : p_(p), end_(p + n) {}

  // Drop the buffered bits and step over the next restart marker (RSTn),
  // skipping any bytes before it as libjpeg's next_marker does. Returns
  // false when the segment ends first (the marker after it is no RSTn).
  bool restart() {
    bits_ = 0;
    pad_ = 0;
    acc_ = 0;
    hit_end_ = false;
    while (p_ < end_) {
      if (p_[0] == 0xFF && p_ + 1 < end_ && p_[1] >= 0xD0 && p_[1] <= 0xD7) {
        p_ += 2;
        return true;
      }
      p_++;
    }
    return false;
  }

  // libjpeg's read_restart_marker where a failed resync is fatal (as
  // libtiff's old-style JPEG codec makes it): skip to the next marker
  // (next_marker, over any other bytes), which must be RSTn `want`.
  bool restart_strict(int want) {
    bits_ = 0;
    pad_ = 0;
    acc_ = 0;
    hit_end_ = false;
    while (p_ < end_) {
      if (p_[0] == 0xFF && p_ + 1 < end_ && p_[1] != 0x00 && p_[1] != 0xFF) {
        if (p_[1] != 0xD0 + want) return false;
        p_ += 2;
        return true;
      }
      p_++;
    }
    return false;
  }

  // Whether the current interval consumed bits past its data (libjpeg's
  // insufficient_data: zero bits were fed in). Looking ahead past the
  // data does not count.
  bool hit_end() const { return hit_end_; }

  int bits(int n) {
    if (n == 0) return 0;
    fill(n);
    skip(n);
    return (int)((acc_ >> bits_) & ((1u << n) - 1));
  }

  int peek8() {
    fill(8);
    return (int)((acc_ >> (bits_ - 8)) & 0xFF);
  }

  void skip(int n) {
    bits_ -= n;
    if (bits_ < pad_) hit_end_ = true;
  }

  int decode(const Huffman &h) {
    int look = peek8();
    int l = h.look_len[look];
    if (l) {
      skip(l);
      return h.look_val[look];
    }
    int code = bits(8);
    l = 8;
    while (code > h.maxcode[l]) {
      code = (code << 1) | bits(1);
      l++;
      if (l > 16) return 0;  // bad Huffman code: libjpeg warns, gives 0
    }
    return h.vals[(h.valoffset[l] + code) & 0xFF];
  }

 private:
  void fill(int n) {
    while (bits_ < n) {
      uint32_t byte = 0;
      if (p_ < end_ && !(p_[0] == 0xFF && (p_ + 1 >= end_ || p_[1] != 0x00))) {
        byte = *p_;
        p_ += (byte == 0xFF) ? 2 : 1;  // 0xFF00 stuffing
      } else {
        pad_ += 8;  // a marker or the segment's end: zero bits
      }
      acc_ = (acc_ << 8) | byte;
      bits_ += 8;
    }
  }

  const uint8_t *p_;
  const uint8_t *end_;
  uint64_t acc_ = 0;
  int bits_ = 0;
  int pad_ = 0;  // the lowest pad_ bits of acc_ are zero padding
  bool hit_end_ = false;
};

inline int extend(int v, int t) {
  return (t && v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

struct Component {
  int h, v;              // sampling factors
  int bw, bh;            // allocated blocks (whole MCUs)
  int dw, dh;            // downsampled width / height in samples
  std::vector<int16_t> coef;  // bh * bw * 64, natural order
  const uint16_t *qt;    // 64, natural order
};

// libjpeg-turbo's accurate integer IDCT as its x86-64 SIMD code runs it
// (jidctint-sse2.asm / -avx2.asm, which Pillow's libjpeg-turbo uses):
// jidctint.c's islow, CONST_BITS 13, PASS1_BITS 2, with the products of
// pairs formed as pmaddwd forms them, and 16-bit lanes: the dequantised
// coefficients and the sums in0 +- in4, in7 + in3 and in5 + in1 wrap, each
// pass's output saturates to 16 bits, the samples to 8 bits (packsswb),
// and a block whose AC coefficients are all zero takes the DC shortcut
// (shifted in 16 bits). On coefficients in range it is jidctint.c's
// result; on extreme ones (corrupt data) it is the SIMD code's.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr long F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
               F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
               F_1_501321110 = 12299, F_1_847759065 = 15137, F_1_961570560 = 16069,
               F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int16_t wrap16(long v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
inline long sat(long v, long lo, long hi) { return v < lo ? lo : (v > hi ? hi : v); }

// One 8-point pass over in[0..7]: the eight outputs before descaling.
inline void idct_pass(const int16_t *in, long *o) {
  const long z2 = in[2], z3 = in[6];
  const long tmp3 = z2 * (F_0_541196100 + F_0_765366865) + z3 * F_0_541196100;
  const long tmp2 = z2 * F_0_541196100 + z3 * (F_0_541196100 - F_1_847759065);
  const long tmp0 = (long)wrap16((long)in[0] + in[4]) * (1L << kConstBits);
  const long tmp1 = (long)wrap16((long)in[0] - in[4]) * (1L << kConstBits);
  const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const long i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
  const long q3 = wrap16(i7 + i3), q4 = wrap16(i5 + i1);
  const long z3p = q3 * (F_1_175875602 - F_1_961570560) + q4 * F_1_175875602;
  const long z4p = q3 * F_1_175875602 + q4 * (F_1_175875602 - F_0_390180644);
  const long t0 = i7 * (F_0_298631336 - F_0_899976223) + i1 * -F_0_899976223 + z3p;
  const long t3 = i7 * -F_0_899976223 + i1 * (F_1_501321110 - F_0_899976223) + z4p;
  const long t1 = i5 * (F_2_053119869 - F_2_562915447) + i3 * -F_2_562915447 + z4p;
  const long t2 = i5 * -F_2_562915447 + i3 * (F_3_072711026 - F_2_562915447) + z3p;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

void idct_islow(const int16_t *coef, const uint16_t *qt, uint8_t *out, long stride) {
  int16_t ws[64];  // pass 1's output, ws[row * 8 + column]
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; i++) ac_zero = coef[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      const int16_t dc = wrap16((long)wrap16((long)coef[c] * qt[c]) * (1L << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t in[8];
      long o[8];
      for (int r = 0; r < 8; r++) in[r] = wrap16((long)coef[r * 8 + c] * qt[r * 8 + c]);
      idct_pass(in, o);
      const int sh = kConstBits - kPass1Bits;
      for (int r = 0; r < 8; r++)
        ws[r * 8 + c] = (int16_t)sat((o[r] + (1L << (sh - 1))) >> sh, -32768, 32767);
    }
  }
  for (int r = 0; r < 8; r++) {
    long o[8];
    idct_pass(ws + r * 8, o);
    const int sh = kConstBits + kPass1Bits + 3;
    uint8_t *row = out + r * stride;
    for (int c = 0; c < 8; c++)
      row[c] = (uint8_t)(sat(sat((o[c] + (1L << (sh - 1))) >> sh, -32768, 32767), -128, 127) + 128);
  }
}

// One block's coefficients from the entropy-coded data.
inline void decode_block(BitReader &br, const Huffman &dc, const Huffman &ac,
                         int &pred, int16_t *blk) {
  int t = br.decode(dc);
  int diff = t ? extend(br.bits(t), t) : 0;
  pred = (int)((unsigned)pred + (unsigned)diff);
  blk[0] = (int16_t)pred;
  for (int k = 1; k < 64;) {
    int rs = br.decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int v = extend(br.bits(s), s);
      // Past the block (corrupt data): libjpeg's guard entries of
      // jpeg_natural_order all name position 63.
      blk[k < 64 ? kNatural[k] : 63] = (int16_t)v;
      k++;
    } else {
      if (r != 15) break;  // EOB
      k += 16;             // ZRL
    }
  }
}

// Progressive scans (libjpeg's jdphuff.c). A coefficient index past Se
// reads libjpeg's guard entries of jpeg_natural_order, all 63.
inline int natural_guarded(int k) { return k < 64 ? kNatural[k] : 63; }

inline int16_t shifted(int v, int al) { return (int16_t)(int)((unsigned)v << al); }

// decode_mcu_DC_first: one block's DC difference, scaled by 2^Al.
inline void dc_first(BitReader &br, const Huffman &dc, int al, int &pred, int16_t *blk) {
  int t = br.decode(dc);
  int diff = t ? extend(br.bits(t), t) : 0;
  pred = (int)((unsigned)pred + (unsigned)diff);
  blk[0] = shifted(pred, al);
}

// decode_mcu_AC_first: the band Ss..Se of one block, or one block of a
// pending end-of-band run.
inline void ac_first(BitReader &br, const Huffman &ac, int ss, int se, int al, long &eobrun,
                     int16_t *blk) {
  if (eobrun > 0) {
    eobrun--;
    return;
  }
  for (int k = ss; k <= se; k++) {
    int rs = br.decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[natural_guarded(k)] = shifted(extend(br.bits(s), s), al);
    } else if (r == 15) {
      k += 15;  // ZRL
    } else {
      eobrun = 1L << r;
      if (r) eobrun += br.bits(r);
      eobrun--;
      break;
    }
  }
}

// decode_mcu_AC_refine: one correction bit for every nonzero coefficient
// of the band passed over, and the newly nonzero ones (+-2^Al) at their
// zero-run positions.
inline void ac_refine(BitReader &br, const Huffman &ac, int ss, int se, int al, long &eobrun,
                      int16_t *blk) {
  const int p1 = 1 << al, m1 = -(1 << al);
  auto correct = [&](int16_t &c) {
    if (br.bits(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
  };
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.bits(1) ? p1 : m1;  // the new coefficient's size is 1 bit
      } else if (r != 15) {
        eobrun = 1L << r;
        if (r) eobrun += br.bits(r);
        break;
      }
      do {
        int16_t &c = blk[natural_guarded(k)];
        if (c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= se);
      if (s) blk[natural_guarded(k)] = (int16_t)s;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; k++) {
      int16_t &c = blk[natural_guarded(k)];
      if (c != 0) correct(c);
    }
    eobrun--;
  }
}

// The upsampled full-resolution plane of one component (libjpeg-turbo's
// jdsample.c with do_fancy_upsampling: h2v1 and h2v2 "fancy" triangle
// filters for widths above 2, h1v2 fancy, otherwise replication). The
// image rows above and below are the first and last real rows (jdmainct.c
// context rows). `plane` holds the component's rows, `stride` samples
// apart; writes out_h x out_w samples (the caller crops to the image).
// Without `fancy` (lossless files) every case replicates.
void upsample(const Component &c, int hmax, int vmax, const uint8_t *plane, long stride,
              bool fancy, uint8_t *out, long out_w, long out_h) {
  const int hx = hmax / c.h, vx = vmax / c.v;
  const long dw = c.dw, dh = c.dh;
  auto row = [&](long r) {
    if (r < 0) r = 0;
    if (r > dh - 1) r = dh - 1;
    return plane + r * stride;
  };
  if (hx == 1 && vx == 1) {
    for (long y = 0; y < out_h; y++) std::memcpy(out + y * out_w, row(y), out_w);
    return;
  }
  if (fancy && hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    std::vector<uint8_t> tmp(2 * dw);
    for (long y = 0; y < out_h; y++) {
      const uint8_t *in = row(y);
      uint8_t *o = tmp.data();
      int v0 = in[0];
      o[0] = (uint8_t)v0;
      o[1] = (uint8_t)((v0 * 3 + in[1] + 2) >> 2);
      for (long x = 1; x < dw - 1; x++) {
        int v = in[x] * 3;
        o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      int vl = in[dw - 1];
      o[2 * dw - 2] = (uint8_t)((vl * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = (uint8_t)vl;
      std::memcpy(out + y * out_w, tmp.data(), out_w);
    }
    return;
  }
  if (fancy && hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (long y = 0; y < out_h; y++) {
      long r = y / 2;
      bool above = (y % 2) == 0;
      const uint8_t *in0 = row(r);
      const uint8_t *in1 = row(above ? r - 1 : r + 1);
      int bias = above ? 1 : 2;
      uint8_t *o = out + y * out_w;
      for (long x = 0; x < out_w; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  if (fancy && hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<uint8_t> tmp(2 * dw);
    for (long y = 0; y < out_h; y++) {
      long r = y / 2;
      bool above = (y % 2) == 0;
      const uint8_t *in0 = row(r);
      const uint8_t *in1 = row(above ? r - 1 : r + 1);
      uint8_t *o = tmp.data();
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (long x = 1; x < dw - 1; x++) {
        next_sum = in0[x + 1] * 3 + in1[x + 1];
        o[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(out + y * out_w, tmp.data(), out_w);
    }
    return;
  }
  // int_upsample / h2v1_upsample / h2v2_upsample: replication. The row
  // groups of libjpeg's main buffer read the component's padded rows.
  for (long y = 0; y < out_h; y++) {
    const uint8_t *in = plane + (y / vx) * stride;
    uint8_t *o = out + y * out_w;
    for (long x = 0; x < out_w; x++) o[x] = in[x / hx];
  }
}

// ---------------------------------------------------------------------------
// CCITT T.4 / T.6 (TIFF compressions 2, 3 and 4), as libtiff's tif_fax3.c
// decodes them: each row a list of run lengths, white first, built by its
// EXPAND1D / EXPAND2D logic (zero-length runs, the reference line's
// imaginary change at the row's end and its CLEANUP_RUNS repair kept), so
// the rows libtiff hands Pillow come out bit for bit. Black runs are 1
// bits, whatever the photometric interpretation.

// The modified Huffman codes of T.4 (tables 2 and 3): terminating codes
// of runs 0-63, make-up codes of 64-1728 per colour, and the extended
// make-up codes of 1792-2560 both colours share.
const char *const kWhiteTerm[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",     "1110",
    "1111",     "10011",    "10100",    "00111",    "01000",    "001000",   "000011",
    "110100",   "110101",   "101010",   "101011",   "0100111",  "0001100",  "0001000",
    "0010111",  "0000011",  "0000100",  "0101000",  "0101011",  "0010011",  "0100100",
    "0011000",  "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char *const kWhiteMakeup[27] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",  "00110111",
    "01100100",  "01100101",  "01101000",  "01100111",  "011001100", "011001101",
    "011010010", "011010011", "011010100", "011010101", "011010110", "011010111",
    "011011000", "011011001", "011011010", "011011011", "010011000", "010011001",
    "010011010", "011000",    "010011011"};
const char *const kBlackTerm[64] = {
    "0000110111",   "010",          "11",           "10",           "011",
    "0011",         "0010",         "00011",        "000101",       "000100",
    "0000100",      "0000101",      "0000111",      "00000100",     "00000111",
    "000011000",    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",  "00000010111",
    "00000011000",  "000011001010", "000011001011", "000011001100", "000011001101",
    "000001101000", "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100", "000001100101",
    "000001010010", "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char *const kBlackMakeup[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",  "000000110011",
    "000000110100",  "000000110101",  "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char *const kExtMakeup[13] = {
    "00000001000",  "00000001100",  "00000001101",  "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

constexpr int kFaxPeek = 13;  // the longest code: black make-up, 13 bits
constexpr int16_t kFaxEol = -1;
// 2D mode codes (T.4 table 4), looked up in 7 bits.
enum FaxMode : int8_t { kBad, kPass, kHoriz, kV0, kVR1, kVR2, kVR3, kVL1, kVL2, kVL3, kExt, kEol2d };

struct FaxCode {
  uint8_t len = 0;  // 0: no code starts with these bits
  int16_t value = 0;  // run length, kFaxEol, or a FaxMode
};

struct FaxTables {
  std::vector<FaxCode> white, black, mode;
  FaxTables() : white(1 << kFaxPeek), black(1 << kFaxPeek), mode(1 << 7) {
    auto add = [](std::vector<FaxCode> &lut, int bits, const char *code, int value) {
      int len = (int)std::strlen(code), c = 0;
      for (int i = 0; i < len; i++) c = (c << 1) | (code[i] - '0');
      for (int s = 0; s < (1 << (bits - len)); s++) lut[(c << (bits - len)) | s] = {(uint8_t)len, (int16_t)value};
    };
    for (int i = 0; i < 64; i++) {
      add(white, kFaxPeek, kWhiteTerm[i], i);
      add(black, kFaxPeek, kBlackTerm[i], i);
    }
    for (int i = 0; i < 27; i++) {
      add(white, kFaxPeek, kWhiteMakeup[i], 64 * (i + 1));
      add(black, kFaxPeek, kBlackMakeup[i], 64 * (i + 1));
    }
    for (int i = 0; i < 13; i++) {
      add(white, kFaxPeek, kExtMakeup[i], 1792 + 64 * i);
      add(black, kFaxPeek, kExtMakeup[i], 1792 + 64 * i);
    }
    add(white, kFaxPeek, "000000000001", kFaxEol);
    add(black, kFaxPeek, "000000000001", kFaxEol);
    const char *modes[] = {"0001", "001", "1", "011", "000011", "0000011", "010", "000010",
                           "0000010", "0000001", "0000000"};
    for (int m = kPass; m <= kEol2d; m++) add(mode, 7, modes[m - kPass], m);
  }
};

const FaxTables &fax_tables() {
  static const FaxTables tables;
  return tables;
}

// MSB-first bits; past the end, zeros (libtiff pads its last bits so).
class FaxBits {
 public:
  FaxBits(const uint8_t *p, long n) : p_(p), nbits_(n * 8) {}
  int peek(int k) const {
    uint32_t v = 0;
    long byte = pos_ >> 3;
    for (int j = 0; j < 4; j++) v = (v << 8) | (byte + j < nbits_ / 8 ? p_[byte + j] : 0);
    return (int)((v << (pos_ & 7)) >> (32 - k));
  }
  void skip(int k) { pos_ += k; }
  bool exhausted() const { return pos_ >= nbits_; }
  void align() { pos_ = (pos_ + 7) & ~7L; }

 private:
  const uint8_t *p_;
  long nbits_;
  long pos_ = 0;
};

// One row's decode state: libtiff's thisrun/pa, a0 and RunLength.
struct FaxRow {
  std::vector<long> runs;
  long a0 = 0, run_length = 0;
  void set(long x) {  // libtiff's SETVALUE
    runs.push_back(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup(long lastx) {  // CLEANUP_RUNS
    if (run_length) set(0);
    if (a0 != lastx) {
      while (a0 > lastx && !runs.empty()) {
        a0 -= runs.back();
        runs.pop_back();
      }
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (runs.size() & 1) set(0);
        set(lastx - a0);
      } else if (a0 > lastx) {
        set(lastx);
        set(0);
      }
    }
  }
};

// One colour's run: make-up codes then a terminating code (added to the
// row with set()). Returns 1 done, 0 an EOL met, -1 a bad code.
int fax_run(FaxBits &br, const std::vector<FaxCode> &lut, FaxRow &row) {
  for (;;) {
    const FaxCode &c = lut[br.peek(kFaxPeek)];
    if (c.len == 0) return -1;
    br.skip(c.len);
    if (c.value == kFaxEol) return 0;
    if (c.value < 64) {
      row.set(c.value);
      return 1;
    }
    row.a0 += c.value;
    row.run_length += c.value;
  }
}

// EXPAND1D: white and black runs to the row's end. Returns 1 done, 0 an
// EOL met, -1 a bad code.
int fax_expand1d(FaxBits &br, FaxRow &row, long lastx) {
  const FaxTables &t = fax_tables();
  int r;
  for (;;) {
    if ((r = fax_run(br, t.white, row)) <= 0 || row.a0 >= lastx) break;
    if ((r = fax_run(br, t.black, row)) <= 0 || row.a0 >= lastx) break;
    size_t n = row.runs.size();
    if (n >= 2 && row.runs[n - 1] == 0 && row.runs[n - 2] == 0) row.runs.resize(n - 2);
  }
  row.cleanup(lastx);
  return r;
}

// EXPAND2D against the reference row's runs (padded with zeros past its
// end). Returns 1 done, 0 an EOL met, -1 corrupt data.
int fax_expand2d(FaxBits &br, FaxRow &row, const std::vector<long> &ref, long lastx) {
  const FaxTables &t = fax_tables();
  size_t pb = 0;
  auto next_ref = [&]() -> long { return pb < ref.size() ? ref[pb++] : (pb++, 0L); };
  long b1 = next_ref();
  const size_t limit = ref.size() + 4;
  auto check_b1 = [&]() {
    if (!row.runs.empty())
      while (b1 <= row.a0 && b1 < lastx && pb < limit) {
        b1 += next_ref();
        b1 += next_ref();
      }
  };
  while (row.a0 < lastx) {
    if (pb > limit || row.runs.size() > (size_t)(2 * lastx + 8)) return -1;
    const FaxCode &c = t.mode[br.peek(7)];
    if (c.len == 0) return -1;
    br.skip(c.len);
    switch (c.value) {
      case kPass:
        check_b1();
        b1 += next_ref();
        row.run_length += b1 - row.a0;
        row.a0 = b1;
        b1 += next_ref();
        break;
      case kHoriz: {
        bool black_first = row.runs.size() & 1;
        const std::vector<FaxCode> &first = black_first ? t.black : t.white;
        const std::vector<FaxCode> &second = black_first ? t.white : t.black;
        if (fax_run(br, first, row) != 1 || fax_run(br, second, row) != 1) return -1;
        check_b1();
        break;
      }
      case kV0:
      case kVR1:
      case kVR2:
      case kVR3:
        check_b1();
        row.set(b1 - row.a0 + (c.value - kV0));
        b1 += next_ref();
        break;
      case kVL1:
      case kVL2:
      case kVL3: {
        const long k = c.value - kVL1 + 1;
        check_b1();
        if (b1 < row.a0 + k) return -1;
        row.set(b1 - row.a0 - k);
        --pb;
        b1 -= pb < ref.size() ? ref[pb] : 0;
        break;
      }
      case kEol2d:
        // An EOL inside a row: libtiff ends the row there.
        row.runs.push_back(lastx - row.a0);
        if (br.peek(4)) return -1;
        br.skip(4);
        row.cleanup(lastx);
        return 0;
      default:  // the uncompressed-mode extension
        return -3;
    }
  }
  if (row.run_length) {
    if (row.run_length + row.a0 < lastx) {  // expect a final V0
      if (!br.peek(1)) return -1;
      br.skip(1);
    }
    row.set(0);
  }
  row.cleanup(lastx);
  return 1;
}

// libtiff's SYNC_EOL: to the end of the next EOL (eleven or more 0 bits
// and a 1), unless an EOL was just read. Returns false at the data's end.
bool fax_sync_eol(FaxBits &br, bool &eol_seen) {
  if (!eol_seen) {
    while (br.peek(11) != 0) {
      if (br.exhausted()) return false;
      br.skip(1);
    }
  }
  while (br.peek(8) == 0) {
    if (br.exhausted()) return false;
    br.skip(8);
  }
  while (br.peek(1) == 0) br.skip(1);
  br.skip(1);
  eol_seen = false;
  return true;
}

// The row's pixels as 1 bits for black runs, MSB first (_TIFFFax3fillruns).
void fax_fill(const FaxRow &row, long lastx, uint8_t *out) {
  std::memset(out, 0, (size_t)(lastx + 7) / 8);
  long x = 0;
  for (size_t i = 0; i < row.runs.size() && x < lastx; i++) {
    long run = std::min(row.runs[i], lastx - x);
    if (run < 0) break;
    if (i & 1)
      for (long j = x; j < x + run; j++) out[j >> 3] |= (uint8_t)(0x80 >> (j & 7));
    x += run;
  }
}

// ---------------------------------------------------------------------------
// Arithmetic-coded JPEG (libjpeg's jdarith.c and jaricom.c).

// T.81 table D.2 packed as jaricom.c packs it: Qe << 16 | next index after
// an MPS << 8 | switch-MPS flag << 7 | next index after an LPS. Entry 113
// is the fixed 0.5 estimate of signs and refinement bits.
#define ARI(qe, lps, mps, sw) (((int32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
constexpr int32_t kAriTab[114] = {
    ARI(0x5a1d, 1, 1, 1),     ARI(0x2586, 14, 2, 0),    ARI(0x1114, 16, 3, 0),
    ARI(0x080b, 18, 4, 0),    ARI(0x03d8, 20, 5, 0),    ARI(0x01da, 23, 6, 0),
    ARI(0x00e5, 25, 7, 0),    ARI(0x006f, 28, 8, 0),    ARI(0x0036, 30, 9, 0),
    ARI(0x001a, 33, 10, 0),   ARI(0x000d, 35, 11, 0),   ARI(0x0006, 9, 12, 0),
    ARI(0x0003, 10, 13, 0),   ARI(0x0001, 12, 13, 0),   ARI(0x5a7f, 15, 15, 1),
    ARI(0x3f25, 36, 16, 0),   ARI(0x2cf2, 38, 17, 0),   ARI(0x207c, 39, 18, 0),
    ARI(0x17b9, 40, 19, 0),   ARI(0x1182, 42, 20, 0),   ARI(0x0cef, 43, 21, 0),
    ARI(0x09a1, 45, 22, 0),   ARI(0x072f, 46, 23, 0),   ARI(0x055c, 48, 24, 0),
    ARI(0x0406, 49, 25, 0),   ARI(0x0303, 51, 26, 0),   ARI(0x0240, 52, 27, 0),
    ARI(0x01b1, 54, 28, 0),   ARI(0x0144, 56, 29, 0),   ARI(0x00f5, 57, 30, 0),
    ARI(0x00b7, 59, 31, 0),   ARI(0x008a, 60, 32, 0),   ARI(0x0068, 62, 33, 0),
    ARI(0x004e, 63, 34, 0),   ARI(0x003b, 32, 35, 0),   ARI(0x002c, 33, 9, 0),
    ARI(0x5ae1, 37, 37, 1),   ARI(0x484c, 64, 38, 0),   ARI(0x3a0d, 65, 39, 0),
    ARI(0x2ef1, 67, 40, 0),   ARI(0x261f, 68, 41, 0),   ARI(0x1f33, 69, 42, 0),
    ARI(0x19a8, 70, 43, 0),   ARI(0x1518, 72, 44, 0),   ARI(0x1177, 73, 45, 0),
    ARI(0x0e74, 74, 46, 0),   ARI(0x0bfb, 75, 47, 0),   ARI(0x09f8, 77, 48, 0),
    ARI(0x0861, 78, 49, 0),   ARI(0x0706, 79, 50, 0),   ARI(0x05cd, 48, 51, 0),
    ARI(0x04de, 50, 52, 0),   ARI(0x040f, 50, 53, 0),   ARI(0x0363, 51, 54, 0),
    ARI(0x02d4, 52, 55, 0),   ARI(0x025c, 53, 56, 0),   ARI(0x01f8, 54, 57, 0),
    ARI(0x01a4, 55, 58, 0),   ARI(0x0160, 56, 59, 0),   ARI(0x0125, 57, 60, 0),
    ARI(0x00f6, 58, 61, 0),   ARI(0x00cb, 59, 62, 0),   ARI(0x00ab, 61, 63, 0),
    ARI(0x008f, 61, 32, 0),   ARI(0x5b12, 65, 65, 1),   ARI(0x4d04, 80, 66, 0),
    ARI(0x412c, 81, 67, 0),   ARI(0x37d8, 82, 68, 0),   ARI(0x2fe8, 83, 69, 0),
    ARI(0x293c, 84, 70, 0),   ARI(0x2379, 86, 71, 0),   ARI(0x1edf, 87, 72, 0),
    ARI(0x1aa9, 87, 73, 0),   ARI(0x174e, 72, 74, 0),   ARI(0x1424, 72, 75, 0),
    ARI(0x119c, 74, 76, 0),   ARI(0x0f6b, 74, 77, 0),   ARI(0x0d51, 75, 78, 0),
    ARI(0x0bb6, 77, 79, 0),   ARI(0x0a40, 77, 48, 0),   ARI(0x5832, 80, 81, 1),
    ARI(0x4d1c, 88, 82, 0),   ARI(0x438e, 89, 83, 0),   ARI(0x3bdd, 90, 84, 0),
    ARI(0x34ee, 91, 85, 0),   ARI(0x2eae, 92, 86, 0),   ARI(0x299a, 93, 87, 0),
    ARI(0x2516, 86, 71, 0),   ARI(0x5570, 88, 89, 1),   ARI(0x4ca9, 95, 90, 0),
    ARI(0x44d9, 96, 91, 0),   ARI(0x3e22, 97, 92, 0),   ARI(0x3824, 99, 93, 0),
    ARI(0x32b4, 99, 94, 0),   ARI(0x2e17, 93, 86, 0),   ARI(0x56a8, 95, 96, 1),
    ARI(0x4f46, 101, 97, 0),  ARI(0x47e5, 102, 98, 0),  ARI(0x41cf, 103, 99, 0),
    ARI(0x3c3d, 104, 100, 0), ARI(0x375e, 99, 93, 0),   ARI(0x5231, 105, 102, 0),
    ARI(0x4c0f, 106, 103, 0), ARI(0x4639, 107, 104, 0), ARI(0x415e, 103, 99, 0),
    ARI(0x5627, 105, 106, 1), ARI(0x50e7, 108, 107, 0), ARI(0x4b85, 109, 103, 0),
    ARI(0x5597, 110, 109, 0), ARI(0x504f, 111, 107, 0), ARI(0x5a10, 110, 111, 1),
    ARI(0x5522, 112, 109, 0), ARI(0x59eb, 112, 111, 1), ARI(0x5a1d, 113, 113, 0)};
#undef ARI

// jdarith.c's decoder over one scan's entropy-coded segment. Its restart
// markers are the only markers inside; the segment's end stands for the
// marker after it. Once a marker is met the decoder is fed zeros, as
// libjpeg feeds them, until a restart steps over it.
class ArithDecoder {
 public:
  ArithDecoder(const uint8_t *p, long n) : p_(p), end_(p + n) {}

  void reset() {
    c_ = 0;
    a_ = 0;
    ct_ = -16;  // read 2 bytes into C first
    broken_ = false;
  }

  // A spectral or magnitude overflow in corrupt data: libjpeg warns and
  // decodes nothing more until the next restart.
  bool broken() const { return broken_; }
  void set_broken() { broken_ = true; }

  // jdmarker.c read_restart_marker for RSTn `want`, with
  // jpeg_resync_to_restart's choices, then a fresh decoder.
  void restart(int want) {
    int m = marker_ ? marker_code_ : next_marker();
    for (;;) {
      int action;
      if (m < 0) {
        action = 3;  // a marker that is no RSTn: left for the scan's end
      } else if (m == want) {
        action = 1;
      } else if (m == ((want + 1) & 7) || m == ((want + 2) & 7)) {
        action = 3;
      } else if (m == ((want - 1) & 7) || m == ((want - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        marker_ = false;
        break;
      }
      if (action == 3) {
        marker_ = true;
        marker_code_ = m;
        break;
      }
      m = next_marker();
    }
    reset();
  }

  // arith_decode: one binary decision with the statistics bin *st.
  int decode(uint8_t *st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        c_ = (c_ << 8) | byte();
        if ((ct_ += 8) < 0) {
          if (++ct_ == 0) a_ = 0x8000;  // the 2 initial bytes are in
        }
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF);
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {
        a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

 private:
  // get_byte with arith_decode's marker handling: 0xFF00 is 0xFF, a
  // marker is read and then stands for zero data.
  int byte() {
    if (marker_) return 0;
    if (p_ >= end_) {
      marker_ = true;
      marker_code_ = -1;
      return 0;
    }
    int d = *p_++;
    if (d != 0xFF) return d;
    if (p_ < end_ && *p_ == 0x00) {
      p_++;
      return 0xFF;
    }
    marker_ = true;
    marker_code_ = p_ < end_ ? (*p_++ & 7) : -1;
    return 0;
  }

  // next_marker: skip to the next marker; its RSTn number, or -1 for the
  // segment's end.
  int next_marker() {
    while (p_ < end_) {
      if (*p_ == 0xFF && p_ + 1 < end_ && p_[1] != 0x00) {
        int m = p_[1] & 7;
        p_ += 2;
        return m;
      }
      p_++;
    }
    return -1;
  }

  const uint8_t *p_;
  const uint8_t *end_;
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16;
  bool marker_ = false;
  int marker_code_ = -1;
  bool broken_ = false;
};

// The statistics of one scan: DC and AC bins of the 16 arithmetic
// conditioning tables, the fixed bin, and each table's L, U and Kx (DAC).
struct ArithStats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
  uint8_t fixed = 113;
  const uint8_t *cond;  // 48 bytes: L[16], U[16], Kx[16]
};

// One DC difference (F.2.4.1 with F.1.4.4.1's conditioning): updates the
// component's context and its last value (mod 2^16). False on a
// magnitude overflow.
bool arith_dc(ArithDecoder &d, ArithStats &s, int tbl, int &ctx, int &last) {
  uint8_t *st = s.dc[tbl] + ctx;
  if (d.decode(st) == 0) {
    ctx = 0;
    return true;
  }
  const int sign = d.decode(st + 1);
  st += 2 + sign;
  int m = d.decode(st);
  if (m) {
    st = s.dc[tbl] + 20;
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      st += 1;
    }
  }
  const int lo = s.cond[tbl], hi = s.cond[16 + tbl];
  if (m < (int)((1L << lo) >> 1))
    ctx = 0;
  else if (m > (int)((1L << hi) >> 1))
    ctx = 12 + sign * 4;
  else
    ctx = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  last = (last + v) & 0xFFFF;
  return true;
}

// The AC coefficients ss..se of one block (F.2.4.2, G.1.3.2), each scaled
// by 2^al. False on a spectral or magnitude overflow.
bool arith_ac(ArithDecoder &d, ArithStats &s, int tbl, int ss, int se, int al, int16_t *blk) {
  const int kx = s.cond[32 + tbl];
  for (int k = ss; k <= se; k++) {
    uint8_t *st = s.ac[tbl] + 3 * (k - 1);
    if (d.decode(st)) break;  // EOB
    while (d.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) return false;
    }
    const int sign = d.decode(&s.fixed);
    st += 2;
    int m = d.decode(st);
    if (m && d.decode(st)) {
      m <<= 1;
      st = s.ac[tbl] + (k <= kx ? 189 : 217);
      while (d.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (d.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
  }
  return true;
}

// decode_mcu_AC_refine: the bit al of the band ss..se. False on a
// spectral overflow.
bool arith_ac_refine(ArithDecoder &d, ArithStats &s, int tbl, int ss, int se, int al,
                     int16_t *blk) {
  const int p1 = 1 << al, m1 = (int)(-1U << al);
  int kex = se;
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; k++) {
    uint8_t *st = s.ac[tbl] + 3 * (k - 1);
    if (k > kex && d.decode(st)) break;  // EOB
    for (;;) {
      int16_t &c = blk[kNatural[k]];
      if (c) {  // previously nonzero: one correction bit
        if (d.decode(st + 2)) c = (int16_t)(c < 0 ? c + m1 : c + p1);
        break;
      }
      if (d.decode(st + 1)) {  // newly nonzero
        c = (int16_t)(d.decode(&s.fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data) of a
// progressive file whose last scans leave some of AC 1-9 unrefined: each
// block's zero coefficients among them are estimated from the 5x5
// neighbourhood of DC values, or, when a component had no AC scan at all,
// its DC and AC 1-9 from a Gaussian-like kernel over the same window.

inline int smooth_pred(long num, long q, int al, bool clamp) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// The IDCT of every block of one component with smoothing, into `plane`
// (blocks of 8x8 samples, stride bw * 8). vsamp: the component's v;
// total_imcu: the frame's iMCU rows; coef_bits: the latched bits of
// zigzag positions 0-9 after the last scan.
void idct_smoothed(const Component &k, int vsamp, long total_imcu, const int32_t *coef_bits,
                   uint8_t *plane) {
  const long stride = (long)k.bw * 8;
  const long hib = (k.dh + 7) / 8, wib = (k.dw + 7) / 8;
  const long last_imcu = total_imcu - 1, last_col = wib - 1;
  const uint16_t *qt = k.qt;
  const long q00 = qt[0], q01 = qt[1], q10 = qt[8], q20 = qt[16], q11 = qt[9], q02 = qt[2],
             q03 = qt[3], q12 = qt[10], q21 = qt[17], q30 = qt[24];
  bool change_dc = true;
  for (int i = 1; i < 10; i++) change_dc = change_dc && coef_bits[i] == -1;
  auto block = [&](long row, long col) { return &k.coef[((size_t)row * k.bw + col) * 64]; };
  int16_t ws[64];
  for (long imcu = 0; imcu < total_imcu; imcu++) {
    long block_rows = vsamp;
    if (imcu == last_imcu) {
      block_rows = hib % vsamp;
      if (block_rows == 0) block_rows = vsamp;
    }
    const long image_block_rows = block_rows * total_imcu;
    for (long br = 0; br < block_rows; br++) {
      const long row = imcu * vsamp + br;
      const long ibr = imcu * block_rows + br;  // libjpeg-turbo's count
      const long prev = ibr > 0 ? row - 1 : row;
      const long pprev = ibr > 1 ? row - 2 : prev;
      const long next = ibr < image_block_rows - 1 ? row + 1 : row;
      const long nnext = ibr < image_block_rows - 2 ? row + 2 : next;
      const long rows[5] = {pprev, prev, row, next, nnext};
      int dc[5][5];  // [row][column - 2 .. column + 2]
      for (int r = 0; r < 5; r++)
        for (int c = 0; c < 5; c++) dc[r][c] = block(rows[r], 0)[0];
      for (long bn = 0; bn <= last_col; bn++) {
        std::memcpy(ws, block(row, bn), sizeof(ws));
        if (bn == 0 && bn < last_col)
          for (int r = 0; r < 5; r++) dc[r][3] = dc[r][4] = block(rows[r], 1)[0];
        if (bn + 1 < last_col)
          for (int r = 0; r < 5; r++) dc[r][4] = block(rows[r], bn + 2)[0];
#define DC(i) ((long)dc[((i) - 1) / 5][((i) - 1) % 5])
        int al;
        if ((al = coef_bits[1]) != 0 && ws[1] == 0) {
          long num = q00 * (change_dc
              ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) - 13 * DC(9) + 3 * DC(10)
                 - 3 * DC(11) + 38 * DC(12) - 38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17)
                 - 13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25))
              : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
          ws[1] = (int16_t)smooth_pred(num, q01, al, true);
        }
        if ((al = coef_bits[2]) != 0 && ws[8] == 0) {
          long num = q00 * (change_dc
              ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) + 13 * DC(7)
                 + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) - 13 * DC(17) - 38 * DC(18)
                 - 13 * DC(19) + DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25))
              : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
          ws[8] = (int16_t)smooth_pred(num, q10, al, true);
        }
        if ((al = coef_bits[3]) != 0 && ws[16] == 0) {
          long num = q00 * (change_dc
              ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) - 14 * DC(13)
                 - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23))
              : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
          ws[16] = (int16_t)smooth_pred(num, q20, al, true);
        }
        if ((al = coef_bits[4]) != 0 && ws[9] == 0) {
          long num = q00 * (change_dc
              ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) + DC(21)
                 - DC(25))
              : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) + DC(22)
                 - DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9)));
          ws[9] = (int16_t)smooth_pred(num, q11, al, true);
        }
        if ((al = coef_bits[5]) != 0 && ws[2] == 0) {
          long num = q00 * (change_dc
              ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) - 14 * DC(13)
                 + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) + 2 * DC(19))
              : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
          ws[2] = (int16_t)smooth_pred(num, q02, al, true);
        }
        if (change_dc) {
          if ((al = coef_bits[6]) != 0 && ws[3] == 0) {
            long num = q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19));
            ws[3] = (int16_t)smooth_pred(num, q03, al, true);
          }
          if ((al = coef_bits[7]) != 0 && ws[10] == 0) {
            long num = q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19));
            ws[10] = (int16_t)smooth_pred(num, q12, al, true);
          }
          if ((al = coef_bits[8]) != 0 && ws[17] == 0) {
            long num = q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19));
            ws[17] = (int16_t)smooth_pred(num, q21, al, true);
          }
          if ((al = coef_bits[9]) != 0 && ws[24] == 0) {
            long num = q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19));
            ws[24] = (int16_t)smooth_pred(num, q30, al, true);
          }
          long num = q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5)
                            - 6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10)
                            - 8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14)
                            - 8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) + 6 * DC(19)
                            - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24)
                            - 2 * DC(25));
          ws[0] = (int16_t)smooth_pred(num, q00, 0, false);
        }
#undef DC
        idct_islow(ws, qt, plane + row * 8 * stride + bn * 8, stride);
        for (int r = 0; r < 5; r++)
          for (int c = 0; c < 4; c++) dc[r][c] = dc[r][c + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Lossless JPEG (libjpeg-turbo's jdlhuff.c, jddiffct.c and jdlossls.c):
// Huffman-coded sample differences, undifferenced row by row with the
// scan's predictor (Ss, 1-7), scaled up by the point transform (Al).

struct LosslessPlane {
  int h, v;              // sampling factors
  long dw, dh;           // samples
  long pw, ph;           // padded to whole MCUs
  std::vector<int32_t> diff;   // ph x pw differences of the current scan
  std::vector<int32_t> undiff; // ph x pw undifferenced samples (0..65535)
  std::vector<uint8_t> out;    // dh x dw samples
  bool first_row = true;       // jpeg_undifference_first_row pending
};

// Undifference one row y of a component with predictor psv and point
// transform pt, then write its scaled samples.
void undifference_row(LosslessPlane &p, long y, int psv, int pt) {
  const int32_t *d = &p.diff[(size_t)y * p.pw];
  int32_t *u = &p.undiff[(size_t)y * p.pw];
  const long w = p.dw;
  if (p.first_row) {
    int ra = (d[0] + (1 << (8 - pt - 1))) & 0xFFFF;
    u[0] = ra;
    for (long x = 1; x < w; x++) u[x] = ra = (d[x] + ra) & 0xFFFF;
    p.first_row = false;
  } else {
    const int32_t *prev = u - p.pw;
    int rb = prev[0];
    int ra = (d[0] + rb) & 0xFFFF;
    u[0] = ra;
    for (long x = 1; x < w; x++) {
      const int rc = rb;
      rb = prev[x];
      long pred;
      switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = (long)ra + rb - rc; break;
        case 5: pred = ra + (((long)rb - rc) >> 1); break;
        case 6: pred = rb + (((long)ra - rc) >> 1); break;
        default: pred = ((long)ra + rb) >> 1; break;
      }
      u[x] = ra = (int)((d[x] + pred) & 0xFFFF);
    }
  }
  uint8_t *o = &p.out[(size_t)y * p.dw];
  for (long x = 0; x < w; x++) o[x] = (uint8_t)(u[x] << pt);
}

}  // namespace

extern "C" {

// PNG: `raw` holds h rows of 1 filter byte + `row_bytes`; writes the
// unfiltered h x row_bytes bytes to `out`. bpp: bytes per complete
// pixel (at least 1). Returns 0, or kCorrupt on a filter type above 4.
long png_unfilter(const uint8_t *raw, long h, long row_bytes, long bpp, uint8_t *out) {
  for (long y = 0; y < h; y++) {
    const uint8_t *src = raw + y * (row_bytes + 1);
    int ftype = src[0];
    src++;
    uint8_t *dst = out + y * row_bytes;
    const uint8_t *up = y > 0 ? dst - row_bytes : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(dst, src, row_bytes);
        break;
      case 1:
        for (long x = 0; x < row_bytes; x++)
          dst[x] = (uint8_t)(src[x] + (x >= bpp ? dst[x - bpp] : 0));
        break;
      case 2:
        for (long x = 0; x < row_bytes; x++) dst[x] = (uint8_t)(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (long x = 0; x < row_bytes; x++) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          dst[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < row_bytes; x++) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          dst[x] = (uint8_t)(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return kCorrupt;
    }
  }
  return 0;
}

// TIFF PackBits (compression 32773): decodes `src` into at most `cap`
// bytes of `dst`; returns the bytes written.
long tiff_packbits(const uint8_t *src, long n, uint8_t *dst, long cap) {
  long i = 0, o = 0;
  while (i < n && o < cap) {
    int c = (int8_t)src[i++];
    if (c >= 0) {
      long len = c + 1;
      if (i + len > n) len = n - i;
      if (o + len > cap) len = cap - o;
      std::memcpy(dst + o, src + i, len);
      i += c + 1;
      o += len;
    } else if (c != -128) {
      if (i >= n) break;
      long len = 1 - c;
      if (o + len > cap) len = cap - o;
      std::memset(dst + o, src[i++], len);
      o += len;
    }
  }
  return o;
}

// TIFF LZW (compression 5, the MSB-first codes of TIFF 6.0 with the
// early code-width change): decodes one strip into at most `cap` bytes.
// Returns the bytes written, or kUnsupported for the old LSB-first form.
long tiff_lzw(const uint8_t *src, long n, uint8_t *dst, long cap) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return kUnsupported;
  constexpr int kClear = 256, kEoi = 257;
  std::vector<int32_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<int32_t> length(4096);
  std::vector<uint8_t> stack(4096);
  for (int i = 0; i < 256; i++) {
    prefix[i] = -1;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int next = 258, width = 9, prev = -1;
  uint64_t acc = 0;
  int bits = 0;
  long i = 0, o = 0;
  while (o < cap) {
    while (bits < width && i < n) {
      acc = (acc << 8) | src[i++];
      bits += 8;
    }
    if (bits < width) break;
    int code = (int)((acc >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      next = 258;
      width = 9;
      prev = -1;
      continue;
    }
    int emit;
    if (code < next) {
      emit = code;
    } else if (code == next && prev >= 0) {
      emit = -1;  // KwKwK: prev's string + its first byte
    } else {
      return kCorrupt;
    }
    // Write the string of `emit` (or prev + first(prev)) to dst.
    int base = emit >= 0 ? emit : prev;
    int len = length[base];
    int k = len;
    int c = base;
    while (k > 0) {
      stack[--k] = suffix[c];
      c = prefix[c];
    }
    for (int j = 0; j < len && o < cap; j++) dst[o++] = stack[j];
    if (emit < 0 && o < cap) dst[o++] = first[base];
    if (prev >= 0 && next < 4096) {
      prefix[next] = prev;
      suffix[next] = first[base];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      next++;
    }
    prev = emit >= 0 ? emit : next - 1;
    if (next + 1 >= (1 << width) && width < 12) width++;
  }
  return o;
}

// GIF LZW: the image data of one frame, from the byte after its minimum
// code size `bits` to the end of the file, into the (ysize, xsize) frame
// `out`, as Pillow's GifDecode.c decodes it for the first frame: codes
// LSB first in length-prefixed sub-blocks, starting at bits + 1 wide and
// widening after code 2^k - 1 is defined, up to 12 bits; a full table
// waits for a clear code; interlaced rows in the passes 8/8/4/2. The
// image is done when its last pixel is written (the rest of the data is
// not read). Pillow feeds the decoder 64 KiB at a time and raises when
// the file ends before the image does; an end code before the last pixel
// only pauses it, so it goes on with the next 64 KiB if there is one.
// Returns 0, kTruncated, kCorrupt (a code past the table) or
// kUnsupported (bits above 12).
long gif_lzw(const uint8_t *src, long n, long bits, long interlace, long xsize, long ysize,
             uint8_t *out) {
  constexpr int kTable = 4096, kBits = 12;
  constexpr long kBlock = 65536;
  if (bits < 0 || bits > kBits) return kUnsupported;
  if (xsize <= 0 || ysize <= 0) return kCorrupt;
  std::vector<uint8_t> data(kTable), buffer(kTable);
  std::vector<uint16_t> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int pass = interlace ? 1 : 0, step = interlace ? 8 : 1;
  int state = 1, next = 0, codesize = 0, codemask = 0, bufferindex = kTable;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0, lastcode = 0;
  uint8_t lastdata = 0;
  long x = 0, y = 0, pos = 0, fed = std::min(n, kBlock);
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = (int)bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kTable;
      state = 2;
    }
    const uint8_t *p;
    int len;
    if (bufferindex < kTable) {
      len = kTable - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = kTable;
    } else {
      bool pause = false;
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= (uint32_t)src[pos++] << bitcount;
          bitcount += 8;
          blocksize--;
        } else if (fed - pos < 1 || fed - pos < (long)src[pos] + 1) {
          pause = true;  // only whole sub-blocks are decoded
          break;
        } else {
          blocksize = src[pos++];
        }
      }
      int c = pause ? end : (int)(bitbuffer & (uint32_t)codemask);
      if (!pause) {
        bitbuffer >>= codesize;
        bitcount -= codesize;
      }
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end) {
        // Pillow's decode call returns here; its next read of the file
        // either feeds more data or ends the load as truncated.
        if (fed == n) return kTruncated;
        fed = std::min(n, fed + kBlock);
        continue;
      }
      len = 1;
      p = &lastdata;
      if (state == 2) {
        if (c > clear) return kCorrupt;
        lastdata = (uint8_t)c;
        lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) return kCorrupt;
        if (c == next) {
          if (bufferindex <= 0) return kCorrupt;
          buffer[--bufferindex] = lastdata;
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 0 || c >= kTable) return kCorrupt;
          buffer[--bufferindex] = data[c];
          c = link[c];
        }
        lastdata = (uint8_t)c;
        if (next < kTable) {
          data[next] = (uint8_t)c;
          link[next] = (uint16_t)lastcode;
          if (next == codemask && codesize < kBits) {
            codesize++;
            codemask = (1 << codesize) - 1;
          }
          next++;
        }
        lastcode = thiscode;
      }
    }
    if (y >= ysize) return kCorrupt;
    for (int k = 0; k < len; k++) {
      out[y * xsize + x] = p[k];
      if (++x < xsize) continue;
      x = 0;
      y += step;
      while (y >= ysize) {
        if (pass == 1) {
          y = 4;
          pass = 2;
        } else if (pass == 2) {
          step = 4;
          y = 2;
          pass = 3;
        } else if (pass == 3) {
          step = 2;
          y = 1;
          pass = 0;
        } else {
          return 0;  // the last pixel is written
        }
      }
    }
  }
}

// Sequential, progressive or lossless JPEG, Huffman or arithmetic coded,
// with 1, 3 or 4 components.
// frame: [width, height, ncomp, colour (0: as stored, 1: YCbCr -> RGB,
//         2: YCCK -> CMYK), coding (1: progressive, 2: arithmetic,
//         4: lossless, 8: block smoothing, 16: raw: each component's
//         plane at its own resolution over the whole MCU grid, neither
//         upsampled nor converted, one after another, as libjpeg's
//         jpeg_read_raw_data gives them), 32: a restart marker that is not
//         the next RSTn is an error (libtiff's old-style JPEG codec makes
//         libjpeg's resync fail)), then per component h, v, then
//         (with block smoothing) per component the bits still unsent of
//         zigzag coefficients 0-9 after the last scan (coef_bits, -1:
//         never sent)].
// quant: ncomp x 64 uint16 tables, natural order (each component's table
//        as latched at its first scan; unused by lossless files).
// scans: per scan [offset, length, restart_interval, ns, Ss, Se, Ah, Al,
//        then 4 x (component index, dc table, ac table)]; a lossless
//        scan's Ss is its predictor and Al its point transform.
// huff:  per scan 8 x 272 bytes (DC tables 0-3 then AC tables 0-3, each 16
//        counts + 256 values; all-zero counts: not defined).
// cond:  per scan 48 bytes, the arithmetic conditioning of tables 0-15 as
//        the DAC segments before the scan left it: L, then U, then Kx.
// out:   height x width x ncomp bytes.
// Every DCT scan decodes into one coefficient buffer; then the IDCT (with
// block smoothing when asked), upsampling and colour conversion run once.
// Returns 0 or a negative error code.
long jpeg_decode(const uint8_t *data, long data_len, const int32_t *frame,
                 const uint16_t *quant, const int32_t *scans, long nscans,
                 const uint8_t *huff, const uint8_t *cond, uint8_t *out) {
  const long width = frame[0], height = frame[1];
  const int ncomp = frame[2];
  const int color = frame[3];
  const int coding = frame[4];
  const bool progressive = coding & 1, arith = coding & 2, lossless = coding & 4;
  const bool smoothing = (coding & 8) && progressive;
  const bool raw = coding & 16, strict_restarts = coding & 32;
  if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kUnsupported;
  if (raw && lossless) return kUnsupported;
  if (width <= 0 || height <= 0) return kCorrupt;
  if (lossless && (progressive || color != 0)) return kUnsupported;
  int hmax = 1, vmax = 1;
  std::vector<Component> comps(ncomp);
  for (int c = 0; c < ncomp; c++) {
    comps[c].h = frame[5 + 2 * c];
    comps[c].v = frame[6 + 2 * c];
    if (comps[c].h < 1 || comps[c].h > 4 || comps[c].v < 1 || comps[c].v > 4) return kCorrupt;
    if (comps[c].h > hmax) hmax = comps[c].h;
    if (comps[c].v > vmax) vmax = comps[c].v;
  }
  const int32_t *coef_bits = frame + 5 + 2 * ncomp;
  // A DCT file's MCU is 8x8 samples of a 1x1 component, a lossless one's
  // 1 sample.
  const int unit = lossless ? 1 : 8;
  const long mcux = (width + unit * hmax - 1) / (unit * hmax);
  const long mcuy = (height + unit * vmax - 1) / (unit * vmax);
  std::vector<LosslessPlane> planes(lossless ? ncomp : 0);
  for (int c = 0; c < ncomp; c++) {
    Component &k = comps[c];
    if (hmax % k.h || vmax % k.v) return kUnsupported;
    k.bw = (int)(mcux * k.h);
    k.bh = (int)(mcuy * k.v);
    k.dw = (int)((width * k.h + hmax - 1) / hmax);
    k.dh = (int)((height * k.v + vmax - 1) / vmax);
    k.qt = quant + 64 * c;
    if (lossless) {
      LosslessPlane &p = planes[c];
      p.h = k.h;
      p.v = k.v;
      p.dw = k.dw;
      p.dh = k.dh;
      p.pw = k.bw;
      p.ph = k.bh;
      p.diff.assign((size_t)p.pw * p.ph, 0);
      p.undiff.assign((size_t)p.pw * p.ph, 0);
      p.out.assign((size_t)p.dw * p.dh, 0);
    } else {
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }
  }

  for (long s = 0; s < nscans; s++) {
    const int32_t *sc = scans + s * 20;
    long off = sc[0], len = sc[1], ri = sc[2];
    int ns = sc[3];
    const int ss = sc[4], se = sc[5], ah = sc[6], al = sc[7];
    if (off < 0 || len < 0 || off + len > data_len || ns < 1 || ns > 4) return kCorrupt;
    // Which tables the scan reads: a sequential or lossless scan its DC
    // tables (and a sequential one its AC tables), a progressive DC first
    // scan its DC tables, a DC refinement none, an AC scan its AC table.
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !lossless && (!progressive || ss > 0);
    Huffman tables[8];
    const uint8_t *spec = huff + s * 8 * 272;
    if (!arith)
      for (int t = 0; t < 8; t++) build_huffman(spec + t * 272, tables[t]);
    int ci[4], td[4], ta[4];
    for (int j = 0; j < ns; j++) {
      ci[j] = sc[8 + 3 * j];
      td[j] = sc[9 + 3 * j];
      ta[j] = sc[10 + 3 * j];
      const int ntab = arith ? 16 : 4;
      if (ci[j] < 0 || ci[j] >= ncomp || td[j] < 0 || td[j] >= ntab || ta[j] < 0 || ta[j] >= ntab)
        return kCorrupt;
      if (!arith && ((need_dc && !tables[td[j]].defined) || (need_ac && !tables[4 + ta[j]].defined)))
        return kCorrupt;
      if (lossless)  // jdhuff.c: a lossless DC table's symbols are 0-16
        for (int i = 0; i < 256; i++)
          if (tables[td[j]].vals[i] > 16 && i < tables[td[j]].total) return kCorrupt;
    }
    // Non-interleaved: one block (or sample) per MCU over the component's
    // own grid; interleaved: h x v of each component per MCU.
    long mcols, mrows;
    if (ns == 1) {
      const Component &k = comps[ci[0]];
      mcols = (k.dw + unit - 1) / unit;
      mrows = (k.dh + unit - 1) / unit;
    } else {
      mcols = mcux;
      mrows = mcuy;
    }

    if (lossless) {
      // jddiffct.c: restarts come at MCU-row boundaries only.
      if (ri % mcols) return kCorrupt;
      const long restart_rows = ri / mcols;
      for (int c = 0; c < ncomp; c++) planes[c].first_row = true;
      BitReader br(data + off, len);
      long rows_to_go = restart_rows;
      bool insufficient = false;
      // iMCU rows: an interleaved scan's MCU row, or v rows of the one
      // component (fewer in the last).
      const long total_imcu = (height + vmax - 1) / vmax;
      long mrow = 0;
      for (long imcu = 0; imcu < total_imcu; imcu++) {
        long nrows = 1;
        if (ns == 1) {
          const long v = comps[ci[0]].v;
          nrows = v;
          if (imcu == total_imcu - 1 && comps[ci[0]].dh % v) nrows = comps[ci[0]].dh % v;
        }
        for (long yo = 0; yo < nrows; yo++, mrow++) {
          if (restart_rows) {
            if (rows_to_go == 0) {
              if (br.restart()) insufficient = false;
              for (int c = 0; c < ncomp; c++) planes[c].first_row = true;
              rows_to_go = restart_rows;
            }
          }
          if (insufficient) {  // out of data: zero differences, predictors reset
            for (int j = 0; j < ns; j++) {
              LosslessPlane &p = planes[ci[j]];
              const long rows = ns == 1 ? 1 : p.v;
              std::fill_n(&p.diff[(size_t)mrow * rows * p.pw], (size_t)rows * p.pw, 0);
            }
            for (int c = 0; c < ncomp; c++) planes[c].first_row = true;
          } else {
            for (long mx = 0; mx < mcols; mx++)
              for (int j = 0; j < ns; j++) {
                LosslessPlane &p = planes[ci[j]];
                const Huffman &dc = tables[td[j]];
                const int bv = ns == 1 ? 1 : p.v, bh = ns == 1 ? 1 : p.h;
                for (int by = 0; by < bv; by++)
                  for (int bx = 0; bx < bh; bx++) {
                    int t = br.decode(dc);
                    int d = 0;
                    if (t == 16)
                      d = 32768;
                    else if (t)
                      d = extend(br.bits(t), t);
                    p.diff[(size_t)(mrow * bv + by) * p.pw + mx * bh + bx] = d;
                  }
              }
            insufficient = br.hit_end();
          }
          if (restart_rows) rows_to_go--;
        }
        for (int j = 0; j < ns; j++) {
          LosslessPlane &p = planes[ci[j]];
          const long first = imcu * p.v;
          for (long y = first; y < std::min<long>(first + p.v, p.dh); y++)
            undifference_row(p, y, ss, al);
        }
      }
      continue;
    }

    if (arith) {
      ArithDecoder dec(data + off, len);
      dec.reset();
      ArithStats st;
      st.cond = cond + s * 48;
      int ctx[4], last[4];
      auto reset = [&]() {
        for (int j = 0; j < ns; j++) {
          if (need_dc) std::memset(st.dc[td[j]], 0, 64);
          if (need_ac) std::memset(st.ac[ta[j]], 0, 256);
          ctx[j] = last[j] = 0;
        }
      };
      reset();
      auto block = [&](int j, int16_t *blk) -> bool {
        if (!progressive) {
          if (!arith_dc(dec, st, td[j], ctx[j], last[j])) return false;
          blk[0] = (int16_t)last[j];
          return arith_ac(dec, st, ta[j], 1, 63, 0, blk);
        }
        if (ss == 0 && ah == 0) {
          if (!arith_dc(dec, st, td[j], ctx[j], last[j])) return false;
          blk[0] = (int16_t)(int)((unsigned)last[j] << al);
          return true;
        }
        if (ss == 0) {
          if (dec.decode(&st.fixed)) blk[0] = (int16_t)(blk[0] | (1 << al));
          return true;
        }
        if (ah == 0) return arith_ac(dec, st, ta[j], ss, se, al, blk);
        return arith_ac_refine(dec, st, ta[j], ss, se, al, blk);
      };
      long todo = ri;
      int next_rst = 0;
      for (long m = 0; m < mcols * mrows; m++) {
        if (ri > 0) {
          if (todo == 0) {
            dec.restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            reset();
            todo = ri;
          }
          todo--;
        }
        if (dec.broken()) continue;
        const long my = m / mcols, mx = m % mcols;
        bool ok = true;
        for (int j = 0; j < ns && ok; j++) {
          Component &k = comps[ci[j]];
          if (ns == 1) {
            ok = block(j, &k.coef[((size_t)my * k.bw + mx) * 64]);
          } else {
            for (int by = 0; by < k.v && ok; by++)
              for (int bx = 0; bx < k.h && ok; bx++) {
                size_t row = (size_t)my * k.v + by, col = (size_t)mx * k.h + bx;
                ok = block(j, &k.coef[(row * k.bw + col) * 64]);
              }
          }
        }
        if (!ok) dec.set_broken();
      }
      continue;
    }

    BitReader br(data + off, len);
    int pred[4] = {0, 0, 0, 0};
    long eobrun = 0;
    auto block = [&](int j, int16_t *blk) {
      const Huffman &dc = tables[td[j]];
      const Huffman &ac = tables[4 + ta[j]];
      if (!progressive) {
        decode_block(br, dc, ac, pred[j], blk);
      } else if (ss == 0) {
        if (ah == 0) {
          dc_first(br, dc, al, pred[j], blk);
        } else if (br.bits(1)) {
          blk[0] = (int16_t)(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(br, ac, ss, se, al, eobrun, blk);
      } else {
        ac_refine(br, ac, ss, se, al, eobrun, blk);
      }
    };
    const long total = mcols * mrows;
    long todo = ri;  // MCUs left in this restart interval
    bool skip = false;
    int next_rst = 0;
    for (long m = 0; m < total; m++) {
      if (ri > 0) {
        if (todo == 0) {
          if (strict_restarts) {
            if (!br.restart_strict(next_rst)) return kCorrupt;
            next_rst = (next_rst + 1) & 7;
            skip = false;
          } else if (br.restart()) {
            // libjpeg keeps its out-of-data flag when no restart marker
            // follows (jdhuff.c process_restart).
            skip = false;
          }
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun = 0;
          todo = ri;
        }
        todo--;
      }
      if (skip) continue;  // out of data: the MCU's blocks stay as they are
      long my = m / mcols, mx = m % mcols;
      for (int j = 0; j < ns; j++) {
        Component &k = comps[ci[j]];
        if (ns == 1) {
          block(j, &k.coef[((size_t)my * k.bw + mx) * 64]);
        } else {
          for (int by = 0; by < k.v; by++)
            for (int bx = 0; bx < k.h; bx++) {
              size_t row = (size_t)my * k.v + by, col = (size_t)mx * k.h + bx;
              block(j, &k.coef[(row * k.bw + col) * 64]);
            }
        }
      }
      if (br.hit_end()) skip = true;
    }
  }

  // Each component's plane at its own resolution (the IDCT of every
  // block, or the lossless samples), then upsampled to full resolution
  // and converted. A lossless file has no fancy upsampling (libjpeg-turbo
  // does it only for DCT sizes above 1).
  const long full_w = lossless ? width : mcux * hmax * 8;
  const long full_h = lossless ? height : mcuy * vmax * 8;
  std::vector<std::vector<uint8_t>> up(ncomp);
  size_t raw_at = 0;
  for (int c = 0; c < ncomp; c++) {
    Component &k = comps[c];
    std::vector<uint8_t> plane;
    long stride;
    if (lossless) {
      plane.swap(planes[c].out);
      stride = k.dw;
    } else {
      stride = (long)k.bw * 8;
      plane.resize((size_t)stride * k.bh * 8);
      if (smoothing) {
        idct_smoothed(k, k.v, mcuy, coef_bits + 10 * c, plane.data());
      } else {
        for (long by = 0; by < k.bh; by++)
          for (long bx = 0; bx < k.bw; bx++)
            idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.qt,
                       plane.data() + by * 8 * stride + bx * 8, stride);
      }
      std::vector<int16_t>().swap(k.coef);
    }
    if (raw) {  // the plane as jpeg_read_raw_data hands it over
      std::memcpy(out + raw_at, plane.data(), plane.size());
      raw_at += plane.size();
      continue;
    }
    up[c].resize((size_t)full_w * full_h);
    const long ow = std::min<long>(full_w, (long)k.dw * (hmax / k.h));
    const long oh = std::min<long>(full_h, (long)k.dh * (vmax / k.v));
    std::vector<uint8_t> tmp((size_t)ow * oh);
    upsample(k, hmax, vmax, plane.data(), stride, !lossless, tmp.data(), ow, oh);
    for (long y = 0; y < height; y++) std::memcpy(&up[c][y * full_w], &tmp[y * ow], width);
  }
  if (raw) return 0;
  if (ncomp == 1) {
    for (long y = 0; y < height; y++) std::memcpy(out + y * width, &up[0][y * full_w], width);
    return 0;
  }
  if (color == 0) {
    for (long y = 0; y < height; y++)
      for (long x = 0; x < width; x++)
        for (int c = 0; c < ncomp; c++) out[(y * width + x) * ncomp + c] = up[c][y * full_w + x];
    return 0;
  }
  if ((color == 1 && ncomp != 3) || (color == 2 && ncomp != 4) || color > 2) return kCorrupt;
  // jdcolor.c ycc_rgb_convert, SCALEBITS 16; ycck_cmyk_convert inverts
  // the three converted samples and passes K through.
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  constexpr long kHalf = 1L << 15;
  for (int i = 0; i < 256; i++) {
    long x = i - 128;
    cr_r[i] = (int)((91881L * x + kHalf) >> 16);
    cb_b[i] = (int)((116130L * x + kHalf) >> 16);
    cr_g[i] = -46802L * x;
    cb_g[i] = -22554L * x + kHalf;
  }
  auto clamp = [](long v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  const bool inv = color == 2;
  auto put = [&](long v) { return clamp(inv ? 255 - v : v); };
  for (long y = 0; y < height; y++) {
    const uint8_t *py = &up[0][y * full_w], *pb = &up[1][y * full_w], *pr = &up[2][y * full_w];
    uint8_t *o = out + y * width * ncomp;
    for (long x = 0; x < width; x++, o += ncomp) {
      int yy = py[x], cb = pb[x], cr = pr[x];
      o[0] = put(yy + cr_r[cr]);
      o[1] = put(yy + ((cb_g[cb] + cr_g[cr]) >> 16));
      o[2] = put(yy + cb_b[cb]);
      if (ncomp == 4) o[3] = up[3][y * full_w + x];
    }
  }
  return 0;
}

// BMP RLE8 / RLE4 (compression 1 / 2) into one palette index a pixel,
// width x height, the file's first row first, as Pillow's BmpRleDecoder
// builds its buffer: encoded runs cut at the row's end, end of line pads
// the row with index 0, end of bitmap stops, an absolute run's bytes
// padded to a 16-bit word of the file (`start`: the pixel data's offset
// in the file). Where Pillow misreads the format (a delta escape, whose
// two bytes it reads twice over; an RLE4 absolute run of odd length, of
// which it reads one byte short), the escape is read as the BMP
// specification has it: delta moves right and up over pixels left as
// index 0, and an odd RLE4 run takes (n + 1) / 2 bytes. Returns the
// pixels written (width * height unless the data ends first).
long bmp_rle(const uint8_t *src, long n, long start, long width, long height, long rle4,
             uint8_t *out) {
  const long dest = width * height;
  long len = 0, x = 0, i = 0;
  auto put = [&](uint8_t v) {
    if (len < dest) out[len] = v;
    len++;
  };
  while (len < dest && i + 2 <= n) {
    const int count = src[i], byte = src[i + 1];
    i += 2;
    if (count) {  // encoded run, cut at the row's end
      const long k = std::min<long>(count, std::max(0L, width - x));
      for (long j = 0; j < k; j++) put((uint8_t)(rle4 ? (j % 2 ? byte & 15 : byte >> 4) : byte));
      x += k;
    } else if (byte == 0) {  // end of line
      while (len % width) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: right, up
      if (i + 2 > n) break;
      const long skip = src[i] + (long)src[i + 1] * width;
      i += 2;
      for (long j = 0; j < skip && len < dest; j++) put(0);
      if (len >= dest) break;
      x = len % width;
    } else {  // absolute run of `byte` pixels
      const long need = rle4 ? (byte + 1) / 2 : byte;
      const long got = std::min(need, n - i);
      const long pixels = rle4 ? std::min<long>(byte, 2 * got) : got;
      for (long j = 0; j < pixels; j++)
        put(rle4 ? (uint8_t)(j % 2 ? src[i + j / 2] & 15 : src[i + j / 2] >> 4) : src[i + j]);
      i += got;
      if (got < need) break;
      x += byte;
      if ((start + i) % 2) i++;
    }
  }
  return std::min(len, dest);
}

// CCITT-coded TIFF strip or tile of `rows` rows of `width` pixels. mode:
// 2 modified Huffman (compression 2: no EOLs, each row from a byte
// boundary), 3 T.4 one-dimensional and 5 T.4 two-dimensional
// (compression 3, T4Options bit 0; every row after an EOL, fill bits
// skipped), 4 T.6 (compression 4). The data is read MSB first (the
// caller reverses fill order 2). Writes rows x ((width + 7) / 8) bytes, 1
// bits for black runs. Returns `rows`, or a negative error code.
long tiff_ccitt(const uint8_t *src, long n, long width, long rows, long mode, uint8_t *out) {
  if (width <= 0 || rows < 0 || (mode != 2 && mode != 3 && mode != 4 && mode != 5))
    return kCorrupt;
  const long row_bytes = (width + 7) / 8;
  FaxBits br(src, n);
  std::vector<long> ref{width, 0};
  bool eol_seen = false;
  for (long y = 0; y < rows; y++) {
    FaxRow row;
    bool one_d = mode == 2 || mode == 3;
    if (mode == 3 || mode == 5) {
      if (!fax_sync_eol(br, eol_seen)) return kTruncated;
      if (mode == 5) {
        one_d = br.peek(1);
        br.skip(1);
      }
    } else if (br.exhausted()) {
      return kTruncated;
    }
    const int r = one_d ? fax_expand1d(br, row, width) : fax_expand2d(br, row, ref, width);
    if (r < 0) return r == -3 ? kUnsupported : kCorrupt;
    eol_seen = r == 0;
    if (eol_seen && mode == 4) return kTruncated;  // EOFB before the last row
    fax_fill(row, width, out + y * row_bytes);
    if (mode == 4 || mode == 5) {
      row.set(0);  // the imaginary change at the end of the reference row
      ref.swap(row.runs);
    }
    if (mode == 2) br.align();
  }
  return rows;
}

// TGA RLE (image types 9, 10, 11), as Pillow's TgaRleDecode.c reads it:
// a packet header, then one pixel repeated (bit 7 set) or `count` literal
// pixels; a run must end within its row (else Pillow reports an overrun),
// a literal flows on into the next rows. depth: bytes a pixel (Pillow's
// depth / 8: at 0, a 1-bit image, every packet is consumed without
// filling a row, so the data runs out). Writes `height` rows of
// `row_bytes` in the file's order (the caller flips them). Returns 0, or
// kCorrupt (a run past its row) or kTruncated (the data ends first).
long tga_rle(const uint8_t *src, long n, long depth, long row_bytes, long height,
             uint8_t *out) {
  if (depth <= 0 || row_bytes <= 0) return kTruncated;
  long x = 0, rows = 0, i = 0;
  uint8_t *row = out;
  while (rows < height) {
    if (i >= n) return kTruncated;
    long bytes = depth * ((src[i] & 0x7f) + 1);
    if (src[i] & 0x80) {
      if (n - i < 1 + depth) return kTruncated;
      if (x + bytes > row_bytes) return kCorrupt;
      for (long k = 0; k < bytes; k += depth) std::memcpy(row + x + k, src + i + 1, depth);
      i += 1 + depth;
      x += bytes;
      if (x >= row_bytes) {
        x = 0;
        row += row_bytes;
        rows++;
      }
    } else {
      if (n - i < 1 + bytes) return kTruncated;
      const uint8_t *p = src + i + 1;
      i += 1 + bytes;
      while (bytes > 0 && rows < height) {
        const long k = std::min(bytes, row_bytes - x);
        std::memcpy(row + x, p, k);
        x += k;
        p += k;
        bytes -= k;
        if (x >= row_bytes) {
          x = 0;
          row += row_bytes;
          rows++;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// One SGI RLE row of 8-bit (bpc 1) or 16-bit (bpc 2) samples into every
// z-th sample of `dest`, as SgiRleDecode.c's expandrow / expandrow2: n is
// the row's length from the table, taken as a count of packets; `end` is
// the last byte of the data. Returns 0, 1 (a last packet that is not the
// zero terminator: Pillow stops decoding, without an error) or -1 (an
// overrun).
int sgi_row(uint8_t *dest, const uint8_t *src, const uint8_t *end, long n, long z, long xsize,
            long bpc) {
  long x = 0;
  const long step = z * bpc;
  for (; n > 0; n--) {
    uint8_t pixel;
    if (bpc == 1) {
      if (src > end) return -1;
      pixel = *src++;
    } else {
      if (src + 1 > end) return -1;
      pixel = src[1];
      src += 2;
    }
    if (n == 1 && pixel != 0) return 1;
    long count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        src += bpc;
        dest += step;
      }
    } else {
      if (bpc == 1 ? src > end : src + 2 > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        dest += step;
      }
      src += bpc;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// SGI RLE (storage 1), as SgiRleDecode.c reads it: `data` is the file
// after its 512-byte header (its length `n`); the start and length tables
// (zsize * ysize big-endian words each, channel-major) lead it. Each row
// decodes its channels into one interleaved row buffer that carries over
// from row to row (a short row keeps the previous row's tail, as in
// Pillow); rows are written bottom-up into `out` (ysize rows of
// xsize * zsize * bpc bytes, big-endian samples at bpc 2). Returns 0, or
// kCorrupt where Pillow reports an overrun.
long sgi_rle(const uint8_t *data, long n, long xsize, long ysize, long zsize, long bpc,
             uint8_t *out) {
  const long tablen = zsize * ysize;
  if (n < 8 * tablen || n <= 0) return kCorrupt;
  const long row_bytes = xsize * zsize * bpc;
  std::vector<uint8_t> buffer(row_bytes, 0);
  auto word = [&](long at) {
    return (uint32_t)data[at] << 24 | (uint32_t)data[at + 1] << 16 | (uint32_t)data[at + 2] << 8 |
           data[at + 3];
  };
  const uint8_t *end = data + n - 1;
  for (long rowno = 0; rowno < ysize; rowno++) {
    for (long ch = 0; ch < zsize; ch++) {
      const long at = rowno + ch * ysize;
      long offset = word(4 * at);
      const long length = word(4 * (tablen + at));
      if (offset < 512) return kCorrupt;
      offset -= 512;
      // A row past the data fails sgi_row's first read, as in Pillow.
      const uint8_t *src = offset < n ? data + offset : end + 1;
      const int status =
          sgi_row(buffer.data() + ch * bpc, src, end, (int)length, zsize, xsize, bpc);
      if (status == -1) return kCorrupt;
      if (status == 1) return 0;
    }
    std::memcpy(out + (ysize - 1 - rowno) * row_bytes, buffer.data(), row_bytes);
  }
  return 0;
}

// PCX's run-length code, as PcxDecode.c reads it (whatever the header's
// encoding byte): a byte with its two top bits set repeats the next byte
// (its low six bits times), any other byte is itself. Fills `height`
// lines of `line_bytes` (the planes of a row one after another). Returns
// 0, kCorrupt for a run past its line (Pillow's overrun) or kTruncated.
long pcx_rle(const uint8_t *src, long n, long line_bytes, long height, uint8_t *out) {
  if (line_bytes <= 0) return kCorrupt;
  const long total = line_bytes * height;
  long len = 0, x = 0, i = 0;
  while (len < total) {
    if (i >= n) return kTruncated;
    if ((src[i] & 0xC0) == 0xC0) {
      if (i + 2 > n) return kTruncated;
      const long count = src[i] & 0x3F;
      if (x + count > line_bytes) return kCorrupt;
      std::memset(out + len, src[i + 1], count);
      len += count;
      x += count;
      i += 2;
    } else {
      out[len++] = src[i++];
      x++;
    }
    if (x >= line_bytes) x = 0;
  }
  return 0;
}

// PackBits as Pillow's PackDecode.c reads it (PSD channels): 0x80 is
// skipped, a byte n above it repeats the next byte 257 - n times, any
// other byte n is a literal of the next n + 1 bytes; the part of a run or
// literal past the end of its row of `row_bytes` is dropped (its bytes
// are still consumed). Fills `rows` rows. Returns the bytes consumed, or
// kTruncated when the data ends first.
long packbits_rows(const uint8_t *src, long n, long row_bytes, long rows, uint8_t *out) {
  if (row_bytes <= 0) return kCorrupt;
  long i = 0, x = 0, y = 0;
  while (y < rows) {
    if (i >= n) return kTruncated;
    const int c = src[i];
    uint8_t *row = out + y * row_bytes;
    if (c == 0x80) {
      i++;
      continue;
    }
    if (c & 0x80) {
      if (i + 2 > n) return kTruncated;
      long len = 257 - c;
      if (len > row_bytes - x) len = row_bytes - x;
      std::memset(row + x, src[i + 1], len);
      x += len;
      i += 2;
    } else {
      const long len = c + 1;
      if (i + 1 + len > n) return kTruncated;
      const long keep = len < row_bytes - x ? len : row_bytes - x;
      std::memcpy(row + x, src + i + 1, keep);
      x += keep;
      i += 1 + len;
    }
    if (x >= row_bytes) {
      x = 0;
      y++;
    }
  }
  return i;
}

// Sun raster's byte encoding (file type 2), as SunRleDecode.c reads it:
// 0x80 0x00 is one 0x80 byte, 0x80 n v is n + 1 copies of v, any other
// byte is itself; runs carry on across rows. Fills `total` bytes. Returns
// 0, or kTruncated when the data ends first.
long sun_rle(const uint8_t *src, long n, long total, uint8_t *out) {
  long len = 0, i = 0;
  while (len < total) {
    if (i >= n) return kTruncated;
    if (src[i] != 0x80) {
      out[len++] = src[i++];
    } else if (i + 2 > n) {
      return kTruncated;
    } else if (src[i + 1] == 0) {
      out[len++] = 0x80;
      i += 2;
    } else {
      if (i + 3 > n) return kTruncated;
      const long count = std::min<long>(src[i + 1] + 1L, total - len);
      std::memset(out + len, src[i + 2], count);
      len += count;
      i += 3;
    }
  }
  return 0;
}

// Windows Paint version 2 (MspImagePlugin's MspDecoder): `src` is the file
// after its 32-byte header, a row map of `height` little-endian byte
// counts and then the rows. A row of length 0 is `row_bytes` bytes of
// 0xFF; otherwise a 0 byte is a run (count, value), any other byte n a
// literal of the next n bytes (cut at the row's end). Every row is read,
// and the rows' bytes, one stream, fill the first `row_bytes * height`
// bytes of `out`. Returns 0, kTruncated for a row map or row past the data
// or a stream short of the image, kCorrupt for a run cut by its row's end.
long msp_rle(const uint8_t *src, long n, long row_bytes, long height, uint8_t *out) {
  const long total = row_bytes * height;
  if (n < 2 * height) return kTruncated;
  long at = 2 * height, len = 0;
  auto emit = [&](const uint8_t *p, long k, int value) {
    k = std::min(k, total - len);
    if (k <= 0) return;
    if (p) std::memcpy(out + len, p, k);
    else std::memset(out + len, value, k);
    len += k;
  };
  for (long y = 0; y < height; y++) {
    const long rowlen = src[2 * y] | (long)src[2 * y + 1] << 8;
    if (rowlen == 0) {
      emit(nullptr, row_bytes, 0xFF);
      continue;
    }
    if (at + rowlen > n) return kTruncated;
    const uint8_t *row = src + at;
    at += rowlen;
    long idx = 0;
    while (idx < rowlen) {
      const long type = row[idx++];
      if (type == 0) {
        if (idx + 2 > rowlen) return kCorrupt;
        emit(nullptr, row[idx], row[idx + 1]);
        idx += 2;
      } else {
        emit(row + idx, std::min(type, rowlen - idx), 0);
        idx += type;
      }
    }
  }
  return len < total ? kTruncated : 0;
}

// The "bit" decoder ImImagePlugin opens the IM "L*n" float types with
// (BitDecode.c, bits `bits` < 32, pad 8, fill 3, unsigned, rows
// bottom-up): bytes enter the bit buffer above the bits it holds, samples
// leave from its low end, and a new row drops the count of buffered bits
// (not the bits, which the next byte is ORed into), as in Pillow. Writes
// width * height floats. Returns 0, or kTruncated when the data ends
// first.
long im_bits(const uint8_t *src, long n, long bits, long width, long height, float *out) {
  if (bits < 1 || bits >= 32 || width <= 0 || height <= 0) return kUnsupported;
  const unsigned long long mask = (1ULL << bits) - 1;
  unsigned long long buffer = 0;
  long count = 0, x = 0, y = height - 1;
  for (long i = 0; i < n; i++) {
    const uint8_t byte = src[i];
    buffer |= (unsigned long long)byte << count;
    count += 8;
    while (count >= bits) {
      const unsigned long long data = buffer & mask;
      if (count > 32) {
        buffer = byte >> (8 - (count - bits));
      } else {
        buffer >>= bits;
      }
      count -= bits;
      out[y * width + x] = (float)data;
      if (++x >= width) {
        if (--y < 0) return 0;
        x = 0;
        count = 0;
      }
    }
  }
  return kTruncated;
}

// QOI, as Pillow's QoiDecoder reads it: the ops INDEX, DIFF, LUMA, RUN,
// RGB and RGBA from the byte after the 14-byte header, the previous
// pixel starting at (0, 0, 0, 255) and an index slot not yet written
// reading as (0, 0, 0, 0); a run does not write the index; the end marker
// is not read. Writes width * height pixels of `channels` (3 or 4) bytes.
// Returns 0, or kTruncated when the ops end before the last pixel.
long qoi_decode(const uint8_t *src, long n, long width, long height, long channels,
                uint8_t *out) {
  uint8_t prev[4] = {0, 0, 0, 255};
  uint8_t index[64][4] = {};
  const long total = width * height;
  long px = 0, i = 0;
  while (px < total) {
    if (i >= n) return kTruncated;
    const uint8_t b = src[i++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - i < 3) return kTruncated;
      v[0] = src[i], v[1] = src[i + 1], v[2] = src[i + 2], v[3] = prev[3];
      i += 3;
    } else if (b == 0xFF) {
      if (n - i < 4) return kTruncated;
      std::memcpy(v, src + i, 4);
      i += 4;
    } else if (b >> 6 == 0) {
      std::memcpy(v, index[b & 63], 4);
    } else if (b >> 6 == 1) {
      v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if (b >> 6 == 2) {
      if (i >= n) return kTruncated;
      const uint8_t b2 = src[i++];
      const int dg = (b & 63) - 32;
      v[0] = (uint8_t)(prev[0] + dg + (b2 >> 4) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (b2 & 15) - 8);
      v[3] = prev[3];
    } else {
      for (long run = (b & 63) + 1; run > 0 && px < total; run--, px++)
        std::memcpy(out + px * channels, prev, channels);
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    std::memcpy(out + px * channels, v, channels);
    px++;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Zstandard frames (RFC 8878), as libzstd 1.5 decodes them: skippable
// frames; single-segment and windowed frames, with or without a content
// size; raw, RLE and compressed blocks; raw, RLE and Huffman literals
// (one or four streams, the tree given directly or by FSE-coded weights,
// or reused: "treeless"); sequences with predefined, RLE, FSE-coded or
// repeated tables; the three repeat offsets; the content checksum (the
// low 32 bits of XXH64). A dictionary, reserved bits and block type 3 are
// refused. Every read is bounded by the input and every write by the
// frame's output limit.

namespace {

uint32_t le32(const uint8_t *p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }

uint64_t le64(const uint8_t *p) { return le32(p) | (uint64_t)le32(p + 4) << 32; }

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// XXH64 with seed 0.
constexpr uint64_t kX1 = 11400714785074694791ULL, kX2 = 14029467366897019727ULL,
                   kX3 = 1609587929392839161ULL, kX4 = 9650029242287828579ULL,
                   kX5 = 2870177450012600261ULL;

uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl64(acc + in * kX2, 31) * kX1; }

uint64_t xxh64(const uint8_t *p, size_t len) {
  const uint8_t *end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v[4] = {kX1 + kX2, kX2, 0, 0 - kX1};
    for (; p + 32 <= end; p += 32)
      for (int k = 0; k < 4; k++) v[k] = xxh_round(v[k], le64(p + 8 * k));
    h = rotl64(v[0], 1) + rotl64(v[1], 7) + rotl64(v[2], 12) + rotl64(v[3], 18);
    for (int k = 0; k < 4; k++) h = (h ^ xxh_round(0, v[k])) * kX1 + kX4;
  } else {
    h = kX5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl64(h ^ xxh_round(0, le64(p)), 27) * kX1 + kX4;
  if (p + 4 <= end) {
    h = rotl64(h ^ (uint64_t)le32(p) * kX1, 23) * kX2 + kX3;
    p += 4;
  }
  for (; p < end; p++) h = rotl64(h ^ *p * kX5, 11) * kX1;
  h ^= h >> 33;
  h *= kX2;
  h ^= h >> 29;
  h *= kX3;
  return h ^ (h >> 32);
}

// A bitstream read backwards from its last byte's highest set bit (FSE and
// Huffman streams); bits below the start read as 0, and `pos` (the bits
// left) goes negative, as libzstd's container overflows.
struct BackBits {
  const uint8_t *src = nullptr;
  long n = 0, pos = 0;

  bool init(const uint8_t *s, long len) {
    if (len < 1 || s[len - 1] == 0) return false;
    src = s, n = len, pos = (len - 1) * 8 + highbit(s[len - 1]);
    return true;
  }
  uint32_t at(long lo, int nb) const {  // nb <= 32
    if (nb == 0) return 0;
    uint64_t w = 0;
    long byte = lo >> 3;
    int shift = (int)(lo & 7);
    if (lo < 0) {
      if (-lo >= nb) return 0;
      byte = 0, shift = 0;
    }
    for (int i = 0; i < 8 && byte + i < n; i++) w |= (uint64_t)src[byte + i] << (8 * i);
    w = lo < 0 ? w << -lo : w >> shift;
    return (uint32_t)(w & ((1ULL << nb) - 1));
  }
  uint32_t read(int nb) {
    pos -= nb;
    return at(pos, nb);
  }
};

struct FseCell {
  uint16_t symbol = 0, next = 0;
  uint8_t bits = 0;
};

struct Fse {
  int log = 0;
  std::vector<FseCell> t;
};

// The decoding table of a normalized distribution (RFC 8878 4.1.1): -1
// ("less than one") cells at the top, the rest spread with libzstd's step.
bool fse_build(Fse &f, const int16_t *norm, int max_symbol, int log) {
  const int size = 1 << log, mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  f.log = log;
  f.t.assign(size, FseCell());
  std::vector<uint32_t> next(max_symbol + 1);
  int high = size - 1;
  for (int s = 0; s <= max_symbol; s++) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      f.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  int pos = 0;
  for (int s = 0; s <= max_symbol; s++)
    for (int i = 0; i < norm[s]; i++) {
      if (high < 0) return false;
      f.t[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) return false;
  for (int u = 0; u < size; u++) {
    const uint32_t state = next[f.t[u].symbol]++;
    const int bits = log - highbit(state);
    f.t[u].bits = (uint8_t)bits;
    f.t[u].next = (uint16_t)((state << bits) - size);
  }
  return true;
}

// The RLE "table": one symbol, no bits.
void fse_rle(Fse &f, int symbol) {
  f.log = 0;
  f.t.assign(1, FseCell());
  f.t[0].symbol = (uint16_t)symbol;
}

// libzstd's FSE_readNCount: an FSE table description read forwards (bits
// past the input read as 0). max_symbol: in, the largest allowed; out, the
// last one described. Returns the bytes it takes, or -1.
long fse_read_ncount(const uint8_t *src, long n, int16_t *norm, int &max_symbol, int &log) {
  auto get = [&](long bit, int nb) -> uint32_t {
    uint64_t w = 0;
    for (int i = 0; i < 5 && (bit >> 3) + i < n; i++) w |= (uint64_t)src[(bit >> 3) + i] << (8 * i);
    return (uint32_t)((w >> (bit & 7)) & ((1ULL << nb) - 1));
  };
  if (n < 1) return -1;
  const int limit = max_symbol + 1;
  log = (int)get(0, 4) + 5;
  if (log > 15) return -1;
  long bit = 4;
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, symbol = 0;
  bool previous0 = false;
  std::fill(norm, norm + limit, 0);
  for (;;) {
    if (previous0) {
      uint32_t r;
      while ((r = get(bit, 2)) == 3) symbol += 3, bit += 2;
      symbol += (int)r;
      bit += 2;
      if (symbol >= limit) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    const uint32_t v = get(bit, nb);
    int count;
    if ((int)(v & (threshold - 1)) < max) {
      count = (int)(v & (threshold - 1));
      bit += nb - 1;
    } else {
      count = (int)(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bit += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = (int16_t)count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = highbit(remaining) + 1;
      threshold = 1 << (nb - 1);
    }
    if (symbol >= limit) break;
  }
  if (remaining != 1 || symbol > limit) return -1;
  const long bytes = (bit + 7) >> 3;
  if (bytes > n) return -1;
  max_symbol = symbol - 1;
  return bytes;
}

struct ZHuffman {
  int bits = 0;
  std::vector<uint8_t> symbol, length;
};

// A Huffman tree description (RFC 8878 4.2.1): 4-bit weights, or weights
// FSE-coded by two interleaved states; the last weight completes the
// tree. Returns the bytes it takes, or -1.
long huf_read(const uint8_t *src, long n, ZHuffman &h) {
  if (n < 1) return -1;
  uint8_t w[256] = {};
  int nw = 0;
  long used;
  const int head = src[0];
  if (head >= 128) {
    nw = head - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) return -1;
    for (int i = 0; i < nw; i++) w[i] = (i & 1) ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
  } else {
    used = 1 + head;
    if (used > n) return -1;
    int16_t norm[256];
    int max_symbol = 255, log = 0;
    const long hs = fse_read_ncount(src + 1, head, norm, max_symbol, log);
    Fse f;
    if (hs < 0 || log > 6 || !fse_build(f, norm, max_symbol, log)) return -1;
    BackBits br;
    if (!br.init(src + 1 + hs, head - hs)) return -1;
    uint32_t s1 = br.read(log), s2 = br.read(log);
    for (;;) {
      if (nw > 253) return -1;
      w[nw++] = (uint8_t)f.t[s1].symbol;
      s1 = f.t[s1].next + br.read(f.t[s1].bits);
      if (br.pos < 0) {
        w[nw++] = (uint8_t)f.t[s2].symbol;
        break;
      }
      if (nw > 253) return -1;
      w[nw++] = (uint8_t)f.t[s2].symbol;
      s2 = f.t[s2].next + br.read(f.t[s2].bits);
      if (br.pos < 0) {
        w[nw++] = (uint8_t)f.t[s1].symbol;
        break;
      }
    }
  }
  int rank[14] = {};
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 12) return -1;
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) return -1;
  const int bits = highbit(total) + 1;
  if (bits > 12) return -1;
  const uint32_t rest = (1u << bits) - total;
  if ((1u << highbit(rest)) != rest) return -1;
  w[nw] = (uint8_t)(highbit(rest) + 1);
  rank[w[nw]]++;
  if (rank[1] < 2 || (rank[1] & 1)) return -1;
  h.bits = bits;
  h.symbol.assign(1u << bits, 0);
  h.length.assign(1u << bits, 0);
  uint32_t start[14] = {}, next = 0;
  for (int k = 1; k <= bits; k++) {
    start[k] = next;
    next += (uint32_t)rank[k] << (k - 1);
  }
  for (int s = 0; s <= nw; s++) {
    if (!w[s]) continue;
    const uint32_t len = 1u << (w[s] - 1);
    for (uint32_t k = 0; k < len; k++) {
      h.symbol[start[w[s]] + k] = (uint8_t)s;
      h.length[start[w[s]] + k] = (uint8_t)(bits + 1 - w[s]);
    }
    start[w[s]] += len;
  }
  return used;
}

// One Huffman stream of `count` symbols, which must use up its bits. x2:
// 0 for libzstd's single-symbol decoder, else the table log of its
// double-symbol decoder, which reads two symbols a step where the second
// code fits in that many bits after the first, and at a stream's last
// symbol, where its table gives two, takes the bits of both and clamps at
// the stream's start (a stream short by up to the second code's bits
// passes, as does one already at its start: the container's top bits
// then pick the symbol).
bool huf_stream(const ZHuffman &h, const uint8_t *src, long n, uint8_t *out, long count, int x2) {
  BackBits br;
  if (!br.init(src, n)) return false;
  auto decode = [&](long at, int &len) {
    const uint32_t v = br.at(at - h.bits, h.bits);
    len = h.length[v];
    return h.symbol[v];
  };
  int l1, l2;
  if (!x2) {
    for (long i = 0; i < count; i++) {
      out[i] = decode(br.pos, l1);
      br.pos -= l1;
    }
    return br.pos == 0;
  }
  long p = 0;
  while (p + 2 <= count) {
    out[p] = decode(br.pos, l1);
    const uint8_t second = decode(br.pos - l1, l2);
    if (l2 <= x2 - l1) {
      out[p + 1] = second;
      br.pos -= l1 + l2;
      p += 2;
    } else {
      br.pos -= l1;
      p += 1;
    }
  }
  if (p < count) {
    if (br.pos == 0) {
      uint64_t w = 0;
      for (int i = 0; i < 8 && i < n; i++) w |= (uint64_t)src[i] << (8 * i);
      const uint32_t v = (uint32_t)(w >> (64 - x2));
      const uint32_t first = v >> (x2 - h.bits);
      const uint32_t next = ((v << h.length[first]) & ((1u << x2) - 1)) >> (x2 - h.bits);
      out[p] = h.symbol[first];
      return h.length[next] <= x2 - h.length[first];
    }
    out[p] = decode(br.pos, l1);
    decode(br.pos - l1, l2);
    if (br.pos > 0 && l2 <= x2 - l1)
      br.pos = std::max(br.pos - l1 - l2, 0L);
    else
      br.pos -= l1;
  }
  return br.pos == 0;
}

// Four Huffman streams after their jump table, as libzstd 1.5's
// HUF_decompress4X decoders run them. Where every stream holds 8 bytes or
// more, the table log is 11 or less and the fourth stream has a symbol,
// its fast loop decodes all four in lock step, then each stream's tail:
// every stream reads on past its own start into the bytes before it (the
// earlier streams, the jump table; below the table's first byte its first
// 8 bytes again, as libzstd's container wraps), and no stream is held to
// its bits -- the only check is that, when the fast loop stops, no stream
// has read a whole byte past its start. Otherwise each stream is decoded
// alone (huf_stream) and must end exactly.
bool huf_streams4(const ZHuffman &h, const uint8_t *src, long n, uint8_t *out, long size, int x2) {
  if (n < 10) return false;
  const long l1 = src[0] | src[1] << 8, l2 = src[2] | src[3] << 8, l3 = src[4] | src[5] << 8;
  const long l4 = n - 6 - l1 - l2 - l3, seg = (size + 3) / 4;
  if (l4 < 0) return false;
  const long start[4] = {6, 6 + l1, 6 + l1 + l2, 6 + l1 + l2 + l3};
  const long end[4] = {start[1], start[2], start[3], n};
  const long count[4] = {seg, seg, seg, size - 3 * seg};
  if (h.bits > 11 || l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8 || 3 * seg >= size) {
    for (int s = 0; s < 4; s++)
      if (!huf_stream(h, src + start[s], end[s] - start[s], out + s * seg, count[s], x2)) return false;
    return true;
  }
  BackBits all;
  all.src = src, all.n = n;
  auto symbol = [&](long q, int &len) {
    if (q <= 0) q = 64 - (-q) % 64;  // the container at the first byte, wrapped
    const uint32_t v = all.at(q - h.bits, h.bits);
    len = h.length[v];
    return h.symbol[v];
  };
  long q[4], ip[4], op[4] = {0, 0, 0, 0};
  for (int s = 0; s < 4; s++) {
    const uint8_t last = src[end[s] - 1];
    q[s] = end[s] * 8 - (last ? 8 - highbit(last) : 0);
    ip[s] = end[s] - 8;
  }
  // One table lookup: one symbol, or two with the double-symbol decoder
  // where the second code fits.
  auto lookup = [&](int s, bool pair) {
    int len1, len2;
    out[s * seg + op[s]] = symbol(q[s], len1);
    if (pair) {
      const uint8_t second = symbol(q[s] - len1, len2);
      if (len2 <= x2 - len1) {
        out[s * seg + op[s] + 1] = second;
        q[s] -= len1 + len2;
        op[s] += 2;
        return;
      }
    }
    q[s] -= len1;
    op[s] += 1;
  };
  for (;;) {
    long iters = ip[0] / 7;
    for (int s = 0; s < 4; s++)
      iters = std::min(iters, x2 ? (count[s] - op[s]) / 10 : (count[3] - op[3]) / 5);
    if (iters <= 0 || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    const long limit = op[3] + 5 * iters;
    do {
      for (int s = 0; s < 4; s++) {
        for (int k = 0; k < 5; k++) lookup(s, x2 != 0);
        ip[s] = end[s] - 8 - (end[s] * 8 - q[s]) / 8;
      }
    } while (op[3] < limit);
  }
  for (int s = 0; s < 4; s++) {
    if (op[s] > count[s] || ip[s] < start[s] - 8) return false;
    while (op[s] + (x2 ? 2 : 1) <= count[s]) lookup(s, x2 != 0);
    if (op[s] < count[s]) lookup(s, false);
  }
  return true;
}

// libzstd's HUF_selectDecoder: whether its timing model picks the
// double-symbol decoder for `size` literals coded in `csize` bytes.
bool huf_pick_x2(long size, long csize) {
  static const uint16_t time[16][4] = {
      {0, 0, 1, 1},         {0, 0, 1, 1},         {150, 216, 381, 119}, {170, 205, 514, 112},
      {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107}, {256, 189, 881, 106},
      {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122}, {825, 186, 1965, 136},
      {976, 185, 2131, 150}, {1180, 186, 2070, 175}, {1377, 185, 1731, 202}, {1412, 185, 1695, 202}};
  const long q = csize >= size ? 15 : csize * 16 / size, d256 = size >> 8;
  const uint32_t t0 = time[q][0] + time[q][1] * d256;
  uint32_t t1 = time[q][2] + time[q][3] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// Sequence codes: baselines and extra bits (RFC 8878 3.1.1.3.2.1.1).
constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                                  12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,   12,   13,   14,   15,   16,
                                  17, 18, 19, 20, 21, 22, 23, 24, 25,   26,   27,   28,   29,   30,
                                  31, 32, 33, 34, 35, 37, 39, 41, 43,   47,   51,   59,   67,   83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr long kBlockMax = 128 * 1024;

struct ZFrame {
  std::vector<uint8_t> out;  // the frame's content so far
  size_t limit = 0;          // the most it may hold
  long block_max = kBlockMax;
  ZHuffman huf;
  bool has_huf = false;
  int huf_x2 = 0;  // the double-symbol decoder's table log, or 0
  Fse ll, of, ml;
  bool has_tables = false;
  uint32_t rep[3] = {1, 4, 8};
};

// One table of a sequences section: mode 0 predefined, 1 RLE, 2 FSE-coded,
// 3 repeat. Returns the bytes it takes, or -1.
long seq_table(Fse &f, int mode, const uint8_t *src, long n, const int16_t *preset, int preset_max,
               int preset_log, int max_symbol, int max_log, bool has_previous) {
  if (mode == 0) return fse_build(f, preset, preset_max, preset_log) ? 0 : -1;
  if (mode == 1) {
    if (n < 1 || src[0] > max_symbol) return -1;
    fse_rle(f, src[0]);
    return 1;
  }
  if (mode == 3) return has_previous ? 0 : -1;
  int16_t norm[64];
  int max = max_symbol, log = 0;
  const long used = fse_read_ncount(src, n, norm, max, log);
  if (used < 0 || log > max_log || !fse_build(f, norm, max, log)) return -1;
  return used;
}

// A compressed block (RFC 8878 3.1.1.3): literals, then sequences
// executed onto the frame's content.
long zstd_block(ZFrame &z, const uint8_t *src, long n) {
  if (n < 2) return kCorrupt;
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  std::vector<uint8_t> lit;
  long pos;
  if (type < 2) {
    long size, lh;
    if (sf == 1) {
      lh = 2, size = (src[0] >> 4) | src[1] << 4;
    } else if (sf == 3) {
      if (n < 3 + type) return kCorrupt;
      lh = 3, size = (src[0] >> 4) | src[1] << 4 | src[2] << 12;
    } else {
      lh = 1, size = src[0] >> 3;
    }
    if (type == 1 && sf == 1 && n < 3) return kCorrupt;
    if (size > z.block_max) return kCorrupt;
    if (type == 0) {
      if (lh + size > n) return kCorrupt;
      lit.assign(src + lh, src + lh + size);
      pos = lh + size;
    } else {
      lit.assign(size, src[lh]);
      pos = lh + 1;
    }
  } else {
    if (n < 5) return kCorrupt;
    const uint64_t head = src[0] | src[1] << 8 | src[2] << 16 | (uint64_t)src[3] << 24 |
                          (uint64_t)src[4] << 32;
    long lh, size, csize;
    const bool single = sf == 0;
    if (sf < 2) {
      lh = 3, size = (head >> 4) & 0x3FF, csize = (head >> 14) & 0x3FF;
    } else if (sf == 2) {
      lh = 4, size = (head >> 4) & 0x3FFF, csize = (head >> 18) & 0x3FFF;
    } else {
      lh = 5, size = (head >> 4) & 0x3FFFF, csize = (head >> 22) & 0x3FFFF;
    }
    if (size > z.block_max || (!single && size < 6) || lh + csize > n) return kCorrupt;
    if (type == 3 && !z.has_huf) return kCorrupt;
    const uint8_t *p = src + lh;
    long len = csize;
    if (type == 2) {
      const long hs = huf_read(p, len, z.huf);
      if (hs < 0 || hs >= len) return kCorrupt;
      p += hs, len -= hs;
    }
    if (type == 2) z.huf_x2 = single || !huf_pick_x2(size, csize) ? 0 : (z.huf.bits <= 11 ? 11 : 12);
    const int x2 = z.huf_x2;
    lit.resize(size);
    if (single) {
      if (!huf_stream(z.huf, p, len, lit.data(), size, x2)) return kCorrupt;
    } else {
      if (!huf_streams4(z.huf, p, len, lit.data(), size, x2)) return kCorrupt;
    }
    z.has_huf = true;
    pos = lh + csize;
  }
  // The sequences section.
  if (pos >= n) return kCorrupt;
  long nseq = src[pos++];
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (pos + 2 > n) return kCorrupt;
      nseq = (src[pos] | src[pos + 1] << 8) + 0x7F00;
      pos += 2;
    } else {
      if (pos >= n) return kCorrupt;
      nseq = ((nseq - 0x80) << 8) + src[pos++];
    }
  }
  const size_t start = z.out.size();
  auto emit = [&](const uint8_t *p, long k) -> bool {
    if (z.out.size() + k > z.limit || (long)(z.out.size() - start) + k > z.block_max) return false;
    z.out.insert(z.out.end(), p, p + k);
    return true;
  };
  if (nseq == 0) {
    if (pos != n) return kCorrupt;
    return emit(lit.data(), (long)lit.size()) ? 0 : kCorrupt;
  }
  if (pos >= n || (src[pos] & 3)) return kCorrupt;
  const int modes = src[pos++];
  long used;
  if ((used = seq_table(z.ll, modes >> 6, src + pos, n - pos, kLLNorm, 35, 6, 35, 9, z.has_tables)) < 0)
    return kCorrupt;
  pos += used;
  if ((used = seq_table(z.of, (modes >> 4) & 3, src + pos, n - pos, kOFNorm, 28, 5, 31, 8,
                        z.has_tables)) < 0)
    return kCorrupt;
  pos += used;
  if ((used = seq_table(z.ml, (modes >> 2) & 3, src + pos, n - pos, kMLNorm, 52, 6, 52, 9,
                        z.has_tables)) < 0)
    return kCorrupt;
  pos += used;
  z.has_tables = true;
  BackBits br;
  if (!br.init(src + pos, n - pos)) return kCorrupt;
  uint32_t sll = br.read(z.ll.log), sof = br.read(z.of.log), sml = br.read(z.ml.log);
  size_t lit_at = 0;
  for (long k = 0; k < nseq; k++) {
    const FseCell &cl = z.ll.t[sll], &co = z.of.t[sof], &cm = z.ml.t[sml];
    const int ofcode = co.symbol;
    uint64_t offset;
    const bool ll0 = cl.symbol == 0;
    if (ofcode > 1) {
      offset = (1ULL << ofcode) - 3 + br.read(ofcode);
      z.rep[2] = z.rep[1], z.rep[1] = z.rep[0], z.rep[0] = (uint32_t)offset;
    } else if (ofcode == 0) {
      offset = z.rep[ll0];
      z.rep[1] = z.rep[!ll0];
      z.rep[0] = (uint32_t)offset;
    } else {
      const uint32_t idx = 1 + ll0 + br.read(1);
      uint64_t value = idx == 3 ? (uint64_t)z.rep[0] - 1 : z.rep[idx];
      if (value == 0) value = UINT32_MAX;  // libzstd's -1: caught below
      if (idx != 1) z.rep[2] = z.rep[1];
      z.rep[1] = z.rep[0];
      z.rep[0] = (uint32_t)value;
      offset = value;
    }
    const uint64_t ml = kMLBase[cm.symbol] + br.read(kMLBits[cm.symbol]);
    const uint64_t ll = kLLBase[cl.symbol] + br.read(kLLBits[cl.symbol]);
    if (k + 1 < nseq) {
      sll = cl.next + br.read(cl.bits);
      sml = cm.next + br.read(cm.bits);
      sof = co.next + br.read(co.bits);
    }
    if (ll > lit.size() - lit_at || !emit(lit.data() + lit_at, (long)ll)) return kCorrupt;
    lit_at += ll;
    if (offset > z.out.size() || z.out.size() + ml > z.limit ||
        (long)(z.out.size() - start + ml) > z.block_max)
      return kCorrupt;
    const size_t from = z.out.size() - offset;
    for (uint64_t i = 0; i < ml; i++) z.out.push_back(z.out[from + i]);
  }
  if (br.pos != 0) return kCorrupt;
  return emit(lit.data() + lit_at, (long)(lit.size() - lit_at)) ? 0 : kCorrupt;
}

struct ZHead {
  bool skippable = false, single = false, checksum = false, has_size = false;
  long size = 0;      // of the header
  uint64_t skip = 0;  // a skippable frame's data
  uint64_t content = 0, window = 0;
};

// 0, 1 when the input ends within the header, or kCorrupt.
long zstd_head(const uint8_t *src, long n, ZHead &h) {
  if (n < 4) return 1;
  const uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) return 1;
    h.skippable = true, h.size = 8, h.skip = le32(src + 4);
    return 0;
  }
  if (magic != 0xFD2FB528u) return kCorrupt;
  if (n < 5) return 1;
  const int fhd = src[4], fcs_flag = fhd >> 6, did_flag = fhd & 3;
  h.single = (fhd >> 5) & 1, h.checksum = (fhd >> 2) & 1;
  if (fhd & 8) return kCorrupt;
  const int did_bytes = (int[]){0, 1, 2, 4}[did_flag];
  const int fcs_bytes = (int[]){h.single ? 1 : 0, 2, 4, 8}[fcs_flag];
  h.size = 5 + !h.single + did_bytes + fcs_bytes;
  if (n < h.size) return 1;
  long pos = 5;
  if (!h.single) {
    const int wlog = 10 + (src[pos] >> 3);
    if (wlog > 31) return kCorrupt;
    const uint64_t base = 1ULL << wlog;
    h.window = base + (base >> 3) * (src[pos] & 7);
    pos++;
  }
  uint32_t did = 0;
  for (int i = 0; i < did_bytes; i++) did |= (uint32_t)src[pos + i] << (8 * i);
  pos += did_bytes;
  if (did != 0) return kCorrupt;  // no dictionary is loaded
  if (fcs_bytes) {
    h.has_size = true;
    h.content = fcs_bytes == 8 ? le64(src + pos)
                : fcs_bytes == 4 ? le32(src + pos)
                : fcs_bytes == 2 ? (uint64_t)(src[pos] | src[pos + 1] << 8) + 256
                                 : src[pos];
  }
  if (h.single) h.window = h.content;
  return 0;
}

void zstd_init(ZFrame &z, const ZHead &h, size_t limit) {
  z.limit = limit;
  z.block_max = (long)std::min<uint64_t>(h.window, kBlockMax);
}

// A whole frame from its header on, as ZSTD_decompressFrame does: every
// block, the content size and the checksum checked. Returns the bytes it
// takes, or an error.
long zstd_frame(ZFrame &z, const ZHead &h, const uint8_t *src, long n) {
  long pos = h.size;
  for (;;) {
    if (n - pos < 3) return kTruncated;
    const uint32_t bh = src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16;
    const int type = (bh >> 1) & 3;
    const long size = bh >> 3;
    pos += 3;
    if (type == 3 || (type != 1 && size > z.block_max)) return kCorrupt;
    if (n - pos < (type == 1 ? 1 : size)) return kTruncated;
    if (type == 0 || type == 1) {
      if (z.out.size() + size > z.limit) return kCorrupt;
      if (type == 0)
        z.out.insert(z.out.end(), src + pos, src + pos + size);
      else
        z.out.insert(z.out.end(), size, src[pos]);
      pos += type == 1 ? 1 : size;
    } else {
      const long r = zstd_block(z, src + pos, size);
      if (r < 0) return r;
      pos += size;
    }
    if (bh & 1) break;
  }
  if (h.has_size && z.out.size() != h.content) return kCorrupt;
  if (h.checksum) {
    if (n - pos < 4) return kTruncated;
    if (le32(src + pos) != (uint32_t)xxh64(z.out.data(), z.out.size())) return kCorrupt;
    pos += 4;
  }
  return pos;
}

// The bytes of the frame that starts at src, or -1 where the input does
// not hold all of it (ZSTD_findFrameCompressedSize).
long zstd_frame_size(const ZHead &h, const uint8_t *src, long n) {
  long pos = h.size;
  for (;;) {
    if (n - pos < 3) return -1;
    const uint32_t bh = src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16;
    const int type = (bh >> 1) & 3;
    const long size = type == 1 ? 1 : bh >> 3;
    if (type == 3 || n - pos - 3 < size) return -1;
    pos += 3 + size;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - pos < 4) return -1;
    pos += 4;
  }
  return pos;
}

}  // namespace

extern "C" {

// A TIFF strip or tile of zstd data, as libtiff's ZSTDDecode has libzstd's
// ZSTD_decompressStream decode it into `cap` bytes: the first frame only
// (a skippable one gives nothing). Where the frame's content size is known
// and fits and the frame is all there, it is decoded whole with every
// check (libzstd's single-pass shortcut). Otherwise block by block: a
// block is decoded whole, then flushed; once a block no longer fits, the
// rest is not read, and until then the next block (or the checksum) is.
// Returns the bytes written (short when the data ends first) or an error.
long zstd_strip(const uint8_t *src, long n, uint8_t *dst, long cap) {
  ZHead h;
  const long r = zstd_head(src, n, h);
  if (r < 0) return r;
  if (r > 0 || h.skippable) return 0;
  ZFrame z;
  if (h.has_size && h.content <= (uint64_t)cap && zstd_frame_size(h, src, n) >= 0) {
    zstd_init(z, h, (size_t)h.content);
    const long used = zstd_frame(z, h, src, n);
    if (used < 0) return used;
    std::memcpy(dst, z.out.data(), z.out.size());
    return (long)z.out.size();
  }
  if (std::max<uint64_t>(h.window, 1024) > (1ULL << 27) + 1) return kCorrupt;
  zstd_init(z, h, (size_t)cap + kBlockMax);
  long pos = h.size;
  size_t flushed = 0;
  auto flush = [&]() {
    const size_t take = std::min(z.out.size() - flushed, (size_t)cap - flushed);
    std::memcpy(dst + flushed, z.out.data() + flushed, take);
    flushed += take;
    return flushed == z.out.size();
  };
  for (;;) {
    if (n - pos < 3) break;
    const uint32_t bh = src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16;
    const int type = (bh >> 1) & 3;
    const long size = bh >> 3;
    if (type == 3 || (type != 1 && size > z.block_max)) return kCorrupt;
    pos += 3;
    if (type == 0) {
      const long take = std::min(size, n - pos);
      z.out.insert(z.out.end(), src + pos, src + pos + take);
      pos += take;
      if (take < size) {
        flush();
        break;
      }
    } else if (type == 1) {
      if (n - pos < 1) break;
      if (z.out.size() + size > z.limit) return kCorrupt;
      z.out.insert(z.out.end(), size, src[pos++]);
    } else {
      if (n - pos < size) break;
      const long e = zstd_block(z, src + pos, size);
      if (e < 0) return e;
      pos += size;
    }
    // The content size is checked as the last block is decoded, the
    // checksum only once it is flushed.
    if ((bh & 1) && h.has_size && z.out.size() != h.content) return kCorrupt;
    if (!flush()) break;
    if (bh & 1) {
      if (h.checksum && n - pos >= 4 &&
          le32(src + pos) != (uint32_t)xxh64(z.out.data(), z.out.size()))
        return kCorrupt;
      break;
    }
  }
  return (long)flushed;
}

// Every frame of a zstd stream, skippable ones skipped, into at most `cap`
// bytes (the zstd tool's and python-zstandard's reading across frames).
// Returns the bytes written or an error: a truncated or broken frame,
// output past `cap`.
long zstd_frames(const uint8_t *src, long n, uint8_t *dst, long cap) {
  long pos = 0, total = 0;
  while (pos < n) {
    ZHead h;
    const long r = zstd_head(src + pos, n - pos, h);
    if (r < 0) return r;
    if (r > 0) return kTruncated;
    if (h.skippable) {
      if ((uint64_t)(n - pos - 8) < h.skip) return kTruncated;
      pos += 8 + (long)h.skip;
      continue;
    }
    ZFrame z;
    zstd_init(z, h, (size_t)(cap - total));
    const long used = zstd_frame(z, h, src + pos, n - pos);
    if (used < 0) return used;
    std::memcpy(dst + total, z.out.data(), z.out.size());
    total += (long)z.out.size();
    pos += used;
  }
  return total;
}

// An ICNS 24-bit icon's run-length code (IcnsImagePlugin.read_32): the
// three planes one after another, each `size` bytes of packets (a header
// byte with its top bit set repeats the next byte header - 125 times,
// any other is followed by header + 1 literal bytes); the packets of a
// plane must add up to `size` exactly. Writes 3 * size bytes. Returns the
// bytes read, kCorrupt for a packet past its plane or kTruncated.
long icns_rle(const uint8_t *src, long n, long size, uint8_t *out) {
  long i = 0;
  for (int plane = 0; plane < 3; plane++) {
    uint8_t *o = out + plane * size;
    long len = 0;
    while (len < size) {
      if (i >= n) return kTruncated;
      const uint8_t b = src[i++];
      if (b & 0x80) {
        const long run = b - 125;
        if (len + run > size) return kCorrupt;
        if (i >= n) return kTruncated;
        std::memset(o + len, src[i++], run);
        len += run;
      } else {
        const long k = b + 1;
        if (len + k > size) return kCorrupt;
        if (n - i < k) return kTruncated;
        std::memcpy(o + len, src + i, k);
        len += k;
        i += k;
      }
    }
  }
  return i;
}

}  // extern "C"
