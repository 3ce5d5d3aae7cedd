// AV1 reconstruction of a key frame's transform blocks: every intra
// predictor (AV1 specification 7.11.2: DC, smooth, Paeth, directional
// with the edge filter and upsampling, filter intra), chroma from luma
// and, in av1entropy.cpp, palette; dequantisation and the inverse
// transforms (7.13: DCT 4-64, ADST 4-16, flipped ADST, identity, and the
// Walsh-Hadamard transform of lossless blocks), with each size's
// intermediate rounding and clamping, added to the prediction.

#include "av1.h"

#include "av1tables.h"

namespace av1 {

namespace {

const uint8_t kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const int kEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
const int kSmOffset[7] = {0, 0, 0, 4, 12, 28, 60};  // by log2 size

// -- inverse transforms (7.13.2) ---------------------------------------------

int cos128(int angle) {
    int a = angle & 255;
    auto lut = [](int i) { return i == 64 ? 0 : kCos128[i]; };
    if (a <= 64) return lut(a);
    if (a <= 128) return -lut(128 - a);
    if (a <= 192) return -lut(a - 128);
    return lut(256 - a);
}
inline int sin128(int angle) { return cos128(angle - 64); }

int brev(int bits, int x) {
    int r = 0;
    for (int i = 0; i < bits; i++) r |= ((x >> i) & 1) << (bits - 1 - i);
    return r;
}

struct Tx1d {
    int32_t* T;
    int lo, hi;  // the clamp of the butterfly additions (dav1d clamps them)
    void B(int a, int b, int angle, int flip) {
        int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
        int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
        T[a] = (int32_t)round2l(x, 12);
        T[b] = (int32_t)round2l(y, 12);
        if (flip) std::swap(T[a], T[b]);
    }
    void H(int a, int b, int flip) {
        if (flip) std::swap(a, b);
        int32_t x = T[a], y = T[b];
        T[a] = clip3(lo, hi, x + y);
        T[b] = clip3(lo, hi, x - y);
    }
    void dct(int n) {
        int32_t copy[64];
        int n0 = 1 << n;
        std::memcpy(copy, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = copy[brev(n, i)];
        if (n == 6)
            for (int i = 0; i < 16; i++) B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
        if (n >= 5)
            for (int i = 0; i < 8; i++) B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
        if (n == 6)
            for (int i = 0; i < 16; i++) H(32 + i * 2, 33 + i * 2, i & 1);
        if (n >= 4)
            for (int i = 0; i < 4; i++) B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
        if (n >= 5)
            for (int i = 0; i < 8; i++) H(16 + 2 * i, 17 + 2 * i, i & 1);
        if (n == 6)
            for (int i = 0; i < 4; i++)
                for (int j = 0; j < 2; j++)
                    B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
        if (n >= 3)
            for (int i = 0; i < 2; i++) B(4 + i, 7 - i, 56 - 32 * i, 0);
        if (n >= 4)
            for (int i = 0; i < 4; i++) H(8 + 2 * i, 9 + 2 * i, i & 1);
        if (n >= 5)
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 2; j++)
                    B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
        if (n == 6)
            for (int i = 0; i < 8; i++)
                for (int j = 0; j < 2; j++) H(32 + i * 4 + j, 35 + i * 4 - j, i & 1);
        for (int i = 0; i < 2; i++) B(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i);
        if (n >= 3)
            for (int i = 0; i < 2; i++) H(4 + 2 * i, 5 + 2 * i, i);
        if (n >= 4)
            for (int i = 0; i < 2; i++) B(14 - i, 9 + i, 48 + 64 * i, 1);
        if (n >= 5)
            for (int i = 0; i < 4; i++)
                for (int j = 0; j < 2; j++) H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
        if (n == 6)
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 4; j++)
                    B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
        for (int i = 0; i < 2; i++) H(i, 3 - i, 0);
        if (n >= 3) B(6, 5, 32, 1);
        if (n >= 4)
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 2; j++) H(8 + 4 * i + j, 11 + 4 * i - j, i);
        if (n >= 5)
            for (int i = 0; i < 4; i++) B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
        if (n == 6)
            for (int i = 0; i < 4; i++)
                for (int j = 0; j < 4; j++) H(32 + 8 * i + j, 39 + 8 * i - j, i & 1);
        if (n >= 3)
            for (int i = 0; i < 4; i++) H(i, 7 - i, 0);
        if (n >= 4)
            for (int i = 0; i < 2; i++) B(13 - i, 10 + i, 32, 1);
        if (n >= 5)
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 4; j++) H(16 + i * 8 + j, 23 + i * 8 - j, i);
        if (n == 6)
            for (int i = 0; i < 8; i++) B(59 - i, 36 + i, i < 4 ? 48 : 112, 1);
        if (n >= 4)
            for (int i = 0; i < 8; i++) H(i, 15 - i, 0);
        if (n >= 5)
            for (int i = 0; i < 4; i++) B(27 - i, 20 + i, 32, 1);
        if (n == 6) {
            for (int i = 0; i < 8; i++) H(32 + i, 47 - i, 0);
            for (int i = 0; i < 8; i++) H(48 + i, 63 - i, 1);
        }
        if (n >= 5)
            for (int i = 0; i < 16; i++) H(i, 31 - i, 0);
        if (n == 6)
            for (int i = 0; i < 8; i++) B(55 - i, 40 + i, 32, 1);
        if (n == 6)
            for (int i = 0; i < 32; i++) H(i, 63 - i, 0);
    }
    void adst4() {
        int64_t s0 = (int64_t)kSinpi[1] * T[0], s1 = (int64_t)kSinpi[2] * T[0];
        int64_t s2 = (int64_t)kSinpi[3] * T[1], s3 = (int64_t)kSinpi[4] * T[2];
        int64_t s4 = (int64_t)kSinpi[1] * T[2], s5 = (int64_t)kSinpi[2] * T[3];
        int64_t s6 = (int64_t)kSinpi[4] * T[3];
        int32_t a7 = T[0] - T[2];
        int32_t b7 = a7 + T[3];
        s0 = s0 + s3;
        s1 = s1 - s4;
        s3 = s2;
        s2 = (int64_t)kSinpi[3] * b7;
        s0 = s0 + s5;
        s1 = s1 - s6;
        int64_t x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1 - s3;
        T[0] = (int32_t)round2l(x0, 12);
        T[1] = (int32_t)round2l(x1, 12);
        T[2] = (int32_t)round2l(x2, 12);
        T[3] = (int32_t)round2l(x3, 12);
    }
    static int32_t hb(int w0, int32_t a, int w1, int32_t b) {
        return (int32_t)round2l((int64_t)w0 * a + (int64_t)w1 * b, 12);
    }
    int32_t cl(int32_t v) const { return clip3(lo, hi, v); }
    void adst8() {
        const int32_t* c = kCos128;
        int32_t x[8] = {T[7], T[0], T[5], T[2], T[3], T[4], T[1], T[6]}, y[8];
        for (int i = 0; i < 4; i++) {
            int k = 4 + 16 * i;  // cospi[4], [20], [36], [52]
            y[2 * i] = hb(c[k], x[2 * i], c[64 - k], x[2 * i + 1]);
            y[2 * i + 1] = hb(c[64 - k], x[2 * i], -c[k], x[2 * i + 1]);
        }
        for (int i = 0; i < 4; i++) {
            x[i] = cl(y[i] + y[i + 4]);
            x[i + 4] = cl(y[i] - y[i + 4]);
        }
        y[0] = x[0], y[1] = x[1], y[2] = x[2], y[3] = x[3];
        y[4] = hb(c[16], x[4], c[48], x[5]);
        y[5] = hb(c[48], x[4], -c[16], x[5]);
        y[6] = hb(-c[48], x[6], c[16], x[7]);
        y[7] = hb(c[16], x[6], c[48], x[7]);
        x[0] = cl(y[0] + y[2]), x[1] = cl(y[1] + y[3]), x[2] = cl(y[0] - y[2]), x[3] = cl(y[1] - y[3]);
        x[4] = cl(y[4] + y[6]), x[5] = cl(y[5] + y[7]), x[6] = cl(y[4] - y[6]), x[7] = cl(y[5] - y[7]);
        y[0] = x[0], y[1] = x[1], y[4] = x[4], y[5] = x[5];
        y[2] = hb(c[32], x[2], c[32], x[3]);
        y[3] = hb(c[32], x[2], -c[32], x[3]);
        y[6] = hb(c[32], x[6], c[32], x[7]);
        y[7] = hb(c[32], x[6], -c[32], x[7]);
        T[0] = y[0], T[1] = -y[4], T[2] = y[6], T[3] = -y[2];
        T[4] = y[3], T[5] = -y[7], T[6] = y[5], T[7] = -y[1];
    }
    void adst16() {
        const int32_t* c = kCos128;
        static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
        int32_t x[16], y[16];
        for (int i = 0; i < 16; i++) x[i] = T[perm[i]];
        for (int i = 0; i < 8; i++) {
            int k = 2 + 8 * i;  // cospi[2], [10], ..., [58]
            y[2 * i] = hb(c[k], x[2 * i], c[64 - k], x[2 * i + 1]);
            y[2 * i + 1] = hb(c[64 - k], x[2 * i], -c[k], x[2 * i + 1]);
        }
        for (int i = 0; i < 8; i++) {
            x[i] = cl(y[i] + y[i + 8]);
            x[i + 8] = cl(y[i] - y[i + 8]);
        }
        for (int i = 0; i < 8; i++) y[i] = x[i];
        y[8] = hb(c[8], x[8], c[56], x[9]);
        y[9] = hb(c[56], x[8], -c[8], x[9]);
        y[10] = hb(c[40], x[10], c[24], x[11]);
        y[11] = hb(c[24], x[10], -c[40], x[11]);
        y[12] = hb(-c[56], x[12], c[8], x[13]);
        y[13] = hb(c[8], x[12], c[56], x[13]);
        y[14] = hb(-c[24], x[14], c[40], x[15]);
        y[15] = hb(c[40], x[14], c[24], x[15]);
        for (int g = 0; g < 16; g += 8)
            for (int i = 0; i < 4; i++) {
                x[g + i] = cl(y[g + i] + y[g + i + 4]);
                x[g + i + 4] = cl(y[g + i] - y[g + i + 4]);
            }
        for (int g = 0; g < 16; g += 8) {
            y[g] = x[g], y[g + 1] = x[g + 1], y[g + 2] = x[g + 2], y[g + 3] = x[g + 3];
            y[g + 4] = hb(c[16], x[g + 4], c[48], x[g + 5]);
            y[g + 5] = hb(c[48], x[g + 4], -c[16], x[g + 5]);
            y[g + 6] = hb(-c[48], x[g + 6], c[16], x[g + 7]);
            y[g + 7] = hb(c[16], x[g + 6], c[48], x[g + 7]);
        }
        for (int g = 0; g < 16; g += 4) {
            x[g] = cl(y[g] + y[g + 2]);
            x[g + 1] = cl(y[g + 1] + y[g + 3]);
            x[g + 2] = cl(y[g] - y[g + 2]);
            x[g + 3] = cl(y[g + 1] - y[g + 3]);
        }
        for (int g = 0; g < 16; g += 4) {
            y[g] = x[g], y[g + 1] = x[g + 1];
            y[g + 2] = hb(c[32], x[g + 2], c[32], x[g + 3]);
            y[g + 3] = hb(c[32], x[g + 2], -c[32], x[g + 3]);
        }
        static const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
        for (int i = 0; i < 16; i++) T[i] = (i & 1) ? -y[out[i]] : y[out[i]];
    }
    void identity(int n) {
        int n0 = 1 << n;
        for (int i = 0; i < n0; i++) {
            if (n == 2) T[i] = (int32_t)round2l((int64_t)T[i] * 5793, 12);
            else if (n == 3) T[i] = T[i] * 2;
            else if (n == 4) T[i] = (int32_t)round2l((int64_t)T[i] * 11586, 12);
            else T[i] = T[i] * 4;
        }
    }
    void wht(int shift) {
        int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
        a += c;
        d -= b;
        int32_t e = (a - d) >> 1;
        b = e - b;
        c = e - c;
        a -= b;
        d += c;
        T[0] = a, T[1] = b, T[2] = c, T[3] = d;
    }
    // kind: 0 DCT, 1 ADST, 2 identity
    void run(int kind, int n) {
        if (kind == 0) dct(n);
        else if (kind == 2) identity(n);
        else if (n == 2) adst4();
        else if (n == 3) adst8();
        else adst16();
    }
};


// Where each transform size's quantizer matrix starts in a level's
// (Qm_Offset: the 64-sample sides take the 32-sample matrices), each
// matrix column by column.
const int16_t kQmOffset[TX_SIZES_ALL] = {0,    16,   80,   336,  336,  1360, 1392,
                                         1424, 1552, 1680, 2192, 336,  336,  2704,
                                         2768, 2832, 3088, 1680, 2192};

}  // namespace

void inverse_transform_1d(int kind, int log2n, int32_t* T) {
    Tx1d t{T, INT32_MIN, INT32_MAX};
    t.run(kind, log2n);
}

namespace {

template <typename pixel>
void reconstruct_t(Decoder& d, int plane, int x0, int y0, int tx, int tx_type, int lossless,
                   int32_t* quant, int dc_q, int ac_q, int qm_level) {
    int log2w = kTxWLog2[tx], log2h = kTxHLog2[tx], w = 1 << log2w, h = 1 << log2h;
    int tw = std::min(32, w), th = std::min(32, h);
    int shift = (tx == TX_32X32 || tx == TX_16X32 || tx == TX_32X16 || tx == TX_16X64 ||
                 tx == TX_64X16) ? 1
              : (tx == TX_64X64 || tx == TX_32X64 || tx == TX_64X32) ? 2 : 0;
    static thread_local int32_t res[64 * 64];
    const int bd = bit_depth<pixel>(d), maxc = (1 << (7 + bd)) - 1, minc = -(1 << (7 + bd));
    const int maxv = pixel_max<pixel>(d);
    // Dequantise into res[i * w + j], weighting by the quantizer matrix
    // where the block is not lossless and its transform is 2-D (dav1d
    // takes no matrix for the identity and 1-D types).
    const uint8_t* qm = qm_level < 15 && !lossless && tx_type < IDTX
                            ? kQuantizerMatrix[qm_level][plane > 0] + kQmOffset[tx]
                            : nullptr;
    std::memset(res, 0, sizeof(int32_t) * w * h);
    for (int i = 0; i < th; i++)
        for (int j = 0; j < tw; j++) {
            int32_t qv = quant[i * tw + j];
            if (!qv) continue;
            int q = (i == 0 && j == 0) ? dc_q : ac_q;
            if (qm) q = round2(q * qm[j * th + i], 5);  // column by column
            int64_t dq = ((int64_t)std::abs(qv) * q) & 0xFFFFFF;
            dq >>= shift;
            if (qv < 0) dq = -dq;
            res[i * w + j] = (int32_t)std::min<int64_t>(std::max<int64_t>(dq, minc), maxc);
        }
    int32_t T[64];
    int flip_ud = tx_type == FLIPADST_DCT || tx_type == FLIPADST_ADST ||
                  tx_type == V_FLIPADST || tx_type == FLIPADST_FLIPADST;
    int flip_lr = tx_type == DCT_FLIPADST || tx_type == ADST_FLIPADST ||
                  tx_type == H_FLIPADST || tx_type == FLIPADST_FLIPADST;
    if (lossless) {
        Tx1d t{T, INT32_MIN, INT32_MAX};
        for (int i = 0; i < 4; i++) {
            for (int j = 0; j < 4; j++) T[j] = res[i * 4 + j];
            t.wht(2);
            for (int j = 0; j < 4; j++) res[i * 4 + j] = T[j];
        }
        for (int j = 0; j < 4; j++) {
            for (int i = 0; i < 4; i++) T[i] = res[i * 4 + j];
            t.wht(0);
            for (int i = 0; i < 4; i++) res[i * 4 + j] = T[i];
        }
    } else {
        int row_shift = kTransformRowShift[tx];
        const int row_bits = bd + 8, col_bits = std::max(bd + 6, 16);
        Tx1d rt{T, -(1 << (row_bits - 1)), (1 << (row_bits - 1)) - 1};
        Tx1d ct{T, -(1 << (col_bits - 1)), (1 << (col_bits - 1)) - 1};
        int hk = kHorzKind[tx_type], vk = kVertKind[tx_type];
        int rect = std::abs(log2w - log2h) == 1;
        for (int i = 0; i < std::min(h, 32); i++) {
            bool any = false;
            for (int j = 0; j < w; j++) {
                T[j] = res[i * w + j];
                any |= T[j] != 0;
            }
            if (!any) continue;
            for (int j = 0; j < w; j++) {
                if (rect) T[j] = (int32_t)round2l((int64_t)T[j] * 2896, 12);
                T[j] = clip3(-(1 << (bd + 7)), (1 << (bd + 7)) - 1, T[j]);
            }
            rt.run(hk, log2w);
            for (int j = 0; j < w; j++) res[i * w + j] = round2(T[j], row_shift);
        }
        for (int i = 0; i < h * w; i++) res[i] = clip3(ct.lo, ct.hi, res[i]);
        for (int j = 0; j < w; j++) {
            for (int i = 0; i < h; i++) T[i] = res[i * w + j];
            ct.run(vk, log2h);
            for (int i = 0; i < h; i++) res[i * w + j] = round2(T[i], 4);
        }
    }
    Plane& p = d.cur[plane];
    for (int i = 0; i < h; i++) {
        pixel* out = p.px<pixel>(y0 + (flip_ud ? h - 1 - i : i)) + x0;
        const int32_t* r = res + i * w;
        if (flip_lr)
            for (int j = 0; j < w; j++)
                out[w - 1 - j] = (pixel)clip3(0, maxv, out[w - 1 - j] + r[j]);
        else
            for (int j = 0; j < w; j++) out[j] = (pixel)clip3(0, maxv, out[j] + r[j]);
    }
}

}  // namespace

void reconstruct(Decoder& d, int plane, int x0, int y0, int tx, int tx_type, int lossless,
                 int32_t* quant, int dc_q, int ac_q, int qm_level) {
    (d.seq.bit_depth > 8 ? reconstruct_t<uint16_t> : reconstruct_t<uint8_t>)(
        d, plane, x0, y0, tx, tx_type, lossless, quant, dc_q, ac_q, qm_level);
}

// -- intra prediction (7.11.2) -------------------------------------------------

namespace {

struct Edges {
    int above_buf[320], left_buf[320];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
};

// The above and left edges, with the base values 2^(BitDepth-1) - 1, + 1
// and 2^(BitDepth-1) where a side is missing.
template <typename pixel>
void prepare_edges(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                   int have_ar, int have_bl, int w, int h, Edges& e) {
    const SequenceHeader& s = d.seq;
    const int base = 1 << (bit_depth<pixel>(d) - 1);
    int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
    int max_x = ((d.mi_cols * 4) >> sx) - 1, max_y = ((d.mi_rows * 4) >> sy) - 1;
    Plane& p = d.cur[plane];
    auto at = [&](int r, int c) { return (int)p.px<pixel>(r)[c]; };
    int n = w + h;
    if (!have_above && have_left) {
        int v = at(y, x - 1);
        for (int i = 0; i < n; i++) e.above[i] = v;
    } else if (!have_above && !have_left) {
        for (int i = 0; i < n; i++) e.above[i] = base - 1;
    } else {
        int limit = std::min(max_x, x + (have_ar ? 2 * w : w) - 1);
        const pixel* r = p.px<pixel>(y - 1);
        for (int i = 0; i < n; i++) e.above[i] = r[std::min(limit, x + i)];
    }
    if (!have_left && have_above) {
        int v = at(y - 1, x);
        for (int i = 0; i < n; i++) e.left[i] = v;
    } else if (!have_left && !have_above) {
        for (int i = 0; i < n; i++) e.left[i] = base + 1;
    } else {
        int limit = std::min(max_y, y + (have_bl ? 2 * h : h) - 1);
        for (int i = 0; i < n; i++) e.left[i] = at(std::min(limit, y + i), x - 1);
    }
    if (have_above && have_left) e.above[-1] = at(y - 1, x - 1);
    else if (have_above) e.above[-1] = at(y - 1, x);
    else if (have_left) e.above[-1] = at(y, x - 1);
    else e.above[-1] = base;
    e.left[-1] = e.above[-1];
}

int is_smooth(const Decoder& d, int r, int c, int plane) {
    const BlockInfo& b = d.bi(r, c);
    int m = plane == 0 ? b.y_mode : b.uv_mode;
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
}

int filter_type(const Decoder& d, int plane, int avail_u, int avail_l, int mi_row, int mi_col) {
    const SequenceHeader& s = d.seq;
    int above = 0, left = 0;
    if (avail_u) {
        int r = mi_row - 1, c = mi_col;
        if (plane > 0) {
            if (s.subsampling_x && !(mi_col & 1)) c++;
            if (s.subsampling_y && (mi_row & 1)) r--;
        }
        above = is_smooth(d, r, c, plane);
    }
    if (avail_l) {
        int r = mi_row, c = mi_col - 1;
        if (plane > 0) {
            if (s.subsampling_x && (mi_col & 1)) c--;
            if (s.subsampling_y && !(mi_row & 1)) r++;
        }
        left = is_smooth(d, r, c, plane);
    }
    return above || left;
}

int edge_strength(int w, int h, int type, int delta) {
    int dd = std::abs(delta), wh = w + h, s = 0;
    if (type == 0) {
        if (wh <= 8) {
            if (dd >= 56) s = 1;
        } else if (wh <= 12) {
            if (dd >= 40) s = 1;
        } else if (wh <= 16) {
            if (dd >= 40) s = 1;
        } else if (wh <= 24) {
            if (dd >= 8) s = 1;
            if (dd >= 16) s = 2;
            if (dd >= 32) s = 3;
        } else if (wh <= 32) {
            if (dd >= 1) s = 1;
            if (dd >= 4) s = 2;
            if (dd >= 32) s = 3;
        } else {
            if (dd >= 1) s = 3;
        }
    } else {
        if (wh <= 8) {
            if (dd >= 40) s = 1;
            if (dd >= 64) s = 2;
        } else if (wh <= 16) {
            if (dd >= 20) s = 1;
            if (dd >= 48) s = 2;
        } else if (wh <= 24) {
            if (dd >= 4) s = 3;
        } else {
            if (dd >= 1) s = 3;
        }
    }
    return s;
}

int use_upsample(int w, int h, int type, int delta) {
    int dd = std::abs(delta), wh = w + h;
    if (dd <= 0 || dd >= 40) return 0;
    return type ? wh <= 8 : wh <= 16;
}

void edge_filter(int* buf, int num_px, int strength) {
    if (!strength) return;
    int edge[320];
    for (int i = 0; i < num_px; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < num_px; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int k = clip3(0, num_px - 1, i - 2 + j);
            s += kEdgeKernel[strength - 1][j] * edge[k];
        }
        buf[i - 1] = (s + 8) >> 4;
    }
}

void upsample(int* buf, int num_px, int maxv) {
    int dup[320];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num_px; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        buf[2 * i - 1] = clip3(0, maxv, round2(s, 4));
        buf[2 * i] = dup[i + 2];
    }
}

template <typename pixel>
void predict_intra_t(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                     int have_ar, int have_bl, int mode, int log2w, int log2h, const BlockInfo& b,
                     int avail_u, int avail_l, int mi_row, int mi_col) {
    int w = 1 << log2w, h = 1 << log2h;
    const int maxv = pixel_max<pixel>(d);
    Edges e;
    prepare_edges<pixel>(d, plane, x, y, have_left, have_above, have_ar, have_bl, w, h, e);
    Plane& p = d.cur[plane];
    int* above = e.above;
    int* left = e.left;
    if (mode >= V_PRED && mode <= D67_PRED) {
        const SequenceHeader& s = d.seq;
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int max_x = ((d.mi_cols * 4) >> sx) - 1, max_y = ((d.mi_rows * 4) >> sy) - 1;
        int delta = plane == 0 ? b.angle_delta_y : b.angle_delta_uv;
        int angle = kModeToAngle[mode] + delta * 3;
        int up_above = 0, up_left = 0;
        if (s.enable_intra_edge_filter) {
            int type = filter_type(d, plane, avail_u, avail_l, mi_row, mi_col);
            if (angle != 90 && angle != 180) {
                if (angle > 90 && angle < 180 && (w + h) >= 24) {
                    int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                    left[-1] = above[-1] = v;
                }
                if (have_above) {
                    int strength = edge_strength(w, h, type, angle - 90);
                    int num_px = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
                    edge_filter(above, num_px, strength);
                }
                if (have_left) {
                    int strength = edge_strength(w, h, type, angle - 180);
                    int num_px = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
                    edge_filter(left, num_px, strength);
                }
            }
            up_above = use_upsample(w, h, type, angle - 90);
            if (up_above) upsample(above, w + (angle < 90 ? h : 0), maxv);
            up_left = use_upsample(w, h, type, angle - 180);
            if (up_left) upsample(left, h + (angle > 180 ? w : 0), maxv);
        }
        int dx = 0, dy = 0;
        if (angle < 90) dx = kDrIntraDerivative[angle];
        else if (angle > 90 && angle < 180) dx = kDrIntraDerivative[180 - angle];
        if (angle > 90 && angle < 180) dy = kDrIntraDerivative[angle - 90];
        else if (angle > 180) dy = kDrIntraDerivative[270 - angle];
        for (int i = 0; i < h; i++) {
            pixel* out = p.px<pixel>(y + i) + x;
            for (int j = 0; j < w; j++) {
                int pred;
                if (angle < 90) {
                    int idx = (i + 1) * dx;
                    int base = (idx >> (6 - up_above)) + (j << up_above);
                    int shift = ((idx << up_above) >> 1) & 0x1F;
                    int max_base = (w + h - 1) << up_above;
                    if (base < max_base)
                        pred = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                    else
                        pred = above[max_base];
                } else if (angle > 90 && angle < 180) {
                    int idx = (j << 6) - (i + 1) * dx;
                    int base = idx >> (6 - up_above);
                    if (base >= -(1 << up_above)) {
                        int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                        pred = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                    } else {
                        idx = (i << 6) - (j + 1) * dy;
                        base = idx >> (6 - up_left);
                        int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
                        pred = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                    }
                } else if (angle > 180) {
                    int idx = (j + 1) * dy;
                    int base = (idx >> (6 - up_left)) + (i << up_left);
                    int shift = ((idx << up_left) >> 1) & 0x1F;
                    pred = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                } else if (angle == 90) {
                    pred = above[j];
                } else {
                    pred = left[i];
                }
                out[j] = (pixel)pred;
            }
        }
        return;
    }
    if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
        const uint8_t* wx = kSmWeights + kSmOffset[log2w];
        const uint8_t* wy = kSmWeights + kSmOffset[log2h];
        for (int i = 0; i < h; i++) {
            pixel* out = p.px<pixel>(y + i) + x;
            for (int j = 0; j < w; j++) {
                int v;
                if (mode == SMOOTH_PRED)
                    v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                                   (256 - wx[j]) * above[w - 1], 9);
                else if (mode == SMOOTH_V_PRED)
                    v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
                else
                    v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
                out[j] = (pixel)v;
            }
        }
        return;
    }
    if (mode == DC_PRED) {
        int avg;
        if (have_left && have_above) {
            int sum = 0;
            for (int k = 0; k < w; k++) sum += above[k];
            for (int k = 0; k < h; k++) sum += left[k];
            avg = (sum + ((w + h) >> 1)) / (w + h);
        } else if (have_left) {
            int sum = 0;
            for (int k = 0; k < h; k++) sum += left[k];
            avg = clip3(0, maxv, (sum + (h >> 1)) >> log2h);
        } else if (have_above) {
            int sum = 0;
            for (int k = 0; k < w; k++) sum += above[k];
            avg = clip3(0, maxv, (sum + (w >> 1)) >> log2w);
        } else {
            avg = (maxv + 1) >> 1;
        }
        for (int i = 0; i < h; i++) std::fill_n(p.px<pixel>(y + i) + x, w, (pixel)avg);
        return;
    }
    // PAETH_PRED
    for (int i = 0; i < h; i++) {
        pixel* out = p.px<pixel>(y + i) + x;
        for (int j = 0; j < w; j++) {
            int base = above[j] + left[i] - above[-1];
            int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]);
            int ptl = std::abs(base - above[-1]);
            int v;
            if (pl <= pt && pl <= ptl) v = left[i];
            else if (pt <= ptl) v = above[j];
            else v = above[-1];
            out[j] = (pixel)v;
        }
    }
}

template <typename pixel>
void predict_filter_intra_t(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                            int have_ar, int have_bl, int log2w, int log2h, int mode) {
    int w = 1 << log2w, h = 1 << log2h;
    const int maxv = pixel_max<pixel>(d);
    Edges e;
    prepare_edges<pixel>(d, plane, x, y, have_left, have_above, have_ar, have_bl, w, h, e);
    Plane& p = d.cur[plane];
    int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
            int pv[7];
            for (int i = 0; i < 7; i++) {
                if (i < 5) {
                    if (i2 == 0) pv[i] = e.above[(j4 << 2) + i - 1];
                    else if (j4 == 0 && i == 0) pv[i] = e.left[(i2 << 1) - 1];
                    else pv[i] = p.px<pixel>(y + (i2 << 1) - 1)[x + (j4 << 2) + i - 1];
                } else {
                    if (j4 == 0) pv[i] = e.left[(i2 << 1) + i - 5];
                    else pv[i] = p.px<pixel>(y + (i2 << 1) + i - 5)[x + (j4 << 2) - 1];
                }
            }
            for (int i = 0; i < 8; i++) {
                int pr = 0;
                for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[mode][i][j] * pv[j];
                int v = pr >= 0 ? round2(pr, 4) : -round2(-pr, 4);
                p.px<pixel>(y + (i2 << 1) + (i >> 2))[x + (j4 << 2) + (i & 3)] =
                    (pixel)clip3(0, maxv, v);
            }
        }
}

// An intra block copy's prediction (7.11.3.3-4): the current frame, before
// any loop filter, read at the block's vector through the bilinear
// filter (a whole-sample vector is a copy; subsampled chroma may land
// half way), with the specification's rounding (InterRound0 and
// InterRound1: 3 and 11, or 5 and 9 at 12 bits).
template <typename pixel>
void predict_intrabc_t(Decoder& d, int plane, int x, int y, int w, int h, const int16_t* mv) {
    const SequenceHeader& s = d.seq;
    const int round0 = bit_depth<pixel>(d) == 12 ? 5 : 3, round1 = 14 - round0;
    const int maxv = pixel_max<pixel>(d);
    int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
    auto start = [](int pos, int v, int sub) {
        int64_t orig = ((int64_t)pos << 4) + ((2 * v) >> sub) + 8;
        int64_t base = orig * 16384 - ((int64_t)8 << 14);
        int64_t r = base >= 0 ? round2l(base, 8) : -round2l(-base, 8);
        return (int)(r + 32);
    };
    int start_x = start(x, mv[1], sx), start_y = start(y, mv[0], sy);
    // dav1d clamps a copy's reads to the frame's 8x8-aligned size (its
    // bw and bh), not to the visible one as 7.11.3.3 writes it.
    int last_x = ((d.mi_cols * 4) >> sx) - 1;
    int last_y = ((d.mi_rows * 4) >> sy) - 1;
    Plane& p = d.cur[plane];
    static thread_local int inter[(128 + 8) * 128];
    static thread_local pixel pred[128 * 128];
    int ih = h + 7;
    for (int r = 0; r < ih; r++) {
        const pixel* src = p.px<pixel>(clip3(0, last_y, (start_y >> 10) + r - 3));
        for (int c = 0; c < w; c++) {
            int pos = start_x + 1024 * c, k = (pos >> 6) & 15;
            int x0 = (pos >> 10);
            int a = src[clip3(0, last_x, x0)], b = src[clip3(0, last_x, x0 + 1)];
            inter[r * w + c] = round2((128 - 8 * k) * a + 8 * k * b, round0);
        }
    }
    for (int r = 0; r < h; r++) {
        int pos = (start_y & 1023) + 1024 * r, k = (pos >> 6) & 15, r0 = (pos >> 10) + 3;
        for (int c = 0; c < w; c++) {
            int v = (128 - 8 * k) * inter[r0 * w + c] + 8 * k * inter[(r0 + 1) * w + c];
            pred[r * w + c] = (pixel)clip3(0, maxv, round2(v, round1));
        }
    }
    for (int r = 0; r < h; r++)
        std::memcpy(p.px<pixel>(y + r) + x, pred + r * w, w * sizeof(pixel));
}

template <typename pixel>
void predict_cfl_t(Decoder& d, int plane, int x, int y, int tx, int alpha, int max_luma_w,
                   int max_luma_h) {
    const int maxv = pixel_max<pixel>(d);
    const SequenceHeader& s = d.seq;
    int w = kTxW[tx], h = kTxH[tx], sx = s.subsampling_x, sy = s.subsampling_y;
    static thread_local int lum[64 * 64];
    int sum = 0;
    const Plane& luma = d.cur[0];
    for (int i = 0; i < h; i++) {
        int ly = std::min((y << sy) + (i << sy), max_luma_h - (1 << sy));
        for (int j = 0; j < w; j++) {
            int lx = std::min((x << sx) + (j << sx), max_luma_w - (1 << sx));
            int t = 0;
            for (int dy = 0; dy <= sy; dy++)
                for (int dx = 0; dx <= sx; dx++) t += luma.px<pixel>(ly + dy)[lx + dx];
            int v = t << (3 - sx - sy);
            lum[i * w + j] = v;
            sum += v;
        }
    }
    int avg = round2(sum, kTxWLog2[tx] + kTxHLog2[tx]);
    Plane& p = d.cur[plane];
    for (int i = 0; i < h; i++) {
        pixel* out = p.px<pixel>(y + i) + x;
        for (int j = 0; j < w; j++) {
            int v = alpha * (lum[i * w + j] - avg);
            int scaled = v >= 0 ? round2(v, 6) : -round2(-v, 6);
            out[j] = (pixel)clip3(0, maxv, out[j] + scaled);
        }
    }
}

}  // namespace

void predict_intra(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                   int have_ar, int have_bl, int mode, int log2w, int log2h, const BlockInfo& b,
                   int avail_u, int avail_l, int mi_row, int mi_col) {
    (d.seq.bit_depth > 8 ? predict_intra_t<uint16_t> : predict_intra_t<uint8_t>)(
        d, plane, x, y, have_left, have_above, have_ar, have_bl, mode, log2w, log2h, b, avail_u,
        avail_l, mi_row, mi_col);
}

void predict_filter_intra(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                          int have_ar, int have_bl, int log2w, int log2h, int mode) {
    (d.seq.bit_depth > 8 ? predict_filter_intra_t<uint16_t> : predict_filter_intra_t<uint8_t>)(
        d, plane, x, y, have_left, have_above, have_ar, have_bl, log2w, log2h, mode);
}

void predict_intrabc(Decoder& d, int plane, int x, int y, int w, int h, const int16_t* mv) {
    (d.seq.bit_depth > 8 ? predict_intrabc_t<uint16_t> : predict_intrabc_t<uint8_t>)(
        d, plane, x, y, w, h, mv);
}

void predict_cfl(Decoder& d, int plane, int x, int y, int tx, int alpha, int max_luma_w,
                 int max_luma_h) {
    (d.seq.bit_depth > 8 ? predict_cfl_t<uint16_t> : predict_cfl_t<uint8_t>)(
        d, plane, x, y, tx, alpha, max_luma_w, max_luma_h);
}

}  // namespace av1
