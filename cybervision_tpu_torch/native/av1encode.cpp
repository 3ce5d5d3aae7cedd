// An 8-bit AV1 key-frame encoder for one AVIF item: 4:2:0 colour, or a
// monochrome alpha plane. Around the tiles it writes what libavif 1.3 with
// aom 3.12 writes for a still image at Pillow's defaults (quality 75:
// base_q_idx 64): a temporal delimiter, aom's reduced still-picture
// sequence header and one frame OBU, tiled as libavif's autotiling tiles
// at 8 threads. The choices inside the tiles are the encoder's own (aom's
// speed-6 search is not followed): square partitions from 64x64 down to
// 8x8, one transform per plane and block; the intra mode with its angle
// delta, the luma transform type (DCT, ADST, identity, 1-D) and the
// chroma mode (with chroma from luma) picked by a rate-distortion search,
// SSE plus lambda times the bits counted from the live CDFs; on an alpha
// plane, palette blocks, so that 0/255 alpha comes back exactly. Each
// block is coded through the decoder's own prediction and reconstruction
// (av1recon.cpp), so the encoder's picture is the decoder's by
// construction. The search is in integers and the forward transform in
// floats without contraction (see the Makefile), and each tile runs on a
// thread of its own with nothing shared: the bytes are one function of the
// planes on any machine.

#include <thread>
#include <tuple>

#include "av1.h"

#include "av1tables.h"

namespace av1 {

namespace {

// -- bit costs: -log2(p / 32768) in 1/1024 bit, by integer squaring -----------

constexpr int kBit = 1024;
// The search's lambda, SSE per bit x16. The rate is set mostly by the
// quantiser's dead zone (quantize_reconstruct): 1.5x or 2x this lambda
// moves the test maps' bytes by under 1 %.
constexpr int64_t kLambda16 = 16 * 20;

struct CostTable {
    int32_t c[32769];
    CostTable() {
        c[0] = 16 * kBit;
        for (uint32_t p = 1; p <= 32768; p++) {
            int e = floor_log2(p);
            uint64_t m = ((uint64_t)p << 30) >> e;  // [2^30, 2^31): the mantissa in Q30
            int frac = 0;
            for (int i = 0; i < 10; i++) {
                m = (m * m) >> 30;
                frac <<= 1;
                if (m >= ((uint64_t)2 << 30)) {
                    m >>= 1;
                    frac |= 1;
                }
            }
            c[p] = (15 - e) * kBit - frac;
        }
    }
};
const CostTable& costs() {
    static const CostTable t;
    return t;
}
inline int sym_cost(const uint16_t* icdf, int n, int s) {
    int hi = s ? icdf[s - 1] : 32768, lo = s < n - 1 ? icdf[s] : 0;
    return costs().c[std::max(1, hi - lo)];
}

// -- the symbol encoder (libaom's od_ec_enc: the inverse of av1entropy.cpp's
// decoder) -------------------------------------------------------------------

struct SymbolWriter {
    std::vector<uint16_t> pre;  // bytes before carry propagation
    uint32_t low = 0, rng = 0x8000;
    int cnt = -9;

    void normalize(uint32_t l, uint32_t r) {
        int d = 15 - floor_log2(r), c = cnt, s = c + d;
        if (s >= 0) {
            c += 16;
            uint32_t m = (1u << c) - 1;
            if (s >= 8) {
                pre.push_back((uint16_t)(l >> c));
                l &= m;
                c -= 8;
                m >>= 8;
            }
            pre.push_back((uint16_t)(l >> c));
            s = c + d - 24;
            l &= m;
        }
        low = l << d;
        rng = r << d;
        cnt = s;
    }
    void encode(int s, const uint16_t* icdf, int n) {
        uint32_t l = low, r = rng;
        int last = n - 1;
        uint32_t fl = s > 0 ? icdf[s - 1] : 32768, fh = icdf[s];
        if (fl < 32768) {
            uint32_t u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (last - (s - 1));
            uint32_t v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (last - s);
            l += r - u;
            r = u - v;
        } else {
            r -= ((r >> 8) * (fh >> 6) >> 1) + 4 * (last - s);
        }
        normalize(l, r);
    }
    void bit(int val) {  // p = 1/2
        uint32_t l = low, r = rng;
        uint32_t v = ((r >> 8) * (16384u >> 6) >> 1) + 4;
        if (val) l += r - v;
        normalize(l, val ? v : r - v);
    }
    std::vector<uint8_t> finish() {
        uint32_t l = low, m = 0x3FFF, e = ((l + m) & ~m) | (m + 1);
        int c = cnt, s = 10 + c;
        std::vector<uint16_t> buf = pre;
        if (s > 0) {
            uint32_t n = (1u << (c + 16)) - 1;
            do {
                buf.push_back((uint16_t)(e >> (c + 16)));
                e &= n;
                s -= 8;
                c -= 8;
                n >>= 8;
            } while (s > 0);
        }
        std::vector<uint8_t> out(buf.size());
        uint32_t carry = 0;
        for (size_t i = buf.size(); i-- > 0;) {
            carry += buf[i];
            out[i] = (uint8_t)carry;
            carry >>= 8;
        }
        return out;
    }
};

// Where a tile's syntax goes: counted (the search) or written (the tile's
// bytes, with the CDFs adapted as the decoder adapts them).
struct CostSink {
    int64_t bits = 0;
    void symbol(uint16_t* cdf, int n, int s) { bits += sym_cost(cdf, n, s); }
    void fixed(const uint16_t* cdf, int s) { bits += sym_cost(cdf, 2, s); }
    void literal(int n, int) { bits += (int64_t)n * kBit; }
};
struct WriteSink {
    SymbolWriter w;
    void symbol(uint16_t* cdf, int n, int s) {
        w.encode(s, cdf, n);
        adapt_cdf(cdf, n, s);
    }
    void fixed(const uint16_t* cdf, int s) { w.encode(s, cdf, 2); }
    void literal(int n, int v) {
        for (int i = n - 1; i >= 0; i--) w.bit((v >> i) & 1);
    }
};
template <class S>
void write_ns(S& s, int n, int v) {
    int w = floor_log2(n) + 1, m = (1 << w) - n;
    if (v < m) {
        s.literal(w - 1, v);
    } else {
        s.literal(w - 1, (v + m) >> 1);
        s.literal(1, (v + m) & 1);
    }
}

// -- the forward transforms: each 1-D kind's basis taken from the decoder's
// inverse (av1recon.cpp), normalised row by row -------------------------------

struct Bases {
    // f[kind][log2n][i * n + k]: coefficient k's weight of sample i;
    // norm[kind][log2n][k]: the energy of coefficient k's basis function.
    std::vector<float> f[3][7], norm[3][7];
    Bases() {
        for (int kind = 0; kind < 3; kind++)
            for (int lg = 2; lg <= 6; lg++) {
                if ((kind == 1 && lg > 4) || (kind == 2 && lg > 5)) continue;
                int n = 1 << lg;
                std::vector<float>& m = f[kind][lg];
                m.assign((size_t)n * n, 0.f);
                norm[kind][lg].assign(n, 0.f);
                for (int k = 0; k < n; k++) {
                    int32_t T[64] = {0};
                    T[k] = 1 << 12;
                    inverse_transform_1d(kind, lg, T);
                    double e = 0;
                    for (int i = 0; i < n; i++) e += (double)T[i] * T[i];
                    for (int i = 0; i < n; i++) m[(size_t)i * n + k] = (float)(T[i] * 4096.0 / e);
                    norm[kind][lg][k] = (float)(e / (4096.0 * 4096.0));
                }
            }
    }
};
const Bases& bases() {
    static const Bases b;
    return b;
}

// The coefficients (the decoder's dequantised values, before the >> of
// the 32- and 64-sample sizes) of an h x w residual, min(h, 32) rows of
// min(w, 32).
void forward_transform(const int16_t* res, int tx, int tx_type, float* out) {
    int lw = kTxWLog2[tx], lh = kTxHLog2[tx], w = 1 << lw, h = 1 << lh;
    int tw = std::min(w, 32), th = std::min(h, 32);
    int flip_ud = tx_type == FLIPADST_DCT || tx_type == FLIPADST_ADST ||
                  tx_type == V_FLIPADST || tx_type == FLIPADST_FLIPADST;
    int flip_lr = tx_type == DCT_FLIPADST || tx_type == ADST_FLIPADST ||
                  tx_type == H_FLIPADST || tx_type == FLIPADST_FLIPADST;
    const float* fh = bases().f[kHorzKind[tx_type]][lw].data();
    const float* fv = bases().f[kVertKind[tx_type]][lh].data();
    static thread_local float tmp[64 * 32];
    for (int i = 0; i < h; i++) {
        const int16_t* r = res + (size_t)(flip_ud ? h - 1 - i : i) * w;
        float* t = tmp + i * tw;
        for (int k = 0; k < tw; k++) t[k] = 0;
        for (int j = 0; j < w; j++) {
            float v = r[flip_lr ? w - 1 - j : j];
            if (v == 0) continue;
            const float* bj = fh + (size_t)j * w;
            for (int k = 0; k < tw; k++) t[k] += v * bj[k];
        }
    }
    float gain = (float)(1 << (kTransformRowShift[tx] + 4));
    if (std::abs(lw - lh) == 1) gain = gain * 4096.f / 2896.f;
    for (int k = 0; k < th * tw; k++) out[k] = 0;
    for (int i = 0; i < h; i++) {
        const float* bi = fv + (size_t)i * h;
        const float* t = tmp + i * tw;
        for (int k = 0; k < th; k++) {
            float c = bi[k];
            float* o = out + k * tw;
            for (int j = 0; j < tw; j++) o[j] += c * t[j];
        }
    }
    for (int k = 0; k < th * tw; k++) out[k] *= gain;
}

// The pixel-domain energy of a unit coefficient at (row a, column b) of
// the decoder's inverse (before its rounding): the two 1-D basis energies
// and the inverse's scaling.
float coef_energy(int tx, int tx_type, int a, int b) {
    int lw = kTxWLog2[tx], lh = kTxHLog2[tx];
    float g = 1.f / (float)(1 << (kTransformRowShift[tx] + 4));
    if (std::abs(lw - lh) == 1) g = g * 2896.f / 4096.f;
    return bases().norm[kVertKind[tx_type]][lh][a] * bases().norm[kHorzKind[tx_type]][lw][b] * g * g;
}

// The scan index of each position, per size and class.
struct InvScans {
    std::vector<int16_t> def[TX_SIZES_ALL], row[TX_SIZES_ALL], col[TX_SIZES_ALL];
    InvScans() {
        const Scans& s = scans();
        for (int t = 0; t < TX_SIZES_ALL; t++) {
            auto inv = [](const std::vector<int16_t>& v, std::vector<int16_t>& o) {
                o.assign(v.size(), 0);
                for (size_t i = 0; i < v.size(); i++) o[v[i]] = (int16_t)i;
            };
            inv(s.def[t], def[t]);
            inv(s.row[t], row[t]);
            inv(s.col[t], col[t]);
        }
    }
};
const InvScans& inv_scans() {
    static const InvScans s;
    return s;
}
const int16_t* scan_of(int tx, int tx_type, bool inverse) {
    int cls = tx_class(tx_type);
    bool def = tx == TX_16X64 || tx == TX_64X16 || kTxSizeSqrUp[tx] == TX_64X64 || tx_type == IDTX ||
               cls == TX_CLASS_2D;
    if (inverse) {
        const InvScans& s = inv_scans();
        return def ? s.def[tx].data() : cls == TX_CLASS_VERT ? s.row[tx].data() : s.col[tx].data();
    }
    const Scans& s = scans();
    return def ? s.def[tx].data() : cls == TX_CLASS_VERT ? s.row[tx].data() : s.col[tx].data();
}

uint8_t kIntraSet1Index[16], kIntraSet2Index[16];
struct TxSetIndex {
    TxSetIndex() {
        for (int i = 0; i < 7; i++) kIntraSet1Index[kTxTypeIntraInvSet1[i]] = (uint8_t)i;
        for (int i = 0; i < 5; i++) kIntraSet2Index[kTxTypeIntraInvSet2[i]] = (uint8_t)i;
    }
} g_tx_set_index;

bool directional(int m) { return m >= V_PRED && m <= D67_PRED; }

// -- a block's choices ----------------------------------------------------------

struct Decision {
    uint8_t bsize = BLOCK_8X8, y_mode = DC_PRED, uv_mode = DC_PRED, tx_type = DCT_DCT;
    int8_t angle_y = 0, cfl_u = 0, cfl_v = 0;  // chroma takes no angle delta
    uint8_t pal_n = 0;
    uint16_t pal[8] = {0};
};

struct Node {  // a partition tree node: NONE (a block) or SPLIT
    int split = 0;
    Decision dec;
    int child[4] = {-1, -1, -1, -1};
};

// The frame being encoded: its decoder state, the padded source planes and
// the search's settings.
struct Frame {
    Decoder d;
    std::vector<uint8_t> src[3];
    int src_stride[3] = {0, 0, 0};
    const uint8_t* src_row(int p, int y) const { return src[p].data() + (size_t)y * src_stride[p]; }
};

// One tile's encoder: the decoder's Tile (av1entropy.cpp) with each read
// turned into a write, and a search that picks what is written.
struct EncTile {
    Decoder& d;
    const SequenceHeader& s;
    const FrameHeader& f;
    const Frame& fr;
    Cdfs c;
    int row_start, row_end, col_start, col_end;
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    uint8_t block_decoded[3][34][34];
    // The block being coded.
    BlockInfo b;
    int mi_row = 0, mi_col = 0, bw4 = 0, bh4 = 0, has_chroma = 0, avail_u = 0, avail_l = 0;
    int avail_u_chroma = 0, avail_l_chroma = 0, max_luma_w = 0, max_luma_h = 0;
    uint8_t color_map[64 * 64];
    int32_t quant[3][1024];
    int eob[3];
    WriteSink out;

    EncTile(Decoder& dec, const Frame& frame, int tr, int tc);
    bool inside(int r, int col) const {
        return col >= col_start && col < col_end && r >= row_start && r < row_end;
    }
    const BlockInfo& at(int r, int col) const { return d.bi(r, col); }
    uint8_t& decoded(int plane, int y, int x) { return block_decoded[plane][y + 1][x + 1]; }

    void clear_block_decoded(int r, int col, int sb4) {
        for (int p = 0; p < s.num_planes; p++) {
            int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
            int w4 = (col_end - col) >> sx, h4 = (row_end - r) >> sy;
            for (int y = -1; y <= (sb4 >> sy); y++)
                for (int x = -1; x <= (sb4 >> sx); x++) {
                    uint8_t v = 0;
                    if (y < 0 && x < w4) v = 1;
                    else if (x < 0 && y < h4) v = 1;
                    decoded(p, y, x) = v;
                }
            decoded(p, sb4 >> sy, -1) = 0;
        }
    }

    std::vector<uint8_t> run();
    void encode_superblock(int r, int col);

    // -- partitions --
    template <class S>
    void code_partition(S& sink, int r, int col, int bsize, int partition) {
        if (bsize < BLOCK_8X8) return;
        int n4 = kNum4x4W[bsize], half = n4 >> 1;
        int has_rows = (r + half) < d.mi_rows, has_cols = (col + half) < d.mi_cols;
        int bsl = kMiWidthLog2[bsize];
        int au = inside(r - 1, col), al = inside(r, col - 1);
        int above = au && kMiWidthLog2[at(r - 1, col).mi_size] < bsl;
        int left = al && kMiHeightLog2[at(r, col - 1).mi_size] < bsl;
        int ctx = left * 2 + above, nsym;
        uint16_t* cdf;
        switch (bsl) {
            case 1: cdf = c.partition_w8[ctx]; nsym = 4; break;
            case 2: cdf = c.partition_w16[ctx]; nsym = 10; break;
            case 3: cdf = c.partition_w32[ctx]; nsym = 10; break;
            case 4: cdf = c.partition_w64[ctx]; nsym = 10; break;
            default: cdf = c.partition_w128[ctx]; nsym = 8; break;
        }
        if (has_rows && has_cols) {
            sink.symbol(cdf, nsym, partition);
        } else if (has_cols || has_rows) {  // only a split is chosen here
            uint16_t bcdf[3] = {(uint16_t)split_psum(cdf, bsize, has_cols), 0, 0};
            sink.fixed(bcdf, 1);
        }
    }

    // -- the block's position and neighbours (decode_block) --
    void begin_block(int r, int col, const Decision& dec) {
        mi_row = r;
        mi_col = col;
        b = BlockInfo();
        b.mi_size = dec.bsize;
        b.y_mode = dec.y_mode;
        b.uv_mode = dec.uv_mode;
        b.angle_delta_y = dec.angle_y;
        b.cfl_alpha_u = dec.cfl_u;
        b.cfl_alpha_v = dec.cfl_v;
        b.palette_size[0] = dec.pal_n;
        for (int i = 0; i < dec.pal_n; i++) b.palette_colors[0][i] = dec.pal[i];
        b.tx_size = kMaxTxSizeRect[dec.bsize];
        bw4 = kNum4x4W[dec.bsize];
        bh4 = kNum4x4H[dec.bsize];
        has_chroma = s.num_planes > 1;  // blocks are 8x8 or larger
        avail_u = inside(r - 1, col);
        avail_l = inside(r, col - 1);
        avail_u_chroma = has_chroma ? avail_u : 0;
        avail_l_chroma = has_chroma ? avail_l : 0;
    }
    // A palette block's colour indices: the nearest colour of each source
    // sample within the mi grid, copied beyond it as the decoder copies.
    void build_color_map() {
        int n = b.palette_size[0], bw = bw4 * 4, bh = bh4 * 4;
        int onh = std::min(bh, (d.mi_rows - mi_row) * 4), onw = std::min(bw, (d.mi_cols - mi_col) * 4);
        for (int i = 0; i < onh; i++) {
            const uint8_t* o = fr.src_row(0, mi_row * 4 + i) + mi_col * 4;
            for (int j = 0; j < onw; j++) {
                int best = 0;
                for (int k = 1; k < n; k++)
                    if (std::abs(o[j] - b.palette_colors[0][k]) < std::abs(o[j] - b.palette_colors[0][best]))
                        best = k;
                color_map[i * bw + j] = (uint8_t)best;
            }
            for (int j = onw; j < bw; j++) color_map[i * bw + j] = color_map[i * bw + onw - 1];
        }
        for (int i = onh; i < bh; i++)
            for (int j = 0; j < bw; j++) color_map[i * bw + j] = color_map[(onh - 1) * bw + j];
    }
    // Store the block where its neighbours and the filters find it.
    void store_block() {
        int idx = (int)d.blocks.size();
        d.blocks.push_back(b);
        int rows = std::min(bh4, d.mi_rows - mi_row), cols = std::min(bw4, d.mi_cols - mi_col);
        for (int y = 0; y < rows; y++)
            for (int x = 0; x < cols; x++) {
                size_t at = (size_t)(mi_row + y) * d.mi_cols + mi_col + x;
                d.mi_block[at] = idx;
                d.inter_tx_size[at] = b.tx_size;
            }
    }

    int plane_tx(int plane) const {
        if (plane == 0) return b.tx_size;
        int uv = kMaxTxSizeRect[block_size(std::max(4, bw4 * 2), std::max(4, bh4 * 2))];
        if (kTxW[uv] == 64 || kTxH[uv] == 64) return TX_32X32;
        return uv;
    }

    // -- prediction of a plane's (single) transform block, as transform_block --
    void predict(int plane, int mode_override = -1) {
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int tx = plane_tx(plane);
        int x = (mi_col >> sx) * 4, y = (mi_row >> sy) * 4;
        int sb_mask = s.use_128x128 ? 31 : 15;
        int sub_row = mi_row & sb_mask, sub_col = mi_col & sb_mask;
        int step_x = kTxW[tx] >> 2, step_y = kTxH[tx] >> 2;
        if (plane == 0 && b.palette_size[0]) {
            int w = kTxW[tx], h = kTxH[tx], bw = bw4 * 4;
            Plane& pl = d.cur[0];
            for (int i = 0; i < h; i++) {
                uint8_t* o = pl.row(y + i) + x;
                for (int j = 0; j < w; j++) o[j] = (uint8_t)b.palette_colors[0][color_map[i * bw + j]];
            }
            return;
        }
        int is_cfl = plane > 0 && b.uv_mode == UV_CFL_PRED;
        int mode = mode_override >= 0 ? mode_override
                   : plane == 0       ? b.y_mode
                   : is_cfl           ? DC_PRED
                                      : b.uv_mode;
        int have_left = plane == 0 ? avail_l : avail_l_chroma;
        int have_above = plane == 0 ? avail_u : avail_u_chroma;
        int have_ar = decoded(plane, (sub_row >> sy) - 1, (sub_col >> sx) + step_x);
        int have_bl = decoded(plane, (sub_row >> sy) + step_y, (sub_col >> sx) - 1);
        predict_intra(d, plane, x, y, have_left, have_above, have_ar, have_bl, mode, kTxWLog2[tx],
                      kTxHLog2[tx], b, plane == 0 ? avail_u : avail_u_chroma,
                      plane == 0 ? avail_l : avail_l_chroma, mi_row, mi_col);
        if (is_cfl && mode_override < 0)
            predict_cfl(d, plane, x, y, tx, plane == 1 ? b.cfl_alpha_u : b.cfl_alpha_v, max_luma_w,
                        max_luma_h);
    }

    // The residual, quantised coefficients and reconstruction of a plane's
    // transform block on its prediction in d.cur; the SSE within the mi grid.
    int64_t quantize_reconstruct(int plane, int tx_type, int32_t* q, int& eob_out,
                                 bool estimate = false);
    int64_t sse(int plane) const;
    void luma_extent() {
        int tx = b.tx_size;
        max_luma_w = mi_col * 4 + kTxW[tx];
        max_luma_h = mi_row * 4 + kTxH[tx];
    }

    // -- mode info (intra_frame_mode_info) --
    template <class S>
    [[gnu::noinline]] void code_palette_colors(S& sink) {
        int n = b.palette_size[0];
        const uint16_t* col = b.palette_colors[0];
        uint16_t cache[16];
        int cn = av1::palette_cache(d, mi_row, mi_col, avail_u, avail_l, 0, cache), idx = 0;
        bool used[8] = {false};
        for (int i = 0; i < cn && idx < n; i++) {
            int hit = -1;
            for (int k = 0; k < n; k++)
                if (!used[k] && col[k] == cache[i]) hit = k;
            sink.literal(1, hit >= 0);
            if (hit >= 0) {
                used[hit] = true;
                idx++;
            }
        }
        int rem[8], m = 0;
        for (int k = 0; k < n; k++)
            if (!used[k]) rem[m++] = col[k];
        if (m == 0) return;
        sink.literal(8, rem[0]);
        if (m == 1) return;
        int need = 0;
        for (int k = 1; k < m; k++) need = std::max(need, rem[k] - rem[k - 1] - 1);
        int need_bits = need ? floor_log2(need) + 1 : 0;
        int extra = clip3(0, 3, need_bits - 5), bits = 5 + extra;
        sink.literal(2, extra);
        for (int k = 1; k < m; k++) {
            sink.literal(bits, rem[k] - rem[k - 1] - 1);
            bits = std::min(bits, ceil_log2(255 - rem[k]));
        }
    }
    template <class S>
    [[gnu::noinline]] void code_mode_info(S& sink) {
        int r = mi_row, col = mi_col;
        int ctx = (avail_u ? at(r - 1, col).skip : 0) + (avail_l ? at(r, col - 1).skip : 0);
        sink.symbol(c.skip[ctx], 2, b.skip);
        int above = kIntraModeContext[avail_u ? at(r - 1, col).y_mode : DC_PRED];
        int left = kIntraModeContext[avail_l ? at(r, col - 1).y_mode : DC_PRED];
        sink.symbol(c.kf_y_mode[above][left], 13, b.y_mode);
        if (directional(b.y_mode))
            sink.symbol(c.angle_delta[b.y_mode - V_PRED], 7, b.angle_delta_y + 3);
        if (has_chroma) {
            if (std::max(bw4, bh4) * 4 <= 32) sink.symbol(c.uv_mode_cfl[b.y_mode], 14, b.uv_mode);
            else sink.symbol(c.uv_mode_no_cfl[b.y_mode], 13, b.uv_mode);
            if (b.uv_mode == UV_CFL_PRED) {
                int au = b.cfl_alpha_u, av = b.cfl_alpha_v;
                int su = au == 0 ? 0 : au < 0 ? 1 : 2, sv = av == 0 ? 0 : av < 0 ? 1 : 2;
                sink.symbol(c.cfl_sign, 8, su * 3 + sv - 1);
                if (su) sink.symbol(c.cfl_alpha[(su - 1) * 3 + sv], 16, std::abs(au) - 1);
                if (sv) sink.symbol(c.cfl_alpha[(sv - 1) * 3 + su], 16, std::abs(av) - 1);
            }
            if (directional(b.uv_mode))
                sink.symbol(c.angle_delta[b.uv_mode - V_PRED], 7, b.angle_delta_uv + 3);
        }
        if (bw4 <= 16 && bh4 <= 16 && f.allow_screen_content_tools && b.y_mode == DC_PRED) {
            // A monochrome plane: no chroma palette.
            int bsize_ctx = kMiWidthLog2[b.mi_size] + kMiHeightLog2[b.mi_size] - 2;
            int pctx = (avail_u && at(r - 1, col).palette_size[0] > 0) +
                       (avail_l && at(r, col - 1).palette_size[0] > 0);
            sink.symbol(c.palette_y_mode[bsize_ctx][pctx], 2, b.palette_size[0] > 0);
            if (b.palette_size[0]) {
                sink.symbol(c.palette_y_size[bsize_ctx], 7, b.palette_size[0] - 2);
                code_palette_colors(sink);
            }
        }
        if (s.enable_filter_intra && b.y_mode == DC_PRED && b.palette_size[0] == 0 &&
            std::max(bw4, bh4) <= 8)
            sink.symbol(c.use_filter_intra[b.mi_size], 2, 0);
    }
    template <class S>
    [[gnu::noinline]] void code_color_map(S& sink) {
        int n = b.palette_size[0], bw = bw4 * 4;
        int onh = std::min(bh4 * 4, (d.mi_rows - mi_row) * 4), onw = std::min(bw, (d.mi_cols - mi_col) * 4);
        const uint8_t* map = color_map;
        write_ns(sink, n, map[0]);
        uint16_t(*cdfs)[9] = c.palette_y_color[n - 2];
        for (int i = 1; i < onh + onw - 1; i++) {
            for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
                int r = i - j, order[8];
                int ctx = palette_color_context(map, bw, r, j, n, order);
                int v = map[r * bw + j], k = 0;
                while (order[k] != v) k++;
                sink.symbol(cdfs[ctx], n, k);
            }
        }
    }

    // -- coefficients (coeffs) --
    int all_zero_ctx(int plane, int x4, int y4, int tx) {
        int w4 = kTxW[tx] >> 2, h4 = kTxH[tx] >> 2;
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int max_x4 = d.mi_cols >> sx, max_y4 = d.mi_rows >> sy;
        int pw4 = std::max(1, bw4 >> sx), ph4 = std::max(1, bh4 >> sy);
        if (plane == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++)
                if (x4 + k < max_x4) top = std::max<int>(top, above_level[0][x4 + k]);
            for (int k = 0; k < h4; k++)
                if (y4 + k < max_y4) left = std::max<int>(left, left_level[0][y4 + k]);
            if (pw4 * 4 == kTxW[tx] && ph4 * 4 == kTxH[tx]) return 0;
            if (top == 0 && left == 0) return 1;
            if (top == 0 || left == 0) return 2 + (std::max(top, left) > 3);
            if (std::max(top, left) <= 3) return 4;
            if (std::min(top, left) <= 3) return 5;
            return 6;
        }
        int above = 0, left = 0;
        for (int i = 0; i < w4; i++)
            if (x4 + i < max_x4) above |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
        for (int i = 0; i < h4; i++)
            if (y4 + i < max_y4) left |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
        int ctx = (above != 0) + (left != 0) + 7;
        if (pw4 * ph4 * 16 > kTxW[tx] * kTxH[tx]) ctx += 3;
        return ctx;
    }
    int dc_sign_ctx(int plane, int x4, int y4, int tx) {
        int w4 = kTxW[tx] >> 2, h4 = kTxH[tx] >> 2;
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int max_x4 = d.mi_cols >> sx, max_y4 = d.mi_rows >> sy, dc = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < max_x4) {
                int sgn = above_dc[plane][x4 + k];
                dc += sgn == 1 ? -1 : sgn == 2 ? 1 : 0;
            }
        for (int k = 0; k < h4; k++)
            if (y4 + k < max_y4) {
                int sgn = left_dc[plane][y4 + k];
                dc += sgn == 1 ? -1 : sgn == 2 ? 1 : 0;
            }
        return dc < 0 ? 1 : dc > 0 ? 2 : 0;
    }
    // The symbols of one transform block's coefficients q (eob of them in
    // scan order) and tx_type (luma); with update, the contexts after it.
    // Out of line, as the other coders below: each is called from several
    // places with each sink, so each is compiled once a sink.
    template <class S>
    [[gnu::noinline]] void code_coeffs(S& sink, int plane, int tx, int tx_type, const int32_t* q, int eob,
                     bool update) {
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int x4 = mi_col >> sx, y4 = mi_row >> sy;
        int w4 = kTxW[tx] >> 2, h4 = kTxH[tx] >> 2;
        int tx_sz_ctx = (kTxSizeSqr[tx] + kTxSizeSqrUp[tx] + 1) >> 1;
        int ptype = plane > 0;
        sink.symbol(c.txb_skip[tx_sz_ctx][all_zero_ctx(plane, x4, y4, tx)], 2, eob == 0);
        int cul_level = 0, dc_category = 0;
        if (eob > 0) {
            if (plane == 0 && kTxSizeSqrUp[tx] <= TX_16X16) {
                int sqr = kTxSizeSqr[tx];
                if (kTxSizeSqr[tx] == TX_16X16 || f.reduced_tx_set)
                    sink.symbol(c.intra_tx_set2[sqr][b.y_mode], 5, kIntraSet2Index[tx_type]);
                else
                    sink.symbol(c.intra_tx_set1[sqr][b.y_mode], 7, kIntraSet1Index[tx_type]);
            }
            int cls = tx_class(tx_type);
            const int16_t* scan = scan_of(tx, tx_type, false);
            int eob_multisize = std::min<int>(kTxWLog2[tx], 5) + std::min<int>(kTxHLog2[tx], 5) - 4;
            int ectx = cls == TX_CLASS_2D ? 0 : 1;
            int eob_pt = eob <= 2 ? eob : floor_log2(eob - 1) + 2;
            switch (eob_multisize) {
                case 0: sink.symbol(c.eob_pt16[ptype][ectx], 5, eob_pt - 1); break;
                case 1: sink.symbol(c.eob_pt32[ptype][ectx], 6, eob_pt - 1); break;
                case 2: sink.symbol(c.eob_pt64[ptype][ectx], 7, eob_pt - 1); break;
                case 3: sink.symbol(c.eob_pt128[ptype][ectx], 8, eob_pt - 1); break;
                case 4: sink.symbol(c.eob_pt256[ptype][ectx], 9, eob_pt - 1); break;
                case 5: sink.symbol(c.eob_pt512[ptype], 10, eob_pt - 1); break;
                default: sink.symbol(c.eob_pt1024[ptype], 11, eob_pt - 1); break;
            }
            if (eob_pt >= 3) {
                int offset = eob - ((1 << (eob_pt - 2)) + 1);
                int shift = eob_pt - 3;
                sink.symbol(c.eob_extra[tx_sz_ctx][ptype][eob_pt - 3], 2, (offset >> shift) & 1);
                for (int i = 1; i < eob_pt - 2; i++) sink.literal(1, (offset >> (shift - i)) & 1);
            }
            int adj = kAdjustedTx[tx];
            int bwl = kTxWLog2[adj], txw = kTxW[adj], txh = kTxH[adj];
            const uint8_t(*offsets)[5] =
                kCoeffBaseCtxOffset[kTxW[tx] == kTxH[tx] ? 0 : kTxW[tx] > kTxH[tx] ? 1 : 2];
            int br_tx = std::min(tx_sz_ctx, (int)TX_32X32);
            static thread_local int32_t lev[1024];
            std::memset(lev, 0, sizeof(int32_t) * txw * txh);
            for (int ci = eob - 1; ci >= 0; ci--) {
                int pos = scan[ci];
                int row = pos >> bwl, col = pos - (row << bwl);
                int a = std::min(std::abs(q[pos]), 15);
                if (ci == eob - 1) {
                    int bctx = ci == 0 ? 0 : ci <= (txh << bwl) / 8 ? 1 : ci <= (txh << bwl) / 4 ? 2 : 3;
                    sink.symbol(c.coeff_base_eob[tx_sz_ctx][ptype][bctx], 3, std::min(a, 3) - 1);
                } else {
                    int mag = 0;
                    for (int k = 0; k < 5; k++) {
                        int rr = row + kSigRefDiffOffset[cls][k][0], cc = col + kSigRefDiffOffset[cls][k][1];
                        if (rr < txh && cc < txw) mag += std::min(lev[(rr << bwl) + cc], 3);
                    }
                    int bctx = std::min((mag + 1) >> 1, 4);
                    if (cls == TX_CLASS_2D) {
                        if (row == 0 && col == 0) bctx = 0;
                        else bctx += offsets[std::min(row, 4)][std::min(col, 4)];
                    } else {
                        int idx = cls == TX_CLASS_VERT ? row : col;
                        bctx += 26 + 5 * std::min(idx, 2);
                    }
                    sink.symbol(c.coeff_base[tx_sz_ctx][ptype][bctx], 4, std::min(a, 3));
                }
                if (a > 2) {
                    int mag = 0;
                    for (int k = 0; k < 3; k++) {
                        int rr = row + kMagRefOffset[cls][k][0], cc = col + kMagRefOffset[cls][k][1];
                        if (rr < txh && cc < txw) mag += std::min(lev[rr * txw + cc], 15);
                    }
                    mag = std::min((mag + 1) >> 1, 6);
                    int bctx;
                    if (pos == 0) bctx = mag;
                    else if (cls == TX_CLASS_2D) bctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
                    else if (cls == TX_CLASS_HORIZ) bctx = col == 0 ? mag + 7 : mag + 14;
                    else bctx = row == 0 ? mag + 7 : mag + 14;
                    int left = a - 3;
                    for (int idx = 0; idx < 4; idx++) {
                        int br = std::min(left, 3);
                        sink.symbol(c.coeff_br[br_tx][ptype][bctx], 4, br);
                        left -= br;
                        if (br < 3) break;
                    }
                }
                lev[pos] = a;
            }
            for (int ci = 0; ci < eob; ci++) {
                int pos = scan[ci], v = q[pos], a = std::abs(v);
                if (v != 0) {
                    if (ci == 0) sink.symbol(c.dc_sign[ptype][dc_sign_ctx(plane, x4, y4, tx)], 2, v < 0);
                    else sink.literal(1, v < 0);
                }
                if (a > 14) {  // Golomb code of a - 14
                    int x = a - 14, len = floor_log2(x) + 1;
                    sink.literal(len - 1, 0);
                    sink.literal(1, 1);
                    sink.literal(len - 1, x & ((1 << (len - 1)) - 1));
                }
                if (pos == 0 && v) dc_category = v < 0 ? 1 : 2;
                cul_level += a;
            }
            cul_level = std::min(63, cul_level);
        }
        if (!update) return;
        for (int i = 0; i < w4; i++) {
            above_level[plane][x4 + i] = (uint8_t)cul_level;
            above_dc[plane][x4 + i] = (uint8_t)dc_category;
        }
        for (int i = 0; i < h4; i++) {
            left_level[plane][y4 + i] = (uint8_t)cul_level;
            left_dc[plane][y4 + i] = (uint8_t)dc_category;
        }
    }
    void reset_block_context() {
        for (int p = 0; p < 1 + 2 * has_chroma; p++) {
            int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
            for (int i = mi_col >> sx; i <= ((mi_col + bw4 - 1) >> sx); i++)
                above_level[p][i] = above_dc[p][i] = 0;
            for (int i = mi_row >> sy; i <= ((mi_row + bh4 - 1) >> sy); i++)
                left_level[p][i] = left_dc[p][i] = 0;
        }
    }
    void mark_decoded(int plane) {
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int tx = plane_tx(plane);
        int sb_mask = s.use_128x128 ? 31 : 15;
        int sub_row = mi_row & sb_mask, sub_col = mi_col & sb_mask;
        int row = mi_row, col = mi_col;
        uint8_t* lf = d.lf_tx_size[plane].data();
        for (int i = 0; i < (kTxH[tx] >> 2); i++)
            for (int j = 0; j < (kTxW[tx] >> 2); j++) {
                int rr = (row >> sy) + i, cc = (col >> sx) + j;
                if (rr < d.mi_rows && cc < d.mi_cols) lf[(size_t)rr * d.mi_cols + cc] = (uint8_t)tx;
                decoded(plane, (sub_row >> sy) + i, (sub_col >> sx) + j) = 1;
            }
        if (plane == 0) {
            for (int j = 0; j < bh4 && mi_row + j < d.mi_rows; j++)
                for (int i = 0; i < bw4 && mi_col + i < d.mi_cols; i++)
                    d.tx_types[(size_t)(mi_row + j) * d.mi_cols + mi_col + i] =
                        (uint8_t)(eob[0] ? dec_tx_type : DCT_DCT);
        }
    }
    int dec_tx_type = DCT_DCT;

    // The block coded: predicted, quantised and reconstructed plane by
    // plane, then its symbols (counted or written) in the decoder's order
    // and its contexts. Returns the SSE of its planes.
    template <class S>
    [[gnu::noinline]] int64_t commit(S& sink, int r, int col, const Decision& dec) {
        begin_block(r, col, dec);
        store_block();
        if (b.palette_size[0]) build_color_map();
        int64_t dist = 0;
        dec_tx_type = kTxSizeSqrUp[b.tx_size] <= TX_16X16 ? dec.tx_type : DCT_DCT;
        predict(0);
        dist += quantize_reconstruct(0, dec_tx_type, quant[0], eob[0]);
        luma_extent();
        int uv_type = DCT_DCT;
        if (has_chroma) {
            int uvtx = plane_tx(1);
            uv_type = kTxSizeSqrUp[uvtx] > TX_16X16 ? DCT_DCT : kModeToTxfm[b.uv_mode];
            for (int p = 1; p < 3; p++) {
                predict(p);
                dist += quantize_reconstruct(p, uv_type, quant[p], eob[p]);
            }
        }
        b.skip = eob[0] == 0 && (!has_chroma || (eob[1] == 0 && eob[2] == 0));
        d.blocks.back().skip = b.skip;
        code_mode_info(sink);
        if (b.palette_size[0]) code_color_map(sink);
        if (b.skip) reset_block_context();
        for (int p = 0; p < 1 + 2 * has_chroma; p++) {
            if (!b.skip)
                code_coeffs(sink, p, plane_tx(p), p ? uv_type : dec_tx_type, quant[p], eob[p], true);
            mark_decoded(p);
        }
        return dist;
    }

    // -- the search --
    int64_t search(int r, int col, int bsize, std::vector<Node>& nodes, int id);
    int64_t search_block(int r, int col, int bsize, Decision& dec);
    int64_t search_alpha_block(int r, int col, int bsize, Decision& dec);
    void write_tree(int r, int col, int bsize, const std::vector<Node>& nodes, int id);

    struct Snapshot {
        uint8_t decoded[3][34][34];
        std::vector<uint8_t> ctx;
    };
    void save(Snapshot& sn, int r, int col, int bsize) {
        std::memcpy(sn.decoded, block_decoded, sizeof block_decoded);
        sn.ctx.clear();
        for_ctx(r, col, bsize, [&](uint8_t& v) { sn.ctx.push_back(v); });
    }
    void restore(const Snapshot& sn, int r, int col, int bsize) {
        std::memcpy(block_decoded, sn.decoded, sizeof block_decoded);
        size_t i = 0;
        for_ctx(r, col, bsize, [&](uint8_t& v) { v = sn.ctx[i++]; });
    }
    template <class F>
    void for_ctx(int r, int col, int bsize, F fn) {
        int n4 = kNum4x4W[bsize];
        for (int p = 0; p < s.num_planes; p++) {
            int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
            for (int i = col >> sx; i < (col + n4) >> sx; i++) {
                fn(above_level[p][i]);
                fn(above_dc[p][i]);
            }
            for (int i = r >> sy; i < (r + n4) >> sy; i++) {
                fn(left_level[p][i]);
                fn(left_dc[p][i]);
            }
        }
    }
};

EncTile::EncTile(Decoder& dec, const Frame& frame, int tr, int tc)
    : d(dec), s(dec.seq), f(dec.fh), fr(frame) {
    init_cdfs(c, f.base_q_idx);
    row_start = f.mi_row_starts[tr];
    row_end = f.mi_row_starts[tr + 1];
    col_start = f.mi_col_starts[tc];
    col_end = f.mi_col_starts[tc + 1];
    for (int p = 0; p < 3; p++) {
        above_level[p].assign(d.mi_cols + 64, 0);
        above_dc[p].assign(d.mi_cols + 64, 0);
        left_level[p].assign(d.mi_rows + 64, 0);
        left_dc[p].assign(d.mi_rows + 64, 0);
    }
}


int64_t EncTile::sse(int plane) const {
    int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
    int tx = plane_tx(plane);
    int x = (mi_col >> sx) * 4, y = (mi_row >> sy) * 4;
    int w = std::min<int>(kTxW[tx], ((d.mi_cols * 4) >> sx) - x);
    int h = std::min<int>(kTxH[tx], ((d.mi_rows * 4) >> sy) - y);
    int64_t e = 0;
    for (int i = 0; i < h; i++) {
        const uint8_t* a = d.cur[plane].row(y + i) + x;
        const uint8_t* o = fr.src_row(plane, y + i) + x;
        for (int j = 0; j < w; j++) {
            int t = a[j] - o[j];
            e += t * t;
        }
    }
    return e;
}

// With estimate, nothing is reconstructed: the SSE is estimated in the
// transform domain (the residual's energy less what the coefficients
// recover).
int64_t EncTile::quantize_reconstruct(int plane, int tx_type, int32_t* q, int& eob_out,
                                      bool estimate) {
    int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
    int tx = plane_tx(plane);
    int x = (mi_col >> sx) * 4, y = (mi_row >> sy) * 4;
    int w = kTxW[tx], h = kTxH[tx], tw = std::min(w, 32), th = std::min(h, 32);
    static thread_local int16_t res[64 * 64];
    static thread_local float coef[32 * 32];
    int64_t energy = 0;
    for (int i = 0; i < h; i++) {
        const uint8_t* p = d.cur[plane].row(y + i) + x;
        const uint8_t* o = fr.src_row(plane, y + i) + x;
        for (int j = 0; j < w; j++) {
            int t = o[j] - p[j];
            res[i * w + j] = (int16_t)t;
            energy += t * t;
        }
    }
    eob_out = 0;
    if (!energy) {
        std::memset(q, 0, sizeof(int32_t) * tw * th);
        return estimate ? 0 : sse(plane);
    }
    forward_transform(res, tx, tx_type, coef);
    int shift = (tx == TX_32X32 || tx == TX_16X32 || tx == TX_32X16 || tx == TX_16X64 ||
                 tx == TX_64X16) ? 1
              : (tx == TX_64X64 || tx == TX_32X64 || tx == TX_64X32) ? 2 : 0;
    int dcq = kDcQLookup[0][f.base_q_idx], acq = kAcQLookup[0][f.base_q_idx];
    const int16_t* iscan = scan_of(tx, tx_type, true);
    const float* vnorm = bases().norm[kVertKind[tx_type]][kTxHLog2[tx]].data();
    const float* hnorm = bases().norm[kHorzKind[tx_type]][kTxWLog2[tx]].data();
    const float g2 = coef_energy(tx, tx_type, 0, 0) / (vnorm[0] * hnorm[0]);
    const float scale_dc = (float)(1 << shift) / (float)dcq, scale_ac = (float)(1 << shift) / (float)acq;
    int last = -1;
    float gained = 0;
    for (int i = 0; i < th * tw; i++) {
        float v = coef[i] * (i == 0 ? scale_dc : scale_ac);
        float a = std::abs(v);
        // A dead zone: rounding offsets below one half for every coefficient
        // but the DC.
        int l = (int)(a + (i == 0 ? 0.5f : 0.3f));
        q[i] = v < 0 ? -l : l;
        if (!l) continue;
        if (iscan[i] > last) last = iscan[i];
        if (estimate) {
            float deq = (float)((l * (i == 0 ? dcq : acq)) >> shift), c = std::abs(coef[i]);
            gained += (c * c - (c - deq) * (c - deq)) * vnorm[i / tw] * hnorm[i % tw] * g2;
        }
    }
    eob_out = last + 1;
    if (estimate) return std::max<int64_t>(0, energy - (int64_t)gained);
    if (eob_out) reconstruct(d, plane, x, y, tx, tx_type, 0, q, dcq, acq, 15);
    return sse(plane);
}

// -- the colour search --------------------------------------------------------

int satd_plane(const Decoder& d, const Frame& fr, int plane, int x, int y, int w, int h) {
    int total = 0;
    for (int by = 0; by < h; by += 4)
        for (int bx = 0; bx < w; bx += 4) {
            int m[16];
            for (int i = 0; i < 4; i++) {
                const uint8_t* p = d.cur[plane].row(y + by + i) + x + bx;
                const uint8_t* o = fr.src_row(plane, y + by + i) + x + bx;
                for (int j = 0; j < 4; j++) m[i * 4 + j] = o[j] - p[j];
            }
            for (int i = 0; i < 4; i++) {
                int* r = m + i * 4;
                int a = r[0] + r[1], b2 = r[0] - r[1], c2 = r[2] + r[3], d2 = r[2] - r[3];
                r[0] = a + c2, r[1] = b2 + d2, r[2] = a - c2, r[3] = b2 - d2;
            }
            for (int j = 0; j < 4; j++) {
                int a = m[j] + m[4 + j], b2 = m[j] - m[4 + j], c2 = m[8 + j] + m[12 + j],
                    d2 = m[8 + j] - m[12 + j];
                total += std::abs(a + c2) + std::abs(b2 + d2) + std::abs(a - c2) + std::abs(b2 - d2);
            }
        }
    return total >> 1;
}

const uint8_t kIntraModes[13] = {DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
                                D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
                                PAETH_PRED};

int64_t EncTile::search_block(int r, int col, int bsize, Decision& dec) {
    const int64_t lam = kLambda16;
    int64_t lam_satd = 1;  // the SATD's lambda, sqrt(lambda) x16
    while ((lam_satd + 1) * (lam_satd + 1) <= lam * 16) lam_satd++;
    dec = Decision();
    dec.bsize = (uint8_t)bsize;
    begin_block(r, col, dec);
    int tx = b.tx_size;
    int x = col * 4, y = r * 4, w = kTxW[tx], h = kTxH[tx];
    int above = kIntraModeContext[avail_u ? at(r - 1, col).y_mode : DC_PRED];
    int left = kIntraModeContext[avail_l ? at(r, col - 1).y_mode : DC_PRED];
    auto y_mode_cost = [&](int m, int delta) {
        int cst = sym_cost(c.kf_y_mode[above][left], 13, m);
        if (directional(m)) cst += sym_cost(c.angle_delta[m - V_PRED], 7, delta + 3);
        if (m == DC_PRED && std::max(bw4, bh4) <= 8) cst += sym_cost(c.use_filter_intra[bsize], 2, 0);
        return cst;
    };
    // Luma: every mode (and the directional ones' angle deltas) by SATD,
    // then the best few through the transform, quantiser and coefficient
    // costs with the transform types their size allows.
    struct Cand {
        int64_t j;
        int mode, delta;
    };
    std::vector<Cand> cands;
    auto satd_of = [&](int m, int delta) {
        b.angle_delta_y = (int8_t)delta;
        predict(0, m);
        int64_t satd = satd_plane(d, fr, 0, x, y, w, h);
        return Cand{satd * kBit * 16 + lam_satd * y_mode_cost(m, delta), m, delta};
    };
    auto by_j = [](const Cand& a, const Cand& c2) {
        return std::tie(a.j, a.mode, a.delta) < std::tie(c2.j, c2.mode, c2.delta);
    };
    for (int m : kIntraModes) cands.push_back(satd_of(m, 0));
    std::sort(cands.begin(), cands.end(), by_j);
    // The angle deltas of the two best directional modes.
    for (int k = 0, n = (int)cands.size(), tried = 0; k < n && tried < 2; k++) {
        if (!directional(cands[k].mode)) continue;
        tried++;
        for (int delta = -3; delta <= 3; delta++)
            if (delta) cands.push_back(satd_of(cands[k].mode, delta));
    }
    std::sort(cands.begin(), cands.end(), by_j);
    int keep = bsize >= BLOCK_32X32 ? 2 : 3;
    int64_t best = INT64_MAX;
    int best_mode = DC_PRED, best_delta = 0, best_type = DCT_DCT;
    auto try_luma = [&](int m, int delta, int type) {
        b.y_mode = (uint8_t)m;
        b.angle_delta_y = (int8_t)delta;
        predict(0);
        int e;
        int64_t dist = quantize_reconstruct(0, type, quant[0], e, true);
        CostSink cs;
        cs.bits = y_mode_cost(m, delta);
        code_coeffs(cs, 0, tx, type, quant[0], e, false);
        int64_t j = dist * kBit * 16 + lam * cs.bits;
        if (j < best) {
            best = j;
            best_mode = m;
            best_delta = delta;
            best_type = e ? type : DCT_DCT;
        }
    };
    // The best few by the DCT, then the other transform types of the best.
    for (int k = 0; k < keep && k < (int)cands.size(); k++) try_luma(cands[k].mode, cands[k].delta, DCT_DCT);
    if (kTxSizeSqrUp[tx] <= TX_16X16) {
        // The intra sets: 16x16 has IDTX and the DCT/ADST pairs, smaller
        // sizes the 1-D V_DCT and H_DCT too.
        int m = best_mode, delta = best_delta;
        for (int type : {ADST_DCT, DCT_ADST, ADST_ADST, IDTX}) try_luma(m, delta, type);
        if (kTxSizeSqr[tx] < TX_16X16)
            for (int type : {V_DCT, H_DCT}) try_luma(m, delta, type);
    }
    dec.y_mode = (uint8_t)best_mode;
    dec.angle_y = (int8_t)best_delta;
    dec.tx_type = (uint8_t)best_type;
    // The chosen luma reconstructed again, for chroma from luma.
    b.y_mode = dec.y_mode;
    b.angle_delta_y = dec.angle_y;
    predict(0);
    {
        int e;
        quantize_reconstruct(0, kTxSizeSqrUp[tx] <= TX_16X16 ? dec.tx_type : DCT_DCT, quant[0], e);
    }
    luma_extent();
    if (!has_chroma) return best;
    // Chroma: the modes by SATD over both planes, then the best few and
    // chroma from luma (its alphas by least squares) in full.
    int uvtx = plane_tx(1);
    int cx = (col >> 1) * 4, cy = (r >> 1) * 4, cw = kTxW[uvtx], ch = kTxH[uvtx];
    int cfl_ok = std::max(bw4, bh4) * 4 <= 32;
    auto uv_mode_cost = [&](int m) {
        int cst = cfl_ok ? sym_cost(c.uv_mode_cfl[b.y_mode], 14, m) : sym_cost(c.uv_mode_no_cfl[b.y_mode], 13, m);
        if (directional(m)) cst += sym_cost(c.angle_delta[m - V_PRED], 7, 3);
        return cst;
    };
    std::vector<Cand> uc;
    // The non-directional modes and the luma's direction.
    uint8_t uv_modes[6] = {DC_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, V_PRED};
    int n_uv = directional(b.y_mode) ? 6 : 5;
    if (directional(b.y_mode)) uv_modes[5] = b.y_mode;
    for (int k = 0; k < n_uv; k++) {
        int m = uv_modes[k];
        int64_t satd = 0;
        for (int p = 1; p < 3; p++) {
            predict(p, m);
            satd += satd_plane(d, fr, p, cx, cy, cw, ch);
        }
        uc.push_back({satd * kBit * 16 + lam_satd * uv_mode_cost(m), m, 0});
    }
    std::sort(uc.begin(), uc.end(), by_j);
    int64_t best_uv = INT64_MAX;
    auto try_uv = [&](int m, int au, int av) {
        b.uv_mode = (uint8_t)m;
        b.cfl_alpha_u = (int8_t)au;
        b.cfl_alpha_v = (int8_t)av;
        int type = kTxSizeSqrUp[uvtx] > TX_16X16 ? DCT_DCT : kModeToTxfm[m];
        CostSink cs;
        cs.bits = uv_mode_cost(m);
        if (m == UV_CFL_PRED) {
            int su = au == 0 ? 0 : au < 0 ? 1 : 2, sv = av == 0 ? 0 : av < 0 ? 1 : 2;
            cs.bits += sym_cost(c.cfl_sign, 8, su * 3 + sv - 1);
            if (su) cs.bits += sym_cost(c.cfl_alpha[(su - 1) * 3 + sv], 16, std::abs(au) - 1);
            if (sv) cs.bits += sym_cost(c.cfl_alpha[(sv - 1) * 3 + su], 16, std::abs(av) - 1);
        }
        int64_t dist = 0;
        for (int p = 1; p < 3; p++) {
            predict(p);
            int e;
            dist += quantize_reconstruct(p, type, quant[p], e, true);
            code_coeffs(cs, p, uvtx, type, quant[p], e, false);
        }
        int64_t j = dist * kBit * 16 + lam * cs.bits;
        if (j < best_uv) {
            best_uv = j;
            dec.uv_mode = (uint8_t)m;
            dec.cfl_u = (int8_t)au;
            dec.cfl_v = (int8_t)av;
        }
    };
    for (int k = 0; k < 2; k++) try_uv(uc[k].mode, 0, 0);
    if (cfl_ok) {
        // Least-squares alphas on the DC prediction and the luma's AC.
        int alpha[2];
        for (int p = 1; p < 3; p++) {
            predict(p, DC_PRED);
            static thread_local int lum[32 * 32];
            int64_t sum = 0;
            const Plane& luma = d.cur[0];
            for (int i = 0; i < ch; i++) {
                int ly = std::min((cy << 1) + (i << 1), max_luma_h - 2);
                for (int j = 0; j < cw; j++) {
                    int lx = std::min((cx << 1) + (j << 1), max_luma_w - 2);
                    int t = luma.row(ly)[lx] + luma.row(ly)[lx + 1] + luma.row(ly + 1)[lx] +
                            luma.row(ly + 1)[lx + 1];
                    lum[i * cw + j] = t << 1;
                    sum += t << 1;
                }
            }
            int avg = (int)((sum + (cw * ch / 2)) / (cw * ch));
            int64_t num = 0, den = 0;
            for (int i = 0; i < ch; i++) {
                const uint8_t* pr = d.cur[p].row(cy + i) + cx;
                const uint8_t* o = fr.src_row(p, cy + i) + cx;
                for (int j = 0; j < cw; j++) {
                    int l = lum[i * cw + j] - avg;
                    num += (int64_t)l * (o[j] - pr[j]);
                    den += (int64_t)l * l;
                }
            }
            int a = 0;
            if (den > 0) {
                int64_t v = num * 64;
                a = (int)((v >= 0 ? v + den / 2 : v - den / 2) / den);
            }
            alpha[p - 1] = clip3(-16, 16, a);
        }
        if (alpha[0] || alpha[1]) try_uv(UV_CFL_PRED, alpha[0], alpha[1]);
    }
    return best;
}

// -- the alpha search: palette blocks, or a mode that predicts the block
// exactly, or a lossy block where neither does ----------------------------------

int64_t EncTile::search_alpha_block(int r, int col, int bsize, Decision& dec) {
    dec = Decision();
    dec.bsize = (uint8_t)bsize;
    begin_block(r, col, dec);
    int x = col * 4, y = r * 4, n = kNum4x4W[bsize] * 4;
    int h = std::min(n, d.mi_rows * 4 - y), w = std::min(n, d.mi_cols * 4 - x);
    bool seen[256] = {false};
    int distinct = 0;
    for (int i = 0; i < h; i++) {
        const uint8_t* o = fr.src_row(0, y + i) + x;
        for (int j = 0; j < w; j++)
            if (!seen[o[j]]) {
                seen[o[j]] = true;
                distinct++;
            }
    }
    // A mode that predicts every sample: no residual.
    static const uint8_t kExact[5] = {DC_PRED, V_PRED, H_PRED, PAETH_PRED, SMOOTH_PRED};
    for (int m : kExact) {
        b.y_mode = (uint8_t)m;
        predict(0);
        if (sse(0) == 0) {
            dec.y_mode = (uint8_t)m;
            return 0;
        }
    }
    if (distinct <= 8 && bsize <= BLOCK_64X64) {
        dec.y_mode = DC_PRED;
        int k = 0;
        for (int v = 0; v < 256; v++)
            if (seen[v]) dec.pal[k++] = (uint16_t)v;
        if (k == 1) {  // a palette has two colours at least
            int other = dec.pal[0] == 255 ? 0 : 255;
            dec.pal[1] = (uint16_t)other;
            std::sort(dec.pal, dec.pal + 2);
            k = 2;
        }
        dec.pal_n = (uint8_t)k;
        return 0;
    }
    // Lossy: the luma search (a plane with levels a palette cannot hold).
    return search_block(r, col, bsize, dec);
}

// The partition search: the block whole (NONE) against its four
// quarters (SPLIT), each searched in turn, leaving the state of the
// better. The quarters are tried only where the whole block's
// prediction left a residual, and only while they cost less.
int64_t EncTile::search(int r, int col, int bsize, std::vector<Node>& nodes, int id) {
    if (r >= d.mi_rows || col >= d.mi_cols) return 0;
    const int64_t lam = kLambda16;
    int n4 = kNum4x4W[bsize], half = n4 >> 1, sub = partition_subsize(3, bsize);
    int has_rows = (r + half) < d.mi_rows, has_cols = (col + half) < d.mi_cols;
    bool can_none = has_rows && has_cols && bsize <= BLOCK_64X64;
    bool can_split = bsize > BLOCK_8X8;
    Snapshot s0;
    save(s0, r, col, bsize);
    Decision none;
    int kids[4] = {-1, -1, -1, -1};
    auto try_none = [&]() {
        if (s.num_planes == 1) search_alpha_block(r, col, bsize, none);
        else search_block(r, col, bsize, none);
        restore(s0, r, col, bsize);
        CostSink cs;
        code_partition(cs, r, col, bsize, 0);
        int64_t dist = commit(cs, r, col, none);
        return dist * kBit * 16 + lam * cs.bits;
    };
    auto try_split = [&](int64_t bound) {
        CostSink cs;
        code_partition(cs, r, col, bsize, 3);
        int64_t j = lam * cs.bits;
        for (int i = 0; i < 4; i++) {
            kids[i] = (int)nodes.size();
            nodes.push_back(Node());
        }
        for (int i = 0; i < 4 && j < bound; i++)
            j += search(r + (i >> 1) * half, col + (i & 1) * half, sub, nodes, kids[i]);
        return j;
    };
    auto as_split = [&](int64_t j) {
        nodes[id].split = 1;
        for (int i = 0; i < 4; i++) nodes[id].child[i] = kids[i];
        return j;
    };
    auto as_none = [&](int64_t j) {
        nodes[id].split = 0;
        nodes[id].dec = none;
        return j;
    };
    int64_t j_none = INT64_MAX;
    if (can_none) {
        j_none = try_none();
        // A block the prediction alone codes is not split further.
        if (b.skip) can_split = false;
    }
    if (can_split) {
        if (can_none) restore(s0, r, col, bsize);
        int64_t j_split = try_split(j_none);
        if (j_split < j_none) return as_split(j_split);
        restore(s0, r, col, bsize);
        CostSink cs;
        commit(cs, r, col, none);
    }
    return as_none(j_none);
}

void EncTile::write_tree(int r, int col, int bsize, const std::vector<Node>& nodes, int id) {
    if (r >= d.mi_rows || col >= d.mi_cols) return;
    const Node& n = nodes[id];
    code_partition(out, r, col, bsize, n.split ? 3 : 0);
    if (!n.split) {
        commit(out, r, col, n.dec);
        return;
    }
    int half = kNum4x4W[bsize] >> 1, sub = partition_subsize(3, bsize);
    for (int i = 0; i < 4; i++)
        write_tree(r + (i >> 1) * half, col + (i & 1) * half, sub, nodes, n.child[i]);
}

void EncTile::encode_superblock(int r, int col) {
    int sb4 = s.use_128x128 ? 32 : 16, sb = s.use_128x128 ? BLOCK_128X128 : BLOCK_64X64;
    Snapshot s0;
    clear_block_decoded(r, col, sb4);
    save(s0, r, col, sb);
    size_t nblocks = d.blocks.size();
    std::vector<Node> nodes(1);
    search(r, col, sb, nodes, 0);
    // The search leaves its trial blocks behind: the chosen tree is coded
    // again from the superblock's first state, now written.
    restore(s0, r, col, sb);
    d.blocks.resize(nblocks);
    write_tree(r, col, sb, nodes, 0);
}

std::vector<uint8_t> EncTile::run() {
    int sb4 = s.use_128x128 ? 32 : 16;
    for (int r = row_start; r < row_end; r += sb4) {
        for (int p = 0; p < 3; p++) {
            std::fill(left_level[p].begin(), left_level[p].end(), 0);
            std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
        }
        for (int col = col_start; col < col_end; col += sb4) encode_superblock(r, col);
    }
    return out.w.finish();
}

// -- headers --------------------------------------------------------------------

struct BitWriter {
    std::vector<uint8_t> buf;
    size_t bits = 0;
    void put(int v) {
        if ((bits & 7) == 0) buf.push_back(0);
        if (v) buf.back() |= (uint8_t)(0x80 >> (bits & 7));
        bits++;
    }
    void f(int n, uint32_t v) {
        for (int i = n - 1; i >= 0; i--) put((v >> i) & 1);
    }
    void trailing() {
        put(1);
        while (bits & 7) put(0);
    }
    void align() {
        while (bits & 7) put(0);
    }
};

void leb128(std::vector<uint8_t>& out, size_t v) {
    do {
        uint8_t byte = v & 0x7F;
        v >>= 7;
        out.push_back(byte | (v ? 0x80 : 0));
    } while (v);
}
void obu(std::vector<uint8_t>& out, int type, const std::vector<uint8_t>& payload) {
    out.push_back((uint8_t)((type << 3) | 2));
    leb128(out, payload.size());
    out.insert(out.end(), payload.begin(), payload.end());
}

// aom's level for a still picture: the lowest whose picture size and
// dimensions hold the frame (2.0, 2.1, 3.0, 3.1, 4.0, 5.0, 6.0; 31 past 6.x).
int seq_level(int w, int h) {
    static const struct { int idx; int64_t area; int maxw, maxh; } kLevels[] = {
        {0, 147456, 2048, 1152},      {1, 278784, 2816, 1584},       {4, 665856, 4352, 2448},
        {5, 1065024, 5504, 3096},     {8, 2359296, 6144, 3456},      {12, 8912896, 8192, 4352},
        {16, 35651584, 16384, 8704}};
    for (const auto& l : kLevels)
        if ((int64_t)w * h <= l.area && w <= l.maxw && h <= l.maxh) return l.idx;
    return 31;
}

int bits_for(int v) { return v ? floor_log2((uint32_t)v) + 1 : 1; }

std::vector<uint8_t> sequence_header(const SequenceHeader& s, int level) {
    BitWriter bw;
    bw.f(3, 0);  // seq_profile
    bw.f(1, 1);  // still_picture
    bw.f(1, 1);  // reduced_still_picture_header
    bw.f(5, level);  // seq_level_idx[0]
    bw.f(4, s.frame_width_bits - 1);
    bw.f(4, s.frame_height_bits - 1);
    bw.f(s.frame_width_bits, s.max_frame_width - 1);
    bw.f(s.frame_height_bits, s.max_frame_height - 1);
    bw.f(1, s.use_128x128);
    bw.f(1, s.enable_filter_intra);
    bw.f(1, s.enable_intra_edge_filter);
    bw.f(1, 0);  // enable_superres
    bw.f(1, 0);  // enable_cdef
    bw.f(1, 0);  // enable_restoration
    bw.f(1, 0);  // high_bitdepth
    bw.f(1, s.mono_chrome);
    bw.f(1, 0);  // color_description_present_flag (the colr box says it)
    bw.f(1, s.color_range);
    if (!s.mono_chrome) {
        bw.f(2, 0);  // chroma_sample_position
        bw.f(1, 0);  // separate_uv_delta_q
    }
    bw.f(1, 0);  // film_grain_params_present
    bw.trailing();
    return bw.buf;
}

int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
}

// The tiles of libavif's autotiling (avifSetTileConfiguration) at 8
// threads: a tile per 512x512 samples, at most 8, more columns than rows
// where the image is wider than tall; as aom clamps them.
void plan_tiles(const SequenceHeader& s, FrameHeader& f, int& min_cols, int& max_cols,
                int& min_rows, int& max_rows) {
    int sb_shift = s.use_128x128 ? 5 : 4;
    int sb_cols = (f.mi_cols + (1 << sb_shift) - 1) >> sb_shift;
    int sb_rows = (f.mi_rows + (1 << sb_shift) - 1) >> sb_shift;
    int sb_size = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size, max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    min_cols = tile_log2(max_tile_width_sb, sb_cols);
    max_cols = tile_log2(1, std::min(sb_cols, 64));
    max_rows = tile_log2(1, std::min(sb_rows, 64));
    int min_tiles = std::max(min_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    int64_t area = (int64_t)f.frame_width * f.frame_height;
    int tiles = (int)std::min<int64_t>(8, (area + 512 * 512 - 1) / (512 * 512));
    int lg = floor_log2((uint32_t)tiles), cols, rows;
    if (f.frame_width >= f.frame_height) {
        rows = lg / 2;
        cols = lg - rows;
    } else {
        cols = lg / 2;
        rows = lg - cols;
    }
    f.tile_cols_log2 = clip3(min_cols, max_cols, cols);
    min_rows = std::max(min_tiles - f.tile_cols_log2, 0);
    f.tile_rows_log2 = clip3(min_rows, max_rows, rows);
    int wsb = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2, i = 0;
    for (int start = 0; start < sb_cols; start += wsb) f.mi_col_starts[i++] = start << sb_shift;
    f.mi_col_starts[i] = f.mi_cols;
    f.tile_cols = i;
    int hsb = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
    i = 0;
    for (int start = 0; start < sb_rows; start += hsb) f.mi_row_starts[i++] = start << sb_shift;
    f.mi_row_starts[i] = f.mi_rows;
    f.tile_rows = i;
}

std::vector<uint8_t> frame_header(const SequenceHeader& s, const FrameHeader& f, int min_cols,
                                  int max_cols, int min_rows, int max_rows) {
    BitWriter bw;
    bw.f(1, 0);  // disable_cdf_update
    bw.f(1, f.allow_screen_content_tools);
    if (f.allow_screen_content_tools) bw.f(1, 0);  // force_integer_mv
    bw.f(1, 0);  // render_and_frame_size_different
    if (f.allow_screen_content_tools) bw.f(1, 0);  // allow_intrabc
    // tile_info, uniform
    bw.f(1, 1);
    for (int k = min_cols; k < max_cols; k++) {
        bw.f(1, k < f.tile_cols_log2);
        if (k >= f.tile_cols_log2) break;
    }
    for (int k = min_rows; k < max_rows; k++) {
        bw.f(1, k < f.tile_rows_log2);
        if (k >= f.tile_rows_log2) break;
    }
    if (f.tile_cols_log2 || f.tile_rows_log2) {
        bw.f(f.tile_cols_log2 + f.tile_rows_log2, 0);  // context_update_tile_id
        bw.f(2, f.tile_size_bytes - 1);
    }
    bw.f(8, f.base_q_idx);
    bw.f(1, 0);  // DeltaQYDc
    if (s.num_planes > 1) {
        bw.f(1, 0);  // DeltaQUDc
        bw.f(1, 0);  // DeltaQUAc
    }
    bw.f(1, 0);  // using_qmatrix
    bw.f(1, 0);  // segmentation_enabled
    bw.f(1, 0);  // delta_q_present
    bw.f(6, f.loop_filter_level[0]);
    bw.f(6, f.loop_filter_level[1]);
    if (s.num_planes > 1 && (f.loop_filter_level[0] || f.loop_filter_level[1])) {
        bw.f(6, f.loop_filter_level[2]);
        bw.f(6, f.loop_filter_level[3]);
    }
    bw.f(3, f.loop_filter_sharpness);
    bw.f(1, f.loop_filter_delta_enabled);
    if (f.loop_filter_delta_enabled) bw.f(1, 0);  // loop_filter_delta_update
    bw.f(1, f.tx_mode_select);
    bw.f(1, f.reduced_tx_set);
    bw.align();
    return bw.buf;
}

// A tile's pixels and mode info, from the state it was encoded in.
void merge_tile(Decoder& d, const Decoder& t, int tr, int tc) {
    const FrameHeader& f = d.fh;
    int r0 = f.mi_row_starts[tr], r1 = f.mi_row_starts[tr + 1];
    int c0 = f.mi_col_starts[tc], c1 = f.mi_col_starts[tc + 1];
    bool last_row = tr == f.tile_rows - 1, last_col = tc == f.tile_cols - 1;
    for (int p = 0; p < d.seq.num_planes; p++) {
        int sx = p ? d.seq.subsampling_x : 0, sy = p ? d.seq.subsampling_y : 0;
        Plane& dst = d.cur[p];
        const Plane& src = t.cur[p];
        int rows = (int)(dst.buf.size() / dst.stride);
        int y0 = (r0 * 4) >> sy, y1 = last_row ? rows : (r1 * 4) >> sy;
        int x0 = (c0 * 4) >> sx, x1 = last_col ? dst.stride : (c1 * 4) >> sx;
        for (int y = y0; y < y1; y++) std::memcpy(dst.row(y) + x0, src.row(y) + x0, x1 - x0);
        for (int r = r0 >> sy; r < (r1 + sy) >> sy; r++)
            for (int c = c0 >> sx; c < (c1 + sx) >> sx; c++) {
                size_t at = (size_t)r * d.mi_cols + c;
                d.lf_tx_size[p][at] = t.lf_tx_size[p][at];
            }
    }
    int32_t offset = (int32_t)d.blocks.size();
    d.blocks.insert(d.blocks.end(), t.blocks.begin(), t.blocks.end());
    for (int r = r0; r < r1; r++)
        for (int c = c0; c < c1; c++) {
            size_t at = (size_t)r * d.mi_cols + c;
            d.mi_block[at] = t.mi_block[at] + offset;
            d.inter_tx_size[at] = t.inter_tx_size[at];
            d.tx_types[at] = t.tx_types[at];
        }
}

// The loop filter levels that bring the deblocked planes closest to the
// source, tried on copies of the reconstruction.
void pick_loop_filter(Frame& fr) {
    Decoder& d = fr.d;
    FrameHeader& f = d.fh;
    int np = d.seq.num_planes;
    Plane keep[3];
    for (int p = 0; p < np; p++) keep[p] = d.cur[p];
    auto plane_sse = [&](int p) {
        int sx = p ? d.seq.subsampling_x : 0, sy = p ? d.seq.subsampling_y : 0;
        int w = (f.frame_width + sx) >> sx, h = (f.frame_height + sy) >> sy;
        int64_t e = 0;
        for (int i = 0; i < h; i++) {
            const uint8_t* a = d.cur[p].row(i);
            const uint8_t* o = fr.src_row(p, i);
            for (int j = 0; j < w; j++) {
                int t = a[j] - o[j];
                e += t * t;
            }
        }
        return e;
    };
    static const int kLevels[] = {0, 1, 2, 3, 4, 6, 8, 10};
    int64_t best[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
    int level[3] = {0, 0, 0};
    for (int lvl : kLevels) {
        for (int i = 0; i < 4; i++) f.loop_filter_level[i] = lvl;
        for (int p = 0; p < np; p++) d.cur[p] = keep[p];
        loop_filter_frame(d);
        for (int p = 0; p < np; p++) {
            int64_t e = plane_sse(p);
            if (e < best[p]) {
                best[p] = e;
                level[p] = lvl;
            }
        }
    }
    for (int p = 0; p < np; p++) d.cur[p] = keep[p];
    f.loop_filter_level[0] = f.loop_filter_level[1] = level[0];
    f.loop_filter_level[2] = level[0] ? level[1] : 0;
    f.loop_filter_level[3] = level[0] ? level[2] : 0;
}

}  // namespace

// An AV1 stream (temporal delimiter, sequence header, frame) of one key
// frame of the planes: y (w x h) and, unless mono, u and v
// (((w+1)>>1) x ((h+1)>>1)).
std::vector<uint8_t> encode_key_frame(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w,
                                      int h, int mono) {
    auto fr = std::make_unique<Frame>();
    Decoder& d = fr->d;
    SequenceHeader& s = d.seq;
    s.still_picture = s.reduced_still_picture_header = 1;
    s.frame_width_bits = bits_for(w - 1);
    s.frame_height_bits = bits_for(h - 1);
    s.max_frame_width = w;
    s.max_frame_height = h;
    s.use_128x128 = std::min(w, h) > 480;
    s.enable_filter_intra = s.enable_intra_edge_filter = 1;
    s.seq_force_screen_content_tools = 2;
    s.seq_force_integer_mv = 2;
    s.mono_chrome = mono;
    s.num_planes = mono ? 1 : 3;
    s.color_range = 1;
    FrameHeader& f = d.fh;
    f.frame_width = f.upscaled_width = f.render_width = w;
    f.frame_height = f.render_height = h;
    f.mi_cols = 2 * ((w + 7) >> 3);
    f.mi_rows = 2 * ((h + 7) >> 3);
    f.allow_screen_content_tools = mono;
    f.base_q_idx = 64;
    f.loop_filter_delta_enabled = 1;
    int min_cols, max_cols, min_rows, max_rows;
    plan_tiles(s, f, min_cols, max_cols, min_rows, max_rows);
    setup_frame(d);
    // The source planes padded by replication to the planes' allocation.
    const uint8_t* in[3] = {y, u, v};
    for (int p = 0; p < s.num_planes; p++) {
        int sx = p ? 1 : 0, sy = p ? 1 : 0;
        int pw = (w + sx) >> sx, ph = (h + sy) >> sy;
        const Plane& cp = d.cur[p];
        int aw = cp.stride, ah = (int)(cp.buf.size() / cp.stride);
        fr->src_stride[p] = aw;
        fr->src[p].assign((size_t)aw * ah, 0);
        for (int i = 0; i < ah; i++) {
            const uint8_t* r = in[p] + (size_t)std::min(i, ph - 1) * pw;
            uint8_t* o = fr->src[p].data() + (size_t)i * aw;
            std::memcpy(o, r, pw);
            std::memset(o + pw, r[pw - 1], aw - pw);
        }
    }
    // Tiles are independent: each is encoded on its own thread into its
    // own copy of the frame's state, then merged (the bytes are the same
    // as one thread's).
    int n_tiles = f.tile_rows * f.tile_cols;
    std::vector<std::vector<uint8_t>> tiles(n_tiles);
    std::vector<std::unique_ptr<Decoder>> states(n_tiles);
    auto encode_tile = [&](int t) {
        states[t] = std::make_unique<Decoder>(d);
        auto et = std::make_unique<EncTile>(*states[t], *fr, t / f.tile_cols, t % f.tile_cols);
        tiles[t] = et->run();
    };
    if (n_tiles == 1) {
        encode_tile(0);
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < n_tiles; t++) pool.emplace_back(encode_tile, t);
        for (auto& th : pool) th.join();
    }
    for (int t = 0; t < n_tiles; t++) merge_tile(d, *states[t], t / f.tile_cols, t % f.tile_cols);
    states.clear();
    if (!mono) pick_loop_filter(*fr);
    size_t widest = 0;
    for (size_t i = 0; i + 1 < tiles.size(); i++) widest = std::max(widest, tiles[i].size() - 1);
    f.tile_size_bytes = widest < 256 ? 1 : widest < 65536 ? 2 : widest < (1u << 24) ? 3 : 4;
    std::vector<uint8_t> frame = frame_header(s, f, min_cols, max_cols, min_rows, max_rows);
    if (tiles.size() > 1) {
        frame.push_back(0);  // tile_start_and_end_present_flag, then alignment
    }
    for (size_t i = 0; i < tiles.size(); i++) {
        if (i + 1 < tiles.size())
            for (int k = 0; k < f.tile_size_bytes; k++)
                frame.push_back((uint8_t)((tiles[i].size() - 1) >> (8 * k)));
        frame.insert(frame.end(), tiles[i].begin(), tiles[i].end());
    }
    std::vector<uint8_t> out;
    obu(out, 2, {});
    obu(out, 1, sequence_header(s, seq_level(w, h)));
    obu(out, 6, frame);
    return out;
}

}  // namespace av1

extern "C" {

// An AV1 key frame of 8-bit planes (see encode_key_frame) at base_q_idx
// 64 into out (cap bytes). Returns
// its length, -1 where it does not fit, -2 for a size AV1 cannot code.
long av1_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v, long w, long h, long mono,
                uint8_t* out, long cap) {
    if (w < 1 || h < 1 || w > 65536 || h > 65536) return -2;
    std::vector<uint8_t> data = av1::encode_key_frame(y, u, v, (int)w, (int)h, (int)mono);
    if ((long)data.size() > cap) return -1;
    std::memcpy(out, data.data(), data.size());
    return (long)data.size();
}

}
