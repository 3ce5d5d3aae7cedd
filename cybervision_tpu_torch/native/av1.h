// What the AV1 key-frame decoder's sources share (av1obu.cpp: OBUs and
// headers; av1entropy.cpp: the symbol decoder and a tile's syntax;
// av1recon.cpp: prediction and inverse transforms; av1filter.cpp:
// deblocking, CDEF, superres upscaling and loop restoration; av1grain.cpp:
// film grain). It decodes the first frame of an AV1 stream, a key frame
// of 8, 10 or 12 bits, as the AV1 specification (2019, with errata) sets
// out, which is what dav1d decodes bit for bit.
// Names follow the specification's. As dav1d's 8bpc and 16bpc templates
// do, every function that touches samples is a template of the sample
// type (uint8_t at 8 bits, uint16_t above), so the 8-bit path keeps its
// byte planes; the functions declared here pick the instance by the
// sequence header's bit depth.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace av1 {

// A stream the decoder refuses: damaged, or using a tool it lacks ("not
// supported yet").
struct Error : std::runtime_error {
    int code;
    Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};
enum { kErrCorrupt = -1, kErrUnsupported = -2 };
[[noreturn]] inline void corrupt(const char* what) { throw Error(kErrCorrupt, what); }
[[noreturn]] inline void unsupported(const char* what) {
    throw Error(kErrUnsupported, std::string(what) + " is not supported yet");
}

enum BlockSize {
    BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16,
    BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64,
    BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32,
    BLOCK_32X8, BLOCK_16X64, BLOCK_64X16, BLOCK_SIZES, BLOCK_INVALID = BLOCK_SIZES
};
enum TxSize {
    TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8,
    TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64,
    TX_64X16, TX_SIZES_ALL
};
enum PredMode {
    DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED,
    D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED
};
enum TxType {
    DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
    ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

extern const uint8_t kNum4x4W[BLOCK_SIZES], kNum4x4H[BLOCK_SIZES];
extern const uint8_t kMiWidthLog2[BLOCK_SIZES], kMiHeightLog2[BLOCK_SIZES];
extern const uint8_t kTxW[TX_SIZES_ALL], kTxH[TX_SIZES_ALL];
extern const uint8_t kTxWLog2[TX_SIZES_ALL], kTxHLog2[TX_SIZES_ALL];
extern const uint8_t kMaxTxSizeRect[BLOCK_SIZES], kSplitTxSize[TX_SIZES_ALL];
extern const uint8_t kTxSizeSqr[TX_SIZES_ALL], kTxSizeSqrUp[TX_SIZES_ALL];
int block_size(int w, int h);  // BLOCK_INVALID where none
int tx_size(int w, int h);

struct SequenceHeader {
    int profile = 0, still_picture = 0, reduced_still_picture_header = 0;
    int timing_info_present = 0, decoder_model_info_present = 0, equal_picture_interval = 0;
    int buffer_delay_length = 0;
    int buffer_removal_time_length = 0, frame_presentation_time_length = 0;
    int operating_points = 1, operating_point_idc[32] = {0};
    int decoder_model_present_for_op[32] = {0};
    int frame_width_bits = 0, frame_height_bits = 0, max_frame_width = 0, max_frame_height = 0;
    int frame_id_numbers_present = 0, delta_frame_id_length = 0, additional_frame_id_length = 0;
    int use_128x128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
    int enable_order_hint = 0, order_hint_bits = 0;
    int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
    int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
    int bit_depth = 8, mono_chrome = 0, color_description_present = 0;
    int color_primaries = 2, transfer_characteristics = 2, matrix_coefficients = 2;
    int color_range = 0, subsampling_x = 1, subsampling_y = 1, chroma_sample_position = 0;
    int separate_uv_delta_q = 0, film_grain_params_present = 0;
    int num_planes = 3;
};

// A frame's film grain parameters (specification 5.9.30); uv [0] is Cb,
// [1] Cr.
struct FilmGrain {
    int apply = 0, seed = 0, num_y = 0, num_uv[2] = {0, 0}, chroma_from_luma = 0;
    uint8_t y_points[14][2] = {}, uv_points[2][10][2] = {};
    int scaling_shift = 8, ar_lag = 0, ar_shift = 6, grain_scale_shift = 0;
    int8_t ar_y[24] = {}, ar_uv[2][25] = {};
    int uv_mult[2] = {0, 0}, uv_luma_mult[2] = {0, 0}, uv_offset[2] = {0, 0};
    int overlap = 0, clip_restricted = 0;
};

struct FrameHeader {
    int frame_type = 0, show_frame = 1, showable_frame = 0, error_resilient_mode = 1;
    int disable_cdf_update = 0, allow_screen_content_tools = 0, allow_intrabc = 0;
    int frame_width = 0, frame_height = 0, upscaled_width = 0, render_width = 0;
    int render_height = 0, mi_cols = 0, mi_rows = 0;
    // Superres: frame_width is the coded (downscaled) width, upscaled_width
    // the output's; the denominator over SUPERRES_NUM (8), 8 without.
    int use_superres = 0, superres_denom = 8;
    int disable_frame_end_update_cdf = 1;
    // Tiles.
    int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
    int mi_col_starts[65] = {0}, mi_row_starts[65] = {0};
    int context_update_tile_id = 0, tile_size_bytes = 4;
    // Quantisation.
    int base_q_idx = 0, delta_q_y_dc = 0, delta_q_u_dc = 0, delta_q_u_ac = 0;
    int delta_q_v_dc = 0, delta_q_v_ac = 0, using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
    // Segmentation.
    int segmentation_enabled = 0, feature_enabled[8][8] = {{0}}, feature_data[8][8] = {{0}};
    int seg_id_pre_skip = 0, last_active_seg_id = 0;
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0;
    int delta_lf_multi = 0;
    int coded_lossless = 0, all_lossless = 0, lossless_array[8] = {0};
    // Loop filter.
    int loop_filter_level[4] = {0}, loop_filter_sharpness = 0, loop_filter_delta_enabled = 0;
    int loop_filter_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    int loop_filter_mode_deltas[2] = {0, 0};
    // CDEF.
    int cdef_damping = 3, cdef_bits = 0, cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0};
    int cdef_uv_pri[8] = {0}, cdef_uv_sec[8] = {0};
    // Loop restoration.
    int frame_restoration_type[3] = {0}, loop_restoration_size[3] = {256, 256, 256};
    int uses_lr = 0;
    int tx_mode_select = 0, only_4x4 = 0, reduced_tx_set = 0;
    FilmGrain grain;
};

// The default CDFs, adapted as a tile decodes; a copy per tile.
struct Cdfs {
    uint16_t kf_y_mode[5][5][14], uv_mode_no_cfl[13][14], uv_mode_cfl[13][15];
    uint16_t partition_w8[4][5], partition_w16[4][11], partition_w32[4][11];
    uint16_t partition_w64[4][11], partition_w128[4][9];
    uint16_t cfl_alpha[6][17], cfl_sign[9], angle_delta[8][8], filter_intra_mode[6];
    uint16_t use_filter_intra[22][3], segment_id[3][9], skip[3][3];
    uint16_t intra_tx_set1[2][13][8], intra_tx_set2[3][13][6];
    uint16_t tx8[3][3], tx16[3][4], tx32[3][4], tx64[3][4];
    uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
    uint16_t palette_y_mode[7][3][3], palette_uv_mode[2][3];
    uint16_t palette_y_size[7][8], palette_uv_size[7][8];
    uint16_t palette_y_color[7][5][9], palette_uv_color[7][5][9];
    uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
    // Intra block copy.
    uint16_t intrabc[3], inter_tx_set1[2][17], inter_tx_set2[13], inter_tx_set3[4][3];
    uint16_t txfm_split[21][3], mv_joint[5];
    uint16_t mv_class[2][12], mv_sign[2][3], mv_class0_bit[2][3], mv_bit[2][10][3];
    // Coefficients, at the frame's quantiser context.
    uint16_t txb_skip[5][13][3], eob_pt16[2][2][6], eob_pt32[2][2][7], eob_pt64[2][2][8];
    uint16_t eob_pt128[2][2][9], eob_pt256[2][2][10], eob_pt512[2][11], eob_pt1024[2][12];
    uint16_t eob_extra[5][2][9][3], coeff_base_eob[5][2][4][4], coeff_base[5][2][42][5];
    uint16_t coeff_br[5][2][21][5], dc_sign[2][3][3];
};
void init_cdfs(Cdfs& c, int base_q_idx);

// A plane of 8-bit (row) or 16-bit (px<uint16_t>) samples; stride in
// samples.
struct Plane {
    std::vector<uint8_t> buf;
    int stride = 0, width = 0, height = 0;  // allocated; width/height are the plane's
    uint8_t* row(int y) { return buf.data() + (size_t)y * stride; }
    const uint8_t* row(int y) const { return buf.data() + (size_t)y * stride; }
    template <typename pixel>
    pixel* px(int y) { return reinterpret_cast<pixel*>(buf.data()) + (size_t)y * stride; }
    template <typename pixel>
    const pixel* px(int y) const {
        return reinterpret_cast<const pixel*>(buf.data()) + (size_t)y * stride;
    }
};

// Mode info of one block, shared by every 4x4 unit it covers.
struct BlockInfo {
    uint8_t mi_size, y_mode, uv_mode, skip, segment_id, tx_size, palette_size[2];
    uint8_t use_filter_intra, filter_intra_mode;
    uint8_t is_inter;  // an intra block copy
    int8_t angle_delta_y, angle_delta_uv, cfl_alpha_u, cfl_alpha_v;
    int16_t mv[2];     // row, col in 1/8 sample
    int8_t delta_lf[4];
    uint16_t palette_colors[3][8];
};

struct Decoder {
    SequenceHeader seq;
    FrameHeader fh;
    Cdfs frame_cdfs;
    int mi_rows = 0, mi_cols = 0;
    Plane cur[3], cdef[3], lr[3];
    std::vector<BlockInfo> blocks;
    std::vector<int32_t> mi_block;          // mi_rows x mi_cols, index into blocks
    std::vector<uint8_t> inter_tx_size;     // mi_rows x mi_cols (InterTxSizes)
    std::vector<uint8_t> tx_types;          // mi_rows x mi_cols, luma (TxTypes)
    std::vector<uint8_t> lf_tx_size[3];     // mi_rows x mi_cols in plane 4x4 units
    std::vector<int8_t> cdef_idx;           // per 64x64
    int cdef_stride = 0;
    // Loop restoration units per plane.
    int lr_unit_rows[3] = {0}, lr_unit_cols[3] = {0};
    std::vector<uint8_t> lr_type[3], lr_sgr_set[3];
    std::vector<int8_t> lr_wiener[3];       // [unit][pass][3]
    std::vector<int16_t> lr_sgr_xqd[3];     // [unit][2]

    const BlockInfo& bi(int r, int c) const { return blocks[mi_block[(size_t)r * mi_cols + c]]; }
};

// av1obu.cpp: decode the first frame of a stream of OBUs (a sample of an
// AVIF item or track). Throws Error.
void decode_frame_obus(Decoder& d, const uint8_t* data, size_t size);
// av1obu.cpp: a frame's planes (of 1 or 2 bytes a sample) and mode-info
// arrays for its headers.
void alloc_plane(Plane& p, int w, int h, int bytes = 1);
void setup_frame(Decoder& d);
// av1entropy.cpp: one tile.
void decode_tile(Decoder& d, const uint8_t* data, size_t size, int tile_row, int tile_col);
// The palette colour cache of a block (get_palette_cache, 7.11.4): the
// above (within its 64-row superblock row) and left blocks' colours of
// the plane, merged ascending without repeats. Returns their count.
int palette_cache(const Decoder& d, int mi_row, int mi_col, int avail_u, int avail_l, int plane,
                  uint16_t* cache);
// av1filter.cpp: after every tile, in this order.
void loop_filter_frame(Decoder& d);
void cdef_frame(Decoder& d);
// The superres upscaling (7.16) of the CDEF output, and of the deblocked
// frame that loop restoration reads across stripe edges, to the upscaled
// width; nothing without superres.
void superres_frame(Decoder& d);
void lr_frame(Decoder& d);
// av1grain.cpp: the film grain synthesis, on Decoder::lr.
void film_grain_frame(Decoder& d);

// av1recon.cpp.
void predict_intra(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                   int have_above_right, int have_below_left, int mode, int log2w, int log2h,
                   const BlockInfo& b, int avail_u, int avail_l, int mi_row, int mi_col);
void predict_filter_intra(Decoder& d, int plane, int x, int y, int have_left, int have_above,
                          int have_above_right, int have_below_left, int log2w, int log2h,
                          int mode);
void predict_cfl(Decoder& d, int plane, int x, int y, int tx, int alpha, int max_luma_w,
                 int max_luma_h);
void predict_intrabc(Decoder& d, int plane, int x, int y, int w, int h, const int16_t* mv);
// The 1-D inverse transform (kind 0 DCT, 1 ADST, 2 identity) of 1 << log2n
// values in place, without the clamps of reconstruct (the encoder's basis).
void inverse_transform_1d(int kind, int log2n, int32_t* T);
// qm_level: the plane's quantizer matrix level, 15 for none.
void reconstruct(Decoder& d, int plane, int x, int y, int tx, int tx_type, int lossless,
                 int32_t* quant, int dc_q, int ac_q, int qm_level);

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
// The largest sample value, a constant of the 8-bit instance.
template <typename pixel>
inline int pixel_max(const Decoder& d) {
    return sizeof(pixel) == 1 ? 255 : (1 << d.seq.bit_depth) - 1;
}
template <typename pixel>
inline int bit_depth(const Decoder& d) {
    return sizeof(pixel) == 1 ? 8 : d.seq.bit_depth;
}
inline int round2(int x, int n) { return n == 0 ? x : (x + (1 << (n - 1))) >> n; }
inline int64_t round2l(int64_t x, int n) { return n == 0 ? x : (x + ((int64_t)1 << (n - 1))) >> n; }
inline int floor_log2(uint32_t x) { return 31 - __builtin_clz(x); }
inline int ceil_log2(uint32_t x) { return x < 2 ? 0 : floor_log2(x - 1) + 1; }

// What the decoder (av1entropy.cpp, av1recon.cpp) and the encoder
// (av1encode.cpp) share: the coefficient scans and contexts, partition
// sizes, the transforms' 1-D kinds and row shifts, the CDF adaptation and
// the palette's colour contexts.

struct Scans {
    // Default, row (mrow) and column (mcol) scans of every adjusted size.
    std::vector<int16_t> def[TX_SIZES_ALL], row[TX_SIZES_ALL], col[TX_SIZES_ALL];
    Scans() {
        for (int t = 0; t < TX_SIZES_ALL; t++) {
            int w = std::min<int>(kTxW[t], 32), h = std::min<int>(kTxH[t], 32);
            if (t == TX_16X64) w = 16, h = 32;
            if (t == TX_64X16) w = 32, h = 16;
            for (int d = 0; d < w + h - 1; d++) {
                std::vector<int16_t> cells;
                for (int r = 0; r < h; r++)
                    if (d - r >= 0 && d - r < w) cells.push_back((int16_t)(r * w + d - r));
                if ((w == h && d % 2 == 0) || w > h) std::reverse(cells.begin(), cells.end());
                def[t].insert(def[t].end(), cells.begin(), cells.end());
            }
            for (int i = 0; i < w * h; i++) {
                row[t].push_back((int16_t)i);
                col[t].push_back((int16_t)((i % h) * w + i / h));
            }
        }
    }
};
inline const Scans& scans() {
    static const Scans s;
    return s;
}

inline constexpr uint8_t kAdjustedTx[TX_SIZES_ALL] = {
    TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_32X32, TX_4X8,   TX_8X4,
    TX_8X16,  TX_16X8,  TX_16X32, TX_32X16, TX_32X32, TX_32X32, TX_4X16,
    TX_16X4,  TX_8X32,  TX_32X8,  TX_16X32, TX_32X16};
inline constexpr uint8_t kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
inline constexpr uint8_t kModeToTxfm[14] = {DCT_DCT,  ADST_DCT, DCT_ADST, DCT_DCT,  ADST_ADST,
                                 ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST,
                                 ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
inline constexpr int8_t kSigRefDiffOffset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
inline constexpr int8_t kMagRefOffset[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                                       {{0, 1}, {1, 0}, {0, 2}},
                                       {{0, 1}, {1, 0}, {2, 0}}};
inline constexpr int8_t kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
inline int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
}

inline int partition_subsize(int p, int b) {
    int n = kNum4x4W[b] * 4;
    switch (p) {
        case 0: return b;
        case 1: case 4: case 5: return block_size(n, n / 2);
        case 2: case 6: case 7: return block_size(n / 2, n);
        case 3: return block_size(n / 2, n / 2);
        case 8: return block_size(n, n / 4);
        default: return block_size(n / 4, n);
    }
}

inline constexpr uint8_t kTransformRowShift[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                                  1, 1, 1, 1, 1, 2, 2, 2, 2};
// Vertical (column) and horizontal (row) 1-D kinds of each transform type.
inline constexpr uint8_t kVertKind[16] = {0, 1, 0, 1, 1, 0, 1, 1, 1, 2, 0, 2, 1, 2, 1, 2};
inline constexpr uint8_t kHorzKind[16] = {0, 0, 1, 1, 0, 1, 1, 1, 1, 2, 2, 0, 2, 1, 2, 1};

// A CDF's adaptation after symbol s of n (8.2.6), as the decoder and the
// encoder's writer both run it.
inline void adapt_cdf(uint16_t* icdf, int n, int s) {
    int count = icdf[n];
    int rate = 3 + (count > 15) + (count > 31) + std::min(floor_log2(n), 2);
    int tmp = 32768;
    for (int i = 0; i < n - 1; i++) {
        if (i == s) tmp = 0;
        if (tmp < icdf[i]) icdf[i] -= (uint16_t)((icdf[i] - tmp) >> rate);
        else icdf[i] += (uint16_t)((tmp - icdf[i]) >> rate);
    }
    icdf[n] += count < 32;
}

// The probability of a split where a block at the frame's edge has only
// SPLIT and HORZ (has_cols) or SPLIT and VERT left (5.11.4).
inline int split_psum(const uint16_t* cdf, int bsize, int has_cols) {
    auto p = [&](int e) { return (e > 0 ? cdf[e - 1] : 32768) - cdf[e]; };
    if (has_cols)
        return p(2) + p(3) + p(4) + p(6) + p(7) + (bsize != BLOCK_128X128 ? p(9) : 0);
    return p(1) + p(3) + p(4) + p(5) + p(6) + (bsize != BLOCK_128X128 ? p(8) : 0);
}

// A palette colour index's context and the colours' order at (r, j) of a
// colour map of stride bw (get_palette_color_context, 7.11.4); -1 for a
// context no stream can reach.
inline int palette_color_context(const uint8_t* map, int bw, int r, int j, int n, int* order) {
    int scores[8] = {0};
    for (int k = 0; k < 8; k++) order[k] = k;
    if (j > 0) scores[map[r * bw + j - 1]] += 2;
    if (r > 0 && j > 0) scores[map[(r - 1) * bw + j - 1]] += 1;
    if (r > 0) scores[map[(r - 1) * bw + j]] += 2;
    for (int k = 0; k < 3; k++) {
        int best = scores[k], bi = k;
        for (int l = k + 1; l < n; l++)
            if (scores[l] > best) best = scores[l], bi = l;
        if (bi != k) {
            int bs = scores[bi], bo = order[bi];
            for (int l = bi; l > k; l--) {
                scores[l] = scores[l - 1];
                order[l] = order[l - 1];
            }
            scores[k] = bs;
            order[k] = bo;
        }
    }
    return kPaletteColorContext[scores[0] + scores[1] * 2 + scores[2] * 2];
}

}  // namespace av1
