// AV1 OBUs, the sequence header and a key frame's uncompressed header
// (AV1 specification sections 5.3-5.11 and 7.5-7.21), the frame's tiles
// handed to av1entropy.cpp, then the loop filters of av1filter.cpp. Only
// the first frame of a stream is decoded, as libavif decodes an AVIF
// item or a sequence's first sample. Tools no file here uses are refused
// by name.

#include "av1.h"

#include "av1tables.h"

namespace av1 {

const uint8_t kNum4x4W[BLOCK_SIZES] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4,
                                       2, 8, 4, 16};
const uint8_t kNum4x4H[BLOCK_SIZES] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1,
                                       8, 2, 16, 4};
const uint8_t kMiWidthLog2[BLOCK_SIZES] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2,
                                           1, 3, 2, 4};
const uint8_t kMiHeightLog2[BLOCK_SIZES] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0,
                                            3, 1, 4, 2};
const uint8_t kTxW[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32,
                                    16, 64};
const uint8_t kTxH[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8,
                                    64, 16};
const uint8_t kTxWLog2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t kTxHLog2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
const uint8_t kMaxTxSizeRect[BLOCK_SIZES] = {
    TX_4X4,   TX_4X8,   TX_8X4,   TX_8X8,   TX_8X16,  TX_16X8,  TX_16X16, TX_16X32,
    TX_32X16, TX_32X32, TX_32X64, TX_64X32, TX_64X64, TX_64X64, TX_64X64, TX_64X64,
    TX_4X16,  TX_16X4,  TX_8X32,  TX_32X8,  TX_16X64, TX_64X16};
const uint8_t kSplitTxSize[TX_SIZES_ALL] = {
    TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,   TX_4X4,
    TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
const uint8_t kTxSizeSqr[TX_SIZES_ALL] = {
    TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16,
    TX_16X16, TX_32X32, TX_32X32, TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16};
const uint8_t kTxSizeSqrUp[TX_SIZES_ALL] = {
    TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32,
    TX_32X32, TX_64X64, TX_64X64, TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_64X64, TX_64X64};

int block_size(int w, int h) {
    for (int b = 0; b < BLOCK_SIZES; b++)
        if (kNum4x4W[b] * 4 == w && kNum4x4H[b] * 4 == h) return b;
    return BLOCK_INVALID;
}

int tx_size(int w, int h) {
    for (int t = 0; t < TX_SIZES_ALL; t++)
        if (kTxW[t] == w && kTxH[t] == h) return t;
    return -1;
}

void init_cdfs(Cdfs& c, int base_q_idx) {
#define CP(dst, src) static_assert(sizeof(c.dst) == sizeof(src), #dst); \
    std::memcpy(c.dst, src, sizeof(c.dst))
    CP(kf_y_mode, kCdfKfYMode);
    CP(uv_mode_no_cfl, kCdfUvModeCflNotAllowed);
    CP(uv_mode_cfl, kCdfUvModeCflAllowed);
    CP(partition_w8, kCdfPartitionW8);
    CP(partition_w16, kCdfPartitionW16);
    CP(partition_w32, kCdfPartitionW32);
    CP(partition_w64, kCdfPartitionW64);
    CP(partition_w128, kCdfPartitionW128);
    CP(cfl_alpha, kCdfCflAlpha);
    CP(cfl_sign, kCdfCflSign);
    CP(angle_delta, kCdfAngleDelta);
    CP(filter_intra_mode, kCdfFilterIntraMode);
    CP(use_filter_intra, kCdfUseFilterIntra);
    CP(segment_id, kCdfSegmentId);
    CP(skip, kCdfSkip);
    CP(intra_tx_set1, kCdfIntraTxSet1);
    CP(intra_tx_set2, kCdfIntraTxSet2);
    CP(tx8, kCdfTx8x8);
    CP(tx16, kCdfTx16x16);
    CP(tx32, kCdfTx32x32);
    CP(tx64, kCdfTx64x64);
    CP(delta_q, kCdfDeltaQ);
    CP(delta_lf, kCdfDeltaLf);
    CP(delta_lf_multi, kCdfDeltaLfMulti);
    CP(palette_y_mode, kCdfPaletteYMode);
    CP(palette_uv_mode, kCdfPaletteUvMode);
    CP(palette_y_size, kCdfPaletteYSize);
    CP(palette_uv_size, kCdfPaletteUvSize);
    CP(palette_y_color, kCdfPaletteYColor);
    CP(palette_uv_color, kCdfPaletteUvColor);
    CP(restoration_type, kCdfRestorationType);
    CP(use_wiener, kCdfUseWiener);
    CP(use_sgrproj, kCdfUseSgrproj);
    CP(intrabc, kCdfIntrabc);
    CP(inter_tx_set1, kCdfInterTxSet1);
    CP(inter_tx_set2, kCdfInterTxSet2);
    CP(inter_tx_set3, kCdfInterTxSet3);
    CP(txfm_split, kCdfTxfmSplit);
    CP(mv_joint, kCdfMvJoint);
    for (int comp = 0; comp < 2; comp++) {
        CP(mv_class[comp], kCdfMvClass);
        CP(mv_sign[comp], kCdfMvSign);
        CP(mv_class0_bit[comp], kCdfMvClass0Bit);
        CP(mv_bit[comp], kCdfMvBit);
    }
    const int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
    CP(txb_skip, kCdfTxbSkip[q]);
    CP(eob_pt16, kCdfEobPt16[q]);
    CP(eob_pt32, kCdfEobPt32[q]);
    CP(eob_pt64, kCdfEobPt64[q]);
    CP(eob_pt128, kCdfEobPt128[q]);
    CP(eob_pt256, kCdfEobPt256[q]);
    CP(eob_pt512, kCdfEobPt512[q]);
    CP(eob_pt1024, kCdfEobPt1024[q]);
    CP(eob_extra, kCdfEobExtra[q]);
    CP(coeff_base_eob, kCdfCoeffBaseEob[q]);
    CP(coeff_base, kCdfCoeffBase[q]);
    CP(coeff_br, kCdfCoeffBr[q]);
    CP(dc_sign, kCdfDcSign[q]);
#undef CP
}

namespace {

struct BitReader {
    const uint8_t* p;
    size_t size, pos = 0;  // pos in bits
    BitReader(const uint8_t* d, size_t n) : p(d), size(n) {}
    int f(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            if ((pos >> 3) >= size) corrupt("AV1 header runs past its OBU");
            v = v << 1 | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
            pos++;
        }
        return (int)v;
    }
    uint32_t f32() { return (uint32_t)f(16) << 16 | (uint32_t)f(16); }
    int su(int n) {
        int v = f(n), m = 1 << (n - 1);
        return (v & m) ? v - 2 * m : v;
    }
    int ns(int n) {
        int w = floor_log2(n) + 1, m = (1 << w) - n;
        int v = f(w - 1);
        return v < m ? v : (v << 1) - m + f(1);
    }
    uint32_t uvlc() {
        int lead = 0;
        while (!f(1))
            if (++lead >= 32) corrupt("AV1 uvlc too long");
        return lead ? ((1u << lead) - 1) + (uint32_t)f(lead) : 0;
    }
    void byte_align() { pos = (pos + 7) & ~(size_t)7; }
};

uint64_t leb128(const uint8_t* p, size_t n, size_t& at) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) {
        if (at >= n) corrupt("AV1 OBU size runs past the data");
        uint8_t b = p[at++];
        v |= (uint64_t)(b & 0x7f) << (i * 7);
        if (!(b & 0x80)) return v;
    }
    corrupt("AV1 OBU size too long");
}

void color_config(BitReader& br, SequenceHeader& s) {
    int high = br.f(1);
    if (s.profile == 2 && high) s.bit_depth = br.f(1) ? 12 : 10;
    else s.bit_depth = high ? 10 : 8;
    s.mono_chrome = s.profile == 1 ? 0 : br.f(1);
    s.num_planes = s.mono_chrome ? 1 : 3;
    s.color_description_present = br.f(1);
    if (s.color_description_present) {
        s.color_primaries = br.f(8);
        s.transfer_characteristics = br.f(8);
        s.matrix_coefficients = br.f(8);
    }
    if (s.mono_chrome) {
        s.color_range = br.f(1);
        s.subsampling_x = s.subsampling_y = 1;
        s.separate_uv_delta_q = 0;
        return;
    }
    if (s.color_primaries == 1 && s.transfer_characteristics == 13 &&
        s.matrix_coefficients == 0) {
        s.color_range = 1;
        s.subsampling_x = s.subsampling_y = 0;
    } else {
        s.color_range = br.f(1);
        if (s.profile == 0) {
            s.subsampling_x = s.subsampling_y = 1;
        } else if (s.profile == 1) {
            s.subsampling_x = s.subsampling_y = 0;
        } else if (s.bit_depth == 12) {
            s.subsampling_x = br.f(1);
            s.subsampling_y = s.subsampling_x ? br.f(1) : 0;
        } else {
            s.subsampling_x = 1;
            s.subsampling_y = 0;
        }
        if (s.subsampling_x && s.subsampling_y) s.chroma_sample_position = br.f(2);
    }
    s.separate_uv_delta_q = br.f(1);
}

void sequence_header(BitReader& br, SequenceHeader& s) {
    s = SequenceHeader();
    s.profile = br.f(3);
    if (s.profile > 2) corrupt("AV1 sequence profile out of range");
    s.still_picture = br.f(1);
    s.reduced_still_picture_header = br.f(1);
    if (s.reduced_still_picture_header) {
        s.operating_points = 1;
        s.operating_point_idc[0] = 0;
        br.f(5);  // seq_level_idx
    } else {
        s.timing_info_present = br.f(1);
        if (s.timing_info_present) {
            br.f32();
            br.f32();
            s.equal_picture_interval = br.f(1);
            if (s.equal_picture_interval) br.uvlc();
            s.decoder_model_info_present = br.f(1);
            if (s.decoder_model_info_present) {
                s.buffer_delay_length = br.f(5) + 1;
                br.f32();
                s.buffer_removal_time_length = br.f(5) + 1;
                s.frame_presentation_time_length = br.f(5) + 1;
            }
        }
        int initial_display_delay_present = br.f(1);
        s.operating_points = br.f(5) + 1;
        for (int i = 0; i < s.operating_points; i++) {
            s.operating_point_idc[i] = br.f(12);
            int level = br.f(5);
            if (level > 7) br.f(1);
            if (s.decoder_model_info_present) {
                s.decoder_model_present_for_op[i] = br.f(1);
                if (s.decoder_model_present_for_op[i]) {
                    br.f(s.buffer_delay_length);
                    br.f(s.buffer_delay_length);
                    br.f(1);
                }
            }
            if (initial_display_delay_present && br.f(1)) br.f(4);
        }
    }
    s.frame_width_bits = br.f(4) + 1;
    s.frame_height_bits = br.f(4) + 1;
    s.max_frame_width = br.f(s.frame_width_bits) + 1;
    s.max_frame_height = br.f(s.frame_height_bits) + 1;
    s.frame_id_numbers_present = s.reduced_still_picture_header ? 0 : br.f(1);
    if (s.frame_id_numbers_present) {
        s.delta_frame_id_length = br.f(4) + 2;
        s.additional_frame_id_length = br.f(3) + 1;
    }
    s.use_128x128 = br.f(1);
    s.enable_filter_intra = br.f(1);
    s.enable_intra_edge_filter = br.f(1);
    if (!s.reduced_still_picture_header) {
        br.f(1);  // enable_interintra_compound
        br.f(1);  // enable_masked_compound
        br.f(1);  // enable_warped_motion
        br.f(1);  // enable_dual_filter
        s.enable_order_hint = br.f(1);
        if (s.enable_order_hint) {
            br.f(1);  // enable_jnt_comp
            br.f(1);  // enable_ref_frame_mvs
        }
        s.seq_force_screen_content_tools = br.f(1) ? 2 : br.f(1);
        if (s.seq_force_screen_content_tools > 0)
            s.seq_force_integer_mv = br.f(1) ? 2 : br.f(1);
        else
            s.seq_force_integer_mv = 2;
        if (s.enable_order_hint) s.order_hint_bits = br.f(3) + 1;
    }
    s.enable_superres = br.f(1);
    s.enable_cdef = br.f(1);
    s.enable_restoration = br.f(1);
    color_config(br, s);
    s.film_grain_params_present = br.f(1);
}

int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
}

void tile_info(BitReader& br, const SequenceHeader& s, FrameHeader& f) {
    int sb_cols = s.use_128x128 ? (f.mi_cols + 31) >> 5 : (f.mi_cols + 15) >> 4;
    int sb_rows = s.use_128x128 ? (f.mi_rows + 31) >> 5 : (f.mi_rows + 15) >> 4;
    int sb_shift = s.use_128x128 ? 5 : 4, sb_size = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
    int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
    int min_log2_tiles = std::max(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    if (br.f(1)) {  // uniform_tile_spacing_flag
        f.tile_cols_log2 = min_log2_tile_cols;
        while (f.tile_cols_log2 < max_log2_tile_cols && br.f(1)) f.tile_cols_log2++;
        int w = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2;
        int i = 0;
        for (int start = 0; start < sb_cols; start += w) f.mi_col_starts[i++] = start << sb_shift;
        f.mi_col_starts[i] = f.mi_cols;
        f.tile_cols = i;
        int min_log2_tile_rows = std::max(min_log2_tiles - f.tile_cols_log2, 0);
        f.tile_rows_log2 = min_log2_tile_rows;
        while (f.tile_rows_log2 < max_log2_tile_rows && br.f(1)) f.tile_rows_log2++;
        int h = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
        i = 0;
        for (int start = 0; start < sb_rows; start += h) f.mi_row_starts[i++] = start << sb_shift;
        f.mi_row_starts[i] = f.mi_rows;
        f.tile_rows = i;
    } else {
        int widest = 0, start = 0, i = 0;
        for (; start < sb_cols; i++) {
            if (i >= 64) corrupt("AV1 too many tile columns");
            f.mi_col_starts[i] = start << sb_shift;
            int size = br.ns(std::min(sb_cols - start, max_tile_width_sb)) + 1;
            widest = std::max(size, widest);
            start += size;
        }
        f.mi_col_starts[i] = f.mi_cols;
        f.tile_cols = i;
        f.tile_cols_log2 = tile_log2(1, f.tile_cols);
        int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                      : sb_rows * sb_cols;
        int max_h = std::max(area / widest, 1);
        start = 0;
        i = 0;
        for (; start < sb_rows; i++) {
            if (i >= 64) corrupt("AV1 too many tile rows");
            f.mi_row_starts[i] = start << sb_shift;
            start += br.ns(std::min(sb_rows - start, max_h)) + 1;
        }
        f.mi_row_starts[i] = f.mi_rows;
        f.tile_rows = i;
        f.tile_rows_log2 = tile_log2(1, f.tile_rows);
    }
    if (f.tile_cols_log2 > 0 || f.tile_rows_log2 > 0) {
        f.context_update_tile_id = br.f(f.tile_rows_log2 + f.tile_cols_log2);
        f.tile_size_bytes = br.f(2) + 1;
    }
}

int read_delta_q(BitReader& br) { return br.f(1) ? br.su(7) : 0; }

int qindex(const FrameHeader& f, int seg) {
    if (f.segmentation_enabled && f.feature_enabled[seg][0])
        return clip3(0, 255, f.base_q_idx + f.feature_data[seg][0]);
    return f.base_q_idx;
}

// film_grain_params (5.9.30) of a key frame (update_grain is 1), with
// dav1d's checks: at most 14 luma and 10 chroma points, point values
// rising, and in 4:2:0 both chroma planes or neither.
void film_grain_params(BitReader& br, const SequenceHeader& s, FilmGrain& g) {
    g = FilmGrain();
    g.apply = br.f(1);
    if (!g.apply) return;
    g.seed = br.f(16);
    g.num_y = br.f(4);
    if (g.num_y > 14) corrupt("AV1 film grain of more than 14 luma points");
    for (int i = 0; i < g.num_y; i++) {
        g.y_points[i][0] = (uint8_t)br.f(8);
        if (i && g.y_points[i - 1][0] >= g.y_points[i][0]) corrupt("AV1 film grain points out of order");
        g.y_points[i][1] = (uint8_t)br.f(8);
    }
    g.chroma_from_luma = s.mono_chrome ? 0 : br.f(1);
    if (!(s.mono_chrome || g.chroma_from_luma ||
          (s.subsampling_x && s.subsampling_y && !g.num_y))) {
        for (int pl = 0; pl < 2; pl++) {
            g.num_uv[pl] = br.f(4);
            if (g.num_uv[pl] > 10) corrupt("AV1 film grain of more than 10 chroma points");
            for (int i = 0; i < g.num_uv[pl]; i++) {
                g.uv_points[pl][i][0] = (uint8_t)br.f(8);
                if (i && g.uv_points[pl][i - 1][0] >= g.uv_points[pl][i][0])
                    corrupt("AV1 film grain points out of order");
                g.uv_points[pl][i][1] = (uint8_t)br.f(8);
            }
        }
    }
    if (s.subsampling_x && s.subsampling_y && !g.num_uv[0] != !g.num_uv[1])
        corrupt("AV1 film grain on one chroma plane of a 4:2:0 frame");
    g.scaling_shift = br.f(2) + 8;
    g.ar_lag = br.f(2);
    int num_pos = 2 * g.ar_lag * (g.ar_lag + 1);
    if (g.num_y)
        for (int i = 0; i < num_pos; i++) g.ar_y[i] = (int8_t)(br.f(8) - 128);
    for (int pl = 0; pl < 2; pl++)
        if (g.num_uv[pl] || g.chroma_from_luma)
            for (int i = 0; i < num_pos + !!g.num_y; i++) g.ar_uv[pl][i] = (int8_t)(br.f(8) - 128);
    g.ar_shift = br.f(2) + 6;
    g.grain_scale_shift = br.f(2);
    for (int pl = 0; pl < 2; pl++)
        if (g.num_uv[pl]) {
            g.uv_mult[pl] = br.f(8) - 128;
            g.uv_luma_mult[pl] = br.f(8) - 128;
            g.uv_offset[pl] = br.f(9) - 256;
        }
    g.overlap = br.f(1);
    g.clip_restricted = br.f(1);
}

void frame_header(BitReader& br, const SequenceHeader& s, FrameHeader& f, int temporal_id,
                  int spatial_id) {
    f = FrameHeader();
    if (s.reduced_still_picture_header) {
        f.frame_type = 0;
        f.show_frame = 1;
    } else {
        if (br.f(1)) unsupported("an AV1 stream that starts by showing an existing frame");
        f.frame_type = br.f(2);
        if (f.frame_type != 0) unsupported("an AV1 stream whose first frame is not a key frame");
        f.show_frame = br.f(1);
        if (!f.show_frame) unsupported("an AV1 key frame that is not shown");
        if (s.decoder_model_info_present && !s.equal_picture_interval)
            br.f(s.frame_presentation_time_length);
        f.error_resilient_mode = 1;
    }
    f.disable_cdf_update = br.f(1);
    f.allow_screen_content_tools =
        s.seq_force_screen_content_tools == 2 ? br.f(1) : s.seq_force_screen_content_tools;
    if (f.allow_screen_content_tools && s.seq_force_integer_mv == 2) br.f(1);
    if (s.frame_id_numbers_present)
        br.f(s.additional_frame_id_length + s.delta_frame_id_length);
    int frame_size_override = s.reduced_still_picture_header ? 0 : br.f(1);
    br.f(s.order_hint_bits);  // order_hint
    if (s.decoder_model_info_present) {
        if (br.f(1)) {  // buffer_removal_time_present_flag
            for (int op = 0; op < s.operating_points; op++) {
                if (!s.decoder_model_present_for_op[op]) continue;
                int idc = s.operating_point_idc[op];
                if (idc == 0 || (((idc >> temporal_id) & 1) && ((idc >> (spatial_id + 8)) & 1)))
                    br.f(s.buffer_removal_time_length);
            }
        }
    }
    // A shown key frame refreshes every reference: no refresh_frame_flags.
    if (frame_size_override) {
        f.frame_width = br.f(s.frame_width_bits) + 1;
        f.frame_height = br.f(s.frame_height_bits) + 1;
    } else {
        f.frame_width = s.max_frame_width;
        f.frame_height = s.max_frame_height;
    }
    // superres_params (5.9.8): the frame is coded at the downscaled width,
    // at least 16 samples (or the upscaled width below that), as dav1d
    // and libaom hold it.
    f.upscaled_width = f.frame_width;
    f.use_superres = s.enable_superres ? br.f(1) : 0;
    if (f.use_superres) {
        f.superres_denom = br.f(3) + 9;
        f.frame_width = std::max((f.upscaled_width * 8 + f.superres_denom / 2) / f.superres_denom,
                                 std::min(16, f.upscaled_width));
    }
    f.mi_cols = 2 * ((f.frame_width + 7) >> 3);
    f.mi_rows = 2 * ((f.frame_height + 7) >> 3);
    if (br.f(1)) {  // render_and_frame_size_different
        f.render_width = br.f(16) + 1;
        f.render_height = br.f(16) + 1;
    } else {
        f.render_width = f.upscaled_width;
        f.render_height = f.frame_height;
    }
    // dav1d reads it without superres (the specification: where the widths
    // are equal, which superres at 16 samples or fewer leaves them).
    if (f.allow_screen_content_tools && !f.use_superres) f.allow_intrabc = br.f(1);
    f.disable_frame_end_update_cdf =
        (s.reduced_still_picture_header || f.disable_cdf_update) ? 1 : br.f(1);
    tile_info(br, s, f);
    // quantization_params
    f.base_q_idx = br.f(8);
    f.delta_q_y_dc = read_delta_q(br);
    if (s.num_planes > 1) {
        int diff_uv = s.separate_uv_delta_q ? br.f(1) : 0;
        f.delta_q_u_dc = read_delta_q(br);
        f.delta_q_u_ac = read_delta_q(br);
        if (diff_uv) {
            f.delta_q_v_dc = read_delta_q(br);
            f.delta_q_v_ac = read_delta_q(br);
        } else {
            f.delta_q_v_dc = f.delta_q_u_dc;
            f.delta_q_v_ac = f.delta_q_u_ac;
        }
    }
    f.using_qmatrix = br.f(1);
    if (f.using_qmatrix) {
        f.qm_y = br.f(4);
        f.qm_u = br.f(4);  // read for a monochrome stream too
        f.qm_v = s.separate_uv_delta_q ? br.f(4) : f.qm_u;
    }
    // segmentation_params
    static const int bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
    static const int sign[8] = {1, 1, 1, 1, 1, 0, 0, 0};
    static const int maxv[8] = {255, 63, 63, 63, 63, 7, 0, 0};
    f.segmentation_enabled = br.f(1);
    if (f.segmentation_enabled) {
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
                int v = 0;
                f.feature_enabled[i][j] = br.f(1);
                if (f.feature_enabled[i][j]) {
                    if (sign[j]) v = clip3(-maxv[j], maxv[j], br.su(1 + bits[j]));
                    else v = clip3(0, maxv[j], br.f(bits[j]));
                }
                f.feature_data[i][j] = v;
            }
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
                if (f.feature_enabled[i][j]) {
                    f.last_active_seg_id = i;
                    if (j >= 5) f.seg_id_pre_skip = 1;
                }
    }
    // delta_q_params, delta_lf_params
    if (f.base_q_idx > 0) f.delta_q_present = br.f(1);
    if (f.delta_q_present) {
        f.delta_q_res = br.f(2);
        f.delta_lf_present = f.allow_intrabc ? 0 : br.f(1);
        if (f.delta_lf_present) {
            f.delta_lf_res = br.f(2);
            f.delta_lf_multi = br.f(1);
        }
    }
    f.coded_lossless = 1;
    for (int seg = 0; seg < 8; seg++) {
        int q = qindex(f, seg);
        f.lossless_array[seg] = q == 0 && !f.delta_q_y_dc && !f.delta_q_u_ac &&
                                !f.delta_q_u_dc && !f.delta_q_v_ac && !f.delta_q_v_dc;
        if (!f.lossless_array[seg]) f.coded_lossless = 0;
    }
    f.all_lossless = f.coded_lossless && f.frame_width == f.upscaled_width;
    // loop_filter_params (intra block copy turns off every loop filter)
    if (!f.coded_lossless && !f.allow_intrabc) {
        f.loop_filter_level[0] = br.f(6);
        f.loop_filter_level[1] = br.f(6);
        if (s.num_planes > 1 && (f.loop_filter_level[0] || f.loop_filter_level[1])) {
            f.loop_filter_level[2] = br.f(6);
            f.loop_filter_level[3] = br.f(6);
        }
        f.loop_filter_sharpness = br.f(3);
        f.loop_filter_delta_enabled = br.f(1);
        if (f.loop_filter_delta_enabled && br.f(1)) {
            for (int i = 0; i < 8; i++)
                if (br.f(1)) f.loop_filter_ref_deltas[i] = br.su(7);
            for (int i = 0; i < 2; i++)
                if (br.f(1)) f.loop_filter_mode_deltas[i] = br.su(7);
        }
    }
    // cdef_params
    if (!f.coded_lossless && !f.allow_intrabc && s.enable_cdef) {
        f.cdef_damping = br.f(2) + 3;
        f.cdef_bits = br.f(2);
        for (int i = 0; i < (1 << f.cdef_bits); i++) {
            f.cdef_y_pri[i] = br.f(4);
            f.cdef_y_sec[i] = br.f(2);
            if (f.cdef_y_sec[i] == 3) f.cdef_y_sec[i]++;
            if (s.num_planes > 1) {
                f.cdef_uv_pri[i] = br.f(4);
                f.cdef_uv_sec[i] = br.f(2);
                if (f.cdef_uv_sec[i] == 3) f.cdef_uv_sec[i]++;
            }
        }
    }
    // lr_params
    if (!f.all_lossless && !f.allow_intrabc && s.enable_restoration) {
        static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                                     RESTORE_SGRPROJ};
        int chroma = 0;
        for (int i = 0; i < s.num_planes; i++) {
            f.frame_restoration_type[i] = remap[br.f(2)];
            if (f.frame_restoration_type[i] != RESTORE_NONE) {
                f.uses_lr = 1;
                if (i > 0) chroma = 1;
            }
        }
        if (f.uses_lr) {
            int shift;
            if (s.use_128x128) {
                shift = br.f(1) + 1;
            } else {
                shift = br.f(1);
                if (shift) shift += br.f(1);
            }
            f.loop_restoration_size[0] = 256 >> (2 - shift);
            int uv_shift = (s.subsampling_x && s.subsampling_y && chroma) ? br.f(1) : 0;
            f.loop_restoration_size[1] = f.loop_restoration_size[2] =
                f.loop_restoration_size[0] >> uv_shift;
        }
    }
    // read_tx_mode
    if (f.coded_lossless) f.only_4x4 = 1;
    else f.tx_mode_select = br.f(1);
    f.reduced_tx_set = br.f(1);
    // film_grain_params: a key frame is shown, so they are read.
    if (s.film_grain_params_present) film_grain_params(br, s, f.grain);
}

void tile_group(Decoder& d, const uint8_t* data, size_t size, int& next_tile) {
    FrameHeader& f = d.fh;
    BitReader br(data, size);
    int num_tiles = f.tile_cols * f.tile_rows, start = 0, end = num_tiles - 1;
    if (num_tiles > 1 && br.f(1)) {
        int bits = f.tile_cols_log2 + f.tile_rows_log2;
        start = br.f(bits);
        end = br.f(bits);
    }
    if (start != next_tile || end < start || end >= num_tiles) corrupt("AV1 tile group out of order");
    br.byte_align();
    size_t at = br.pos >> 3;
    for (int t = start; t <= end; t++) {
        size_t tile_size;
        if (t == end) {
            tile_size = size - at;
        } else {
            if (at + f.tile_size_bytes > size) corrupt("AV1 tile size runs past the data");
            tile_size = 0;
            for (int i = 0; i < f.tile_size_bytes; i++) tile_size |= (size_t)data[at + i] << (8 * i);
            tile_size += 1;
            at += f.tile_size_bytes;
            if (tile_size > size - at) corrupt("AV1 tile runs past the data");
        }
        decode_tile(d, data + at, tile_size, t / f.tile_cols, t % f.tile_cols);
        at += tile_size;
    }
    next_tile = end + 1;
}

}  // namespace

void alloc_plane(Plane& p, int w, int h, int bytes) {
    p.width = w;
    p.height = h;
    p.stride = w + 192;
    p.buf.assign((size_t)p.stride * (h + 160) * bytes, 0);
}

void setup_frame(Decoder& d) {
    const SequenceHeader& s = d.seq;
    const FrameHeader& f = d.fh;
    d.mi_rows = f.mi_rows;
    d.mi_cols = f.mi_cols;
    for (int p = 0; p < s.num_planes; p++) {
        int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
        alloc_plane(d.cur[p], (f.mi_cols * 4) >> sx, (f.mi_rows * 4) >> sy,
                    s.bit_depth > 8 ? 2 : 1);
    }
    size_t n = (size_t)f.mi_rows * f.mi_cols;
    d.blocks.clear();
    d.blocks.reserve(n / 4 + 16);
    d.mi_block.assign(n, -1);
    d.inter_tx_size.assign(n, 0);
    d.tx_types.assign(n, 0);
    for (int p = 0; p < 3; p++) d.lf_tx_size[p].assign(n, 0);
    d.cdef_stride = (f.mi_cols + 15) / 16 + 1;
    d.cdef_idx.assign((size_t)d.cdef_stride * ((f.mi_rows + 15) / 16 + 1), -1);
    for (int p = 0; p < s.num_planes; p++) {
        if (f.frame_restoration_type[p] == RESTORE_NONE) continue;
        int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
        int unit = f.loop_restoration_size[p];
        auto count = [&](int size) { return std::max((size + (unit >> 1)) / unit, 1); };
        d.lr_unit_rows[p] = count(round2(f.frame_height, sy));
        d.lr_unit_cols[p] = count(round2(f.upscaled_width, sx));
        size_t units = (size_t)d.lr_unit_rows[p] * d.lr_unit_cols[p];
        d.lr_type[p].assign(units, RESTORE_NONE);
        d.lr_sgr_set[p].assign(units, 0);
        d.lr_wiener[p].assign(units * 6, 0);
        d.lr_sgr_xqd[p].assign(units * 2, 0);
    }
}

void decode_frame_obus(Decoder& d, const uint8_t* data, size_t size) {
    size_t at = 0;
    int have_seq = 0, have_frame_header = 0, next_tile = 0;
    while (at < size) {
        uint8_t h = data[at++];
        if (h & 0x80) corrupt("AV1 OBU forbidden bit set");
        int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
        int temporal_id = 0, spatial_id = 0;
        if (ext) {
            if (at >= size) corrupt("AV1 OBU header cut");
            temporal_id = data[at] >> 5;
            spatial_id = (data[at] >> 3) & 3;
            at++;
        }
        size_t obu_size = has_size ? (size_t)leb128(data, size, at) : size - at;
        if (obu_size > size - at) corrupt("AV1 OBU runs past the data");
        const uint8_t* p = data + at;
        at += obu_size;
        if (type != 1 && type != 2 && ext && have_seq) {
            int idc = d.seq.operating_point_idc[0];
            if (idc && (!((idc >> temporal_id) & 1) || !((idc >> (spatial_id + 8)) & 1))) continue;
        }
        if (type == 1) {
            BitReader br(p, obu_size);
            sequence_header(br, d.seq);
            have_seq = 1;
        } else if (type == 3 || type == 6) {
            if (!have_seq) corrupt("AV1 frame before a sequence header");
            if (have_frame_header) {
                if (type == 3) continue;  // a redundant copy
                break;                    // the next frame: only the first is decoded
            }
            BitReader br(p, obu_size);
            frame_header(br, d.seq, d.fh, temporal_id, spatial_id);
            have_frame_header = 1;
            init_cdfs(d.frame_cdfs, d.fh.base_q_idx);
            setup_frame(d);
            if (type == 6) {
                br.byte_align();
                size_t hb = br.pos >> 3;
                tile_group(d, p + hb, obu_size - hb, next_tile);
            }
        } else if (type == 4) {
            if (!have_frame_header) corrupt("AV1 tile group before a frame header");
            tile_group(d, p, obu_size, next_tile);
        } else if (type == 7 || type == 2 || type == 5 || type == 15) {
            // redundant frame headers, temporal delimiters, metadata, padding
        } else if (type == 8) {
            unsupported("AV1 large-scale tile lists");
        }
        if (have_frame_header && next_tile == d.fh.tile_cols * d.fh.tile_rows) break;
    }
    if (!have_frame_header || next_tile != d.fh.tile_cols * d.fh.tile_rows)
        corrupt("AV1 stream ends before its first frame is whole");
    loop_filter_frame(d);
    cdef_frame(d);
    superres_frame(d);
    lr_frame(d);
    film_grain_frame(d);
}

}  // namespace av1

// -- the C entry point -------------------------------------------------------

namespace {

// Header fields the caller needs: info[0..11] = width, height, mono,
// subsampling_x, subsampling_y, matrix_coefficients, color_range,
// color_primaries, the luma, Cb and Cr quantizer matrix levels (15 for
// none), apply_grain; info[12..19] = base_q_idx, delta_q_present,
// delta_lf_present, using_qmatrix, tile_cols, tile_rows,
// allow_screen_content_tools, tx_mode_select; info[20] = the bit depth and
// info[21] the profile.
void fill_info(const av1::Decoder& d, int32_t* info) {
    info[0] = d.fh.upscaled_width;
    info[1] = d.fh.frame_height;
    info[2] = d.seq.mono_chrome;
    info[3] = d.seq.subsampling_x;
    info[4] = d.seq.subsampling_y;
    info[5] = d.seq.matrix_coefficients;
    info[6] = d.seq.color_range;
    info[7] = d.seq.color_primaries;
    info[8] = d.fh.using_qmatrix ? d.fh.qm_y : 15;
    info[9] = d.fh.using_qmatrix ? d.fh.qm_u : 15;
    info[10] = d.fh.using_qmatrix ? d.fh.qm_v : 15;
    info[11] = d.fh.grain.apply;
    info[12] = d.fh.base_q_idx;
    info[13] = d.fh.delta_q_present;
    info[14] = d.fh.delta_lf_present;
    info[15] = d.fh.using_qmatrix;
    info[16] = d.fh.tile_cols;
    info[17] = d.fh.tile_rows;
    info[18] = d.fh.allow_screen_content_tools;
    info[19] = d.fh.tx_mode_select;
    info[20] = d.seq.bit_depth;
    info[21] = d.seq.profile;
}

template <typename pixel>
void copy_plane(const av1::Plane& p, int w, int h, void* out) {
    for (int r = 0; r < h; r++)
        std::memcpy((pixel*)out + (size_t)r * w, p.px<pixel>(r), w * sizeof(pixel));
}

thread_local char g_error[256];

}  // namespace

extern "C" {

// Decode the first frame of an AV1 OBU stream (an AVIF item or a
// sequence's first sample) into planes of the frame's own (upscaled) size
// w x h (info[0], info[1]): y (w*h) and, unless monochrome, u and v
// (((w+sx)>>sx) * ((h+sy)>>sy)), of bytes at 8 bits and of uint16_t
// samples at 10 and 12; each buffer holds `capacity` samples of the
// wider kind. info as fill_info. Returns 0; -1 for a damaged stream, -3
// for a tool not supported yet, -4 when the frame needs buffers of more
// than `capacity` samples (info filled, nothing copied); av1_error() says
// why.
long av1_decode(const uint8_t* data, long size, long capacity, int32_t* info, void* y, void* u,
                void* v) {
    try {
        auto d = std::make_unique<av1::Decoder>();
        av1::decode_frame_obus(*d, data, (size_t)size);
        fill_info(*d, info);
        int w = info[0], h = info[1];
        if ((long)w * h > capacity) {
            std::snprintf(g_error, sizeof g_error, "the AV1 frame is %dx%d", w, h);
            return -4;
        }
        auto copy = d->seq.bit_depth > 8 ? copy_plane<uint16_t> : copy_plane<uint8_t>;
        copy(d->lr[0], w, h, y);
        if (!d->seq.mono_chrome) {
            int cw = (w + d->seq.subsampling_x) >> d->seq.subsampling_x;
            int ch = (h + d->seq.subsampling_y) >> d->seq.subsampling_y;
            copy(d->lr[1], cw, ch, u);
            copy(d->lr[2], cw, ch, v);
        }
        return 0;
    } catch (const av1::Error& e) {
        std::snprintf(g_error, sizeof g_error, "%s", e.what());
        return e.code == av1::kErrUnsupported ? -3 : -1;
    } catch (const std::bad_alloc&) {
        std::snprintf(g_error, sizeof g_error, "out of memory");
        return -1;
    }
}

const char* av1_error() { return g_error; }

}
