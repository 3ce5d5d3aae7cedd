// One AV1 tile of a key frame: the symbol decoder with CDF adaptation
// (AV1 specification 8.2), superblocks and their partitions, each
// block's intra mode info (segment id, skip, CDEF index, delta q and lf,
// y mode with angle delta, uv mode with CfL, palette with its colour
// cache and wavefront index map, filter intra, tx size), loop
// restoration units, and each transform block's coefficients (5.11.39),
// predicted and reconstructed in decode order through av1recon.cpp.

#include "av1.h"

#include "av1tables.h"

namespace av1 {

namespace {

// A palette block's samples: the colours its map (stride bw) names.
template <typename pixel>
void paint_palette(Plane& p, int x0, int y0, int w, int h, const uint16_t* pal,
                   const uint8_t* map, int bw) {
    for (int i = 0; i < h; i++) {
        pixel* out = p.px<pixel>(y0 + i) + x0;
        for (int j = 0; j < w; j++) out[j] = (pixel)pal[map[i * bw + j]];
    }
}

// -- the symbol decoder (libaom's windowed form of 8.2.2-8.2.6) ------------

struct Symbols {
    const uint8_t *bptr, *end;
    uint64_t dif;
    uint32_t rng;
    int cnt;
    bool update;

    void init(const uint8_t* buf, size_t n, bool allow_update) {
        bptr = buf;
        end = buf + n;
        dif = ((uint64_t)1 << 63) - 1;
        rng = 0x8000;
        cnt = -15;
        update = allow_update;
        refill();
    }
    void refill() {
        int s = 64 - 9 - (cnt + 15);
        for (; s >= 0 && bptr < end; s -= 8, bptr++) {
            dif ^= (uint64_t)bptr[0] << s;
            cnt += 8;
        }
        if (bptr >= end) cnt = 0x4000;
    }
    int normalize(uint64_t d, uint32_t r, int ret) {
        int n = 15 - floor_log2(r);
        cnt -= n;
        dif = ((d + 1) << n) - 1;
        rng = r << n;
        if (cnt < 0) refill();
        return ret;
    }
    int symbol(uint16_t* icdf, int n) {
        uint32_t c = (uint32_t)(dif >> 48), r = rng, u, v = r;
        int ret = -1;
        do {
            u = v;
            ret++;
            v = ((r >> 8) * (uint32_t)(icdf[ret] >> 6) >> 1) + 4 * (n - 1 - ret);
        } while (c < v);
        normalize(dif - ((uint64_t)v << 48), u - v, ret);
        if (update) adapt_cdf(icdf, n, ret);
        return ret;
    }
    int boolean() {  // read_bool: p = 1/2, no adaptation
        uint32_t c = (uint32_t)(dif >> 48), r = rng;
        uint32_t v = ((r >> 8) * (16384u >> 6) >> 1) + 4;
        if (c < v) return normalize(dif, v, 1);
        return normalize(dif - ((uint64_t)v << 48), r - v, 0);
    }
    int literal(int n) {
        int x = 0;
        for (int i = 0; i < n; i++) x = 2 * x + boolean();
        return x;
    }
    int ns(int n) {
        int w = floor_log2(n) + 1, m = (1 << w) - n;
        int v = literal(w - 1);
        return v < m ? v : (v << 1) - m + literal(1);
    }
};

const uint8_t kFilterIntraModeToIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const int kWienerTapsMin[3] = {-5, -23, -17}, kWienerTapsMax[3] = {10, 8, 46};
const int kWienerTapsK[3] = {1, 2, 3}, kWienerTapsMid[3] = {3, -7, 15};
const int kSgrprojXqdMin[2] = {-96, -32}, kSgrprojXqdMax[2] = {31, 95};
const int kSgrprojXqdMid[2] = {-32, 31};

int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
}

struct Tile {
    Decoder& d;
    const SequenceHeader& s;
    const FrameHeader& f;
    Cdfs c;
    Symbols sym;
    int row_start, row_end, col_start, col_end;
    int current_q, delta_lf[4] = {0};
    int ref_sgr_xqd[3][2], ref_lr_wiener[3][2][3];
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    uint8_t block_decoded[3][34][34];  // [plane][y + 1][x + 1]
    bool read_deltas = false;
    // The block being decoded.
    BlockInfo b;
    int mi_row, mi_col, bw4, bh4, has_chroma, avail_u, avail_l, avail_u_chroma,
        avail_l_chroma, lossless, max_luma_w, max_luma_h;
    uint8_t color_map[2][64 * 64];
    int32_t quant[1024];

    Tile(Decoder& dec, int tr, int tc) : d(dec), s(dec.seq), f(dec.fh) {
        c = d.frame_cdfs;
        row_start = f.mi_row_starts[tr];
        row_end = f.mi_row_starts[tr + 1];
        col_start = f.mi_col_starts[tc];
        col_end = f.mi_col_starts[tc + 1];
        current_q = f.base_q_idx;
        for (int p = 0; p < 3; p++) {
            above_level[p].assign(d.mi_cols + 64, 0);
            above_dc[p].assign(d.mi_cols + 64, 0);
            left_level[p].assign(d.mi_rows + 64, 0);
            left_dc[p].assign(d.mi_rows + 64, 0);
            for (int pass = 0; pass < 2; pass++) {
                ref_sgr_xqd[p][pass] = kSgrprojXqdMid[pass];
                for (int i = 0; i < 3; i++) ref_lr_wiener[p][pass][i] = kWienerTapsMid[i];
            }
        }
    }

    bool inside(int r, int col) const {
        return col >= col_start && col < col_end && r >= row_start && r < row_end;
    }
    const BlockInfo& at(int r, int col) const { return d.bi(r, col); }
    uint8_t& decoded(int plane, int y, int x) { return block_decoded[plane][y + 1][x + 1]; }

    int get_qindex(int ignore_delta, int seg) const {
        if (f.segmentation_enabled && f.feature_enabled[seg][0]) {
            int q = f.base_q_idx + f.feature_data[seg][0];
            if (!ignore_delta && f.delta_q_present) q = current_q + f.feature_data[seg][0];
            return clip3(0, 255, q);
        }
        if (!ignore_delta && f.delta_q_present) return current_q;
        return f.base_q_idx;
    }

    void run() {
        int sb4 = s.use_128x128 ? 32 : 16, sb_size = s.use_128x128 ? BLOCK_128X128 : BLOCK_64X64;
        for (int r = row_start; r < row_end; r += sb4) {
            for (int p = 0; p < 3; p++) {
                std::fill(left_level[p].begin(), left_level[p].end(), 0);
                std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
            }
            for (int col = col_start; col < col_end; col += sb4) {
                read_deltas = f.delta_q_present;
                // clear_cdef: set when read (the index is -1 until then).
                clear_block_decoded(r, col, sb4);
                read_lr(r, col, sb_size);
                decode_partition(r, col, sb_size);
            }
        }
    }

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

    // -- loop restoration units (5.11.57-58) --
    int subexp_bool(int num_syms, int k) {
        int i = 0, mk = 0;
        while (true) {
            int b2 = i ? k + i - 1 : k, a = 1 << b2;
            if (num_syms <= mk + 3 * a) return sym.ns(num_syms - mk) + mk;
            if (sym.literal(1)) {
                i++;
                mk += a;
            } else {
                return sym.literal(b2) + mk;
            }
        }
    }
    int signed_subexp_with_ref(int low, int high, int k, int r) {
        int mx = high - low;
        r -= low;
        int v = subexp_bool(mx, k);
        int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return x + low;
    }
    void read_lr(int r, int col, int bsize) {
        int w = kNum4x4W[bsize], h = kNum4x4H[bsize];
        for (int p = 0; p < s.num_planes; p++) {
            if (f.frame_restoration_type[p] == RESTORE_NONE) continue;
            int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
            int unit = f.loop_restoration_size[p];
            int rows = d.lr_unit_rows[p], cols = d.lr_unit_cols[p];
            int row0 = (r * (4 >> sy) + unit - 1) / unit;
            int row1 = std::min(rows, ((r + h) * (4 >> sy) + unit - 1) / unit);
            // Units are counted at the upscaled width: with superres, a
            // coded column is SuperresDenom / 8 upscaled ones (where the
            // widths differ, as dav1d reads them).
            int num = 4 >> sx, den = unit;
            if (f.frame_width != f.upscaled_width) num *= f.superres_denom, den *= 8;
            int col0 = (col * num + den - 1) / den;
            int col1 = std::min(cols, ((col + w) * num + den - 1) / den);
            for (int ur = row0; ur < row1; ur++)
                for (int uc = col0; uc < col1; uc++) read_lr_unit(p, ur * cols + uc);
        }
    }
    void read_lr_unit(int p, size_t u) {
        int type, ft = f.frame_restoration_type[p];
        if (ft == RESTORE_WIENER) type = sym.symbol(c.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        else if (ft == RESTORE_SGRPROJ)
            type = sym.symbol(c.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        else type = sym.symbol(c.restoration_type, 3);
        d.lr_type[p][u] = (uint8_t)type;
        if (type == RESTORE_WIENER) {
            for (int pass = 0; pass < 2; pass++) {
                int first = p ? 1 : 0;
                if (p) d.lr_wiener[p][u * 6 + pass * 3] = 0;
                for (int j = first; j < 3; j++) {
                    int v = signed_subexp_with_ref(kWienerTapsMin[j], kWienerTapsMax[j] + 1,
                                                   kWienerTapsK[j], ref_lr_wiener[p][pass][j]);
                    d.lr_wiener[p][u * 6 + pass * 3 + j] = (int8_t)v;
                    ref_lr_wiener[p][pass][j] = v;
                }
            }
        } else if (type == RESTORE_SGRPROJ) {
            int set = sym.literal(4);
            d.lr_sgr_set[p][u] = (uint8_t)set;
            for (int i = 0; i < 2; i++) {
                int radius = kSgrParams[set][i * 2], v;
                if (radius) {
                    v = signed_subexp_with_ref(kSgrprojXqdMin[i], kSgrprojXqdMax[i] + 1, 4,
                                               ref_sgr_xqd[p][i]);
                } else {
                    v = 0;
                    if (i == 1)
                        v = clip3(kSgrprojXqdMin[i], kSgrprojXqdMax[i], 128 - ref_sgr_xqd[p][0]);
                }
                d.lr_sgr_xqd[p][u * 2 + i] = (int16_t)v;
                ref_sgr_xqd[p][i] = v;
            }
        }
    }

    // -- partitions (5.11.4) --
    void decode_partition(int r, int col, int bsize) {
        if (r >= d.mi_rows || col >= d.mi_cols) return;
        int au = inside(r - 1, col), al = inside(r, col - 1);
        int n4 = kNum4x4W[bsize], half = n4 >> 1, quarter = half >> 1;
        int has_rows = (r + half) < d.mi_rows, has_cols = (col + half) < d.mi_cols;
        int partition;
        if (bsize < BLOCK_8X8) {
            partition = 0;
        } else {
            int bsl = kMiWidthLog2[bsize];
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
                partition = sym.symbol(cdf, nsym);
            } else if (has_cols || has_rows) {
                if (nsym == 4) corrupt("AV1 8x8 partition at a frame edge");
                uint16_t bcdf[3] = {(uint16_t)split_psum(cdf, bsize, has_cols), 0, 0};
                bool save = sym.update;
                sym.update = false;
                int split = sym.symbol(bcdf, 2);
                sym.update = save;
                partition = split ? 3 : (has_cols ? 1 : 2);
            } else {
                partition = 3;
            }
        }
        int sub = partition_subsize(partition, bsize), split = partition_subsize(3, bsize);
        if (sub == BLOCK_INVALID) corrupt("AV1 partition of an invalid size");
        switch (partition) {
            case 0: decode_block(r, col, sub); break;
            case 1:
                decode_block(r, col, sub);
                if (has_rows) decode_block(r + half, col, sub);
                break;
            case 2:
                decode_block(r, col, sub);
                if (has_cols) decode_block(r, col + half, sub);
                break;
            case 3:
                decode_partition(r, col, sub);
                decode_partition(r, col + half, sub);
                decode_partition(r + half, col, sub);
                decode_partition(r + half, col + half, sub);
                break;
            case 4:
                decode_block(r, col, split);
                decode_block(r, col + half, split);
                decode_block(r + half, col, sub);
                break;
            case 5:
                decode_block(r, col, sub);
                decode_block(r + half, col, split);
                decode_block(r + half, col + half, split);
                break;
            case 6:
                decode_block(r, col, split);
                decode_block(r + half, col, split);
                decode_block(r, col + half, sub);
                break;
            case 7:
                decode_block(r, col, sub);
                decode_block(r, col + half, split);
                decode_block(r + half, col + half, split);
                break;
            case 8:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || r + quarter * 3 < d.mi_rows) decode_block(r + quarter * i, col, sub);
                break;
            default:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || col + quarter * 3 < d.mi_cols) decode_block(r, col + quarter * i, sub);
                break;
        }
    }

    // -- one block (5.11.5) --
    void decode_block(int r, int col, int bsize) {
        mi_row = r;
        mi_col = col;
        b = BlockInfo();
        b.mi_size = (uint8_t)bsize;
        bw4 = kNum4x4W[bsize];
        bh4 = kNum4x4H[bsize];
        if (bh4 == 1 && s.subsampling_y && (r & 1) == 0) has_chroma = 0;
        else if (bw4 == 1 && s.subsampling_x && (col & 1) == 0) has_chroma = 0;
        else has_chroma = s.num_planes > 1;
        avail_u = inside(r - 1, col);
        avail_l = inside(r, col - 1);
        avail_u_chroma = avail_u;
        avail_l_chroma = avail_l;
        if (has_chroma) {
            if (s.subsampling_y && bh4 == 1) avail_u_chroma = inside(r - 2, col);
            if (s.subsampling_x && bw4 == 1) avail_l_chroma = inside(r, col - 2);
        } else {
            avail_u_chroma = avail_l_chroma = 0;
        }
        intra_frame_mode_info();
        palette_tokens();
        read_tx_size();
        if (b.skip) reset_block_context();
        // Store the block's mode info for its neighbours and the filters.
        int idx = (int)d.blocks.size();
        d.blocks.push_back(b);
        int rows = std::min(bh4, d.mi_rows - r), cols = std::min(bw4, d.mi_cols - col);
        for (int y = 0; y < rows; y++)
            for (int x = 0; x < cols; x++) d.mi_block[(size_t)(r + y) * d.mi_cols + col + x] = idx;
        if (b.is_inter)  // compute_prediction: the block copy's own vector serves every plane
            for (int p = 0; p < 1 + 2 * has_chroma; p++) {
                int psz = residual_size(b.mi_size, p);
                int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
                predict_intrabc(d, p, (col >> sx) * 4, (r >> sy) * 4, kNum4x4W[psz] * 4,
                                kNum4x4H[psz] * 4, b.mv);
            }
        residual();
    }

    void intra_segment_id() {
        if (f.segmentation_enabled) read_segment_id();
        else b.segment_id = 0;
        lossless = f.lossless_array[b.segment_id];
    }
    void read_segment_id() {
        int r = mi_row, col = mi_col;
        int prev_ul = (avail_u && avail_l) ? at(r - 1, col - 1).segment_id : -1;
        int prev_u = avail_u ? at(r - 1, col).segment_id : -1;
        int prev_l = avail_l ? at(r, col - 1).segment_id : -1;
        int pred;
        if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
        else if (prev_l == -1) pred = prev_u;
        else pred = prev_ul == prev_u ? prev_u : prev_l;
        if (b.skip) {
            b.segment_id = (uint8_t)pred;
            return;
        }
        int ctx;
        if (prev_ul < 0) ctx = 0;
        else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
        else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
        else ctx = 0;
        int v = sym.symbol(c.segment_id[ctx], 8), mx = f.last_active_seg_id + 1, seg;
        // neg_deinterleave
        if (!pred) seg = v;
        else if (pred >= mx - 1) seg = mx - v - 1;
        else if (2 * pred < mx) {
            if (v <= 2 * pred) seg = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
            else seg = v;
        } else {
            if (v <= 2 * (mx - pred - 1)) seg = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
            else seg = mx - (v + 1);
        }
        b.segment_id = (uint8_t)clip3(0, f.last_active_seg_id, seg);
    }

    void intra_frame_mode_info() {
        int r = mi_row, col = mi_col;
        b.skip = 0;
        if (f.seg_id_pre_skip) intra_segment_id();
        // read_skip
        if (f.seg_id_pre_skip && f.segmentation_enabled && f.feature_enabled[b.segment_id][6]) {
            b.skip = 1;
        } else {
            int ctx = (avail_u ? at(r - 1, col).skip : 0) + (avail_l ? at(r, col - 1).skip : 0);
            b.skip = (uint8_t)sym.symbol(c.skip[ctx], 2);
        }
        if (!f.seg_id_pre_skip) intra_segment_id();
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = false;
        for (int i = 0; i < 4; i++) b.delta_lf[i] = (int8_t)delta_lf[i];
        if (f.allow_intrabc && sym.symbol(c.intrabc, 2)) {
            b.is_inter = 1;  // y and uv modes stay DC_PRED
            intrabc_mv();
            return;
        }
        // intra_frame_y_mode
        int above = kIntraModeContext[avail_u ? at(r - 1, col).y_mode : DC_PRED];
        int left = kIntraModeContext[avail_l ? at(r, col - 1).y_mode : DC_PRED];
        b.y_mode = (uint8_t)sym.symbol(c.kf_y_mode[above][left], 13);
        int use_angle = b.mi_size >= BLOCK_8X8;
        auto directional = [](int m) { return m >= V_PRED && m <= D67_PRED; };
        if (use_angle && directional(b.y_mode))
            b.angle_delta_y = (int8_t)(sym.symbol(c.angle_delta[b.y_mode - V_PRED], 7) - 3);
        if (has_chroma) {
            int plane_sz = residual_size(b.mi_size, 1);
            int cfl_allowed;
            if (lossless && plane_sz == BLOCK_4X4) cfl_allowed = 1;
            else if (!lossless && std::max(bw4, bh4) * 4 <= 32) cfl_allowed = 1;
            else cfl_allowed = 0;
            b.uv_mode = (uint8_t)(cfl_allowed ? sym.symbol(c.uv_mode_cfl[b.y_mode], 14)
                                              : sym.symbol(c.uv_mode_no_cfl[b.y_mode], 13));
            if (b.uv_mode == UV_CFL_PRED) read_cfl_alphas();
            if (use_angle && directional(b.uv_mode))
                b.angle_delta_uv = (int8_t)(sym.symbol(c.angle_delta[b.uv_mode - V_PRED], 7) - 3);
        } else {
            b.uv_mode = DC_PRED;
        }
        if (b.mi_size >= BLOCK_8X8 && bw4 <= 16 && bh4 <= 16 && f.allow_screen_content_tools)
            palette_mode_info();
        if (s.enable_filter_intra && b.y_mode == DC_PRED && b.palette_size[0] == 0 &&
            std::max(bw4, bh4) <= 8) {
            b.use_filter_intra = (uint8_t)sym.symbol(c.use_filter_intra[b.mi_size], 2);
            if (b.use_filter_intra) b.filter_intra_mode = (uint8_t)sym.symbol(c.filter_intra_mode, 5);
        }
    }

    // -- intra block copy: the motion vector stack of an intra frame
    // (7.10.2, where only earlier block copies are candidates) and the
    // vector read against it (5.11.26, 5.11.32) --
    int stack_mv[8][2], stack_weight[8], num_mv = 0;
    bool found_match = false;
    void add_candidate(int r, int col, int weight) {
        const BlockInfo& cand = at(r, col);
        if (!cand.is_inter) return;
        int mv[2];
        for (int i = 0; i < 2; i++) {  // lower_mv_precision with force_integer_mv
            int a = (std::abs(cand.mv[i]) + 3) >> 3;
            mv[i] = cand.mv[i] > 0 ? a << 3 : -(a << 3);
        }
        found_match = true;
        int idx = 0;
        for (; idx < num_mv; idx++)
            if (stack_mv[idx][0] == mv[0] && stack_mv[idx][1] == mv[1]) break;
        if (idx < num_mv) {
            stack_weight[idx] += weight;
        } else if (num_mv < 8) {
            stack_mv[num_mv][0] = mv[0];
            stack_mv[num_mv][1] = mv[1];
            stack_weight[num_mv++] = weight;
        }
    }
    void scan_row(int delta_row) {
        int end4 = std::min(std::min(bw4, d.mi_cols - mi_col), 16), delta_col = 0;
        bool step16 = bw4 >= 16;
        if (std::abs(delta_row) > 1) {
            delta_row += mi_row & 1;
            delta_col = 1 - (mi_col & 1);
        }
        for (int i = 0; i < end4;) {
            int r = mi_row + delta_row, col = mi_col + delta_col + i;
            if (!inside(r, col)) break;
            int len = std::min<int>(bw4, kNum4x4W[at(r, col).mi_size]);
            if (std::abs(delta_row) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, col, len * 2);
            i += len;
        }
    }
    void scan_col(int delta_col) {
        int end4 = std::min(std::min(bh4, d.mi_rows - mi_row), 16), delta_row = 0;
        bool step16 = bh4 >= 16;
        if (std::abs(delta_col) > 1) {
            delta_row = 1 - (mi_row & 1);
            delta_col += mi_col & 1;
        }
        for (int i = 0; i < end4;) {
            int r = mi_row + delta_row + i, col = mi_col + delta_col;
            if (!inside(r, col)) break;
            int len = std::min<int>(bh4, kNum4x4H[at(r, col).mi_size]);
            if (std::abs(delta_col) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, col, len * 2);
            i += len;
        }
    }
    void scan_point(int delta_row, int delta_col) {
        int r = mi_row + delta_row, col = mi_col + delta_col;
        if (inside(r, col) && d.mi_block[(size_t)r * d.mi_cols + col] >= 0) add_candidate(r, col, 4);
    }
    void sort_stack(int start, int end) {
        while (end > start) {
            int new_end = start;
            for (int idx = start + 1; idx < end; idx++)
                if (stack_weight[idx - 1] < stack_weight[idx]) {
                    std::swap(stack_weight[idx - 1], stack_weight[idx]);
                    std::swap(stack_mv[idx - 1][0], stack_mv[idx][0]);
                    std::swap(stack_mv[idx - 1][1], stack_mv[idx][1]);
                    new_end = idx;
                }
            end = new_end;
        }
    }
    int read_mv_component(int comp) {
        int sign = sym.symbol(c.mv_sign[comp], 2);
        int cls = sym.symbol(c.mv_class[comp], 11), mag;
        if (cls == 0) {
            int bit = sym.symbol(c.mv_class0_bit[comp], 2);
            mag = ((bit << 3) | (3 << 1) | 1) + 1;
        } else {
            int dd = 0;
            for (int i = 0; i < cls; i++) dd |= sym.symbol(c.mv_bit[comp][i], 2) << i;
            mag = (2 << (cls + 2)) + ((dd << 3) | (3 << 1) | 1) + 1;
        }
        return sign ? -mag : mag;
    }
    void intrabc_mv() {
        num_mv = 0;
        found_match = false;
        scan_row(-1);
        found_match = false;
        scan_col(-1);
        found_match = false;
        if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
        int num_nearest = num_mv;
        for (int i = 0; i < num_nearest; i++) stack_weight[i] += 640;
        scan_point(-1, -1);
        scan_row(-3);
        scan_col(-3);
        if (bh4 > 1) scan_row(-5);
        if (bw4 > 1) scan_col(-5);
        sort_stack(0, num_nearest);
        sort_stack(num_nearest, num_mv);
        for (int i = num_mv; i < 2; i++) stack_mv[i][0] = stack_mv[i][1] = 0;
        for (int i = 0; i < num_mv; i++) {  // clamping
            int top = -(mi_row * 4 * 8), bottom = (d.mi_rows - bh4 - mi_row) * 4 * 8;
            int left = -(mi_col * 4 * 8), right = (d.mi_cols - bw4 - mi_col) * 4 * 8;
            stack_mv[i][0] = clip3(top - (128 + bh4 * 32), bottom + 128 + bh4 * 32, stack_mv[i][0]);
            stack_mv[i][1] = clip3(left - (128 + bw4 * 32), right + 128 + bw4 * 32, stack_mv[i][1]);
        }
        int pred[2] = {stack_mv[0][0], stack_mv[0][1]};
        if (!pred[0] && !pred[1]) pred[0] = stack_mv[1][0], pred[1] = stack_mv[1][1];
        if (!pred[0] && !pred[1]) {
            int sb4 = s.use_128x128 ? 32 : 16;
            if (mi_row - sb4 < row_start) {
                pred[0] = 0;
                pred[1] = -(sb4 * 4 + 256) * 8;
            } else {
                pred[0] = -(sb4 * 4 * 8);
                pred[1] = 0;
            }
        }
        int joint = sym.symbol(c.mv_joint, 4), diff[2] = {0, 0};
        if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
        if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
        b.mv[0] = (int16_t)(pred[0] + diff[0]);
        b.mv[1] = (int16_t)(pred[1] + diff[1]);
    }

    int residual_size(int bsize, int plane) const {
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int w = std::max(4, kNum4x4W[bsize] * 4 >> sx), h = std::max(4, kNum4x4H[bsize] * 4 >> sy);
        int bs = block_size(w, h);
        if (bs == BLOCK_INVALID) corrupt("AV1 block of no chroma size");
        return bs;
    }

    void read_cdef() {
        if (b.skip || f.coded_lossless || !s.enable_cdef || f.allow_intrabc) return;
        int r = mi_row & ~15, col = mi_col & ~15;
        int8_t& idx = d.cdef_idx[(size_t)(r >> 4) * d.cdef_stride + (col >> 4)];
        if (idx == -1) {
            idx = (int8_t)sym.literal(f.cdef_bits);
            for (int y = r; y < r + bh4; y += 16)
                for (int x = col; x < col + bw4; x += 16)
                    d.cdef_idx[(size_t)(y >> 4) * d.cdef_stride + (x >> 4)] = idx;
        }
    }

    void read_delta_qindex() {
        int sb = s.use_128x128 ? BLOCK_128X128 : BLOCK_64X64;
        if (b.mi_size == sb && b.skip) return;
        if (!read_deltas) return;
        int a = sym.symbol(c.delta_q, 4);
        if (a == 3) {
            int rem = sym.literal(3) + 1;
            a = sym.literal(rem) + (1 << rem) + 1;
        }
        if (a) {
            int sign = sym.literal(1);
            int reduced = sign ? -a : a;
            current_q = clip3(1, 255, current_q + (reduced << f.delta_q_res));
        }
    }

    void read_delta_lf() {
        int sb = s.use_128x128 ? BLOCK_128X128 : BLOCK_64X64;
        if (b.mi_size == sb && b.skip) return;
        if (!read_deltas || !f.delta_lf_present) return;
        int count = 1;
        if (f.delta_lf_multi) count = s.num_planes > 1 ? 4 : 2;
        for (int i = 0; i < count; i++) {
            int a = sym.symbol(f.delta_lf_multi ? c.delta_lf_multi[i] : c.delta_lf, 4);
            if (a == 3) {
                int n = sym.literal(3) + 1;
                a = sym.literal(n) + (1 << n) + 1;
            }
            if (a) {
                int sign = sym.literal(1);
                int reduced = sign ? -a : a;
                delta_lf[i] = clip3(-63, 63, delta_lf[i] + (reduced << f.delta_lf_res));
            }
        }
    }

    void read_cfl_alphas() {
        int signs = sym.symbol(c.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
            int a = 1 + sym.symbol(c.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
            b.cfl_alpha_u = (int8_t)(sign_u == 1 ? -a : a);
        }
        if (sign_v) {
            int a = 1 + sym.symbol(c.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
            b.cfl_alpha_v = (int8_t)(sign_v == 1 ? -a : a);
        }
    }

    // -- palette (5.11.46, 7.11.4) --
    void palette_mode_info() {
        int bsize_ctx = kMiWidthLog2[b.mi_size] + kMiHeightLog2[b.mi_size] - 2;
        int bd = s.bit_depth;
        if (b.y_mode == DC_PRED) {
            int ctx = (avail_u && at(mi_row - 1, mi_col).palette_size[0] > 0) +
                      (avail_l && at(mi_row, mi_col - 1).palette_size[0] > 0);
            if (sym.symbol(c.palette_y_mode[bsize_ctx][ctx], 2)) {
                int n = sym.symbol(c.palette_y_size[bsize_ctx], 7) + 2;
                b.palette_size[0] = (uint8_t)n;
                uint16_t cache[16], *col = b.palette_colors[0];
                int cn = av1::palette_cache(d, mi_row, mi_col, avail_u, avail_l, 0, cache), idx = 0;
                for (int i = 0; i < cn && idx < n; i++)
                    if (sym.literal(1)) col[idx++] = cache[i];
                if (idx < n) col[idx++] = (uint16_t)sym.literal(bd);
                int bits = 0;
                if (idx < n) bits = bd - 3 + sym.literal(2);
                while (idx < n) {
                    int delta = sym.literal(bits) + 1;
                    col[idx] = (uint16_t)std::min(col[idx - 1] + delta, (1 << bd) - 1);
                    int range = (1 << bd) - col[idx] - 1;
                    bits = std::min(bits, ceil_log2(range));
                    idx++;
                }
                std::sort(col, col + n);
            }
        }
        if (has_chroma && b.uv_mode == DC_PRED) {
            if (sym.symbol(c.palette_uv_mode[b.palette_size[0] > 0], 2)) {
                int n = sym.symbol(c.palette_uv_size[bsize_ctx], 7) + 2;
                b.palette_size[1] = (uint8_t)n;
                uint16_t cache[16], *u = b.palette_colors[1], *v = b.palette_colors[2];
                int cn = av1::palette_cache(d, mi_row, mi_col, avail_u, avail_l, 1, cache), idx = 0;
                for (int i = 0; i < cn && idx < n; i++)
                    if (sym.literal(1)) u[idx++] = cache[i];
                if (idx < n) u[idx++] = (uint16_t)sym.literal(bd);
                int bits = 0;
                if (idx < n) bits = bd - 3 + sym.literal(2);
                while (idx < n) {
                    int delta = sym.literal(bits);
                    u[idx] = (uint16_t)std::min(u[idx - 1] + delta, (1 << bd) - 1);
                    int range = (1 << bd) - u[idx];
                    idx++;
                    bits = std::min(bits, ceil_log2(range));
                }
                std::sort(u, u + n);
                if (sym.literal(1)) {
                    int max_val = 1 << bd;
                    int vbits = bd - 4 + sym.literal(2);
                    v[0] = (uint16_t)sym.literal(bd);
                    for (idx = 1; idx < n; idx++) {
                        int delta = sym.literal(vbits);
                        if (delta && sym.literal(1)) delta = -delta;
                        int val = v[idx - 1] + delta;
                        if (val < 0) val += max_val;
                        if (val >= max_val) val -= max_val;
                        v[idx] = (uint16_t)clip3(0, max_val - 1, val);
                    }
                } else {
                    for (idx = 0; idx < n; idx++) v[idx] = (uint16_t)sym.literal(bd);
                }
            }
        }
    }
    void color_map_tokens(uint8_t* map, int n, int bw, int bh, int onw, int onh, int plane) {
        map[0] = (uint8_t)sym.ns(n);
        uint16_t(*cdfs)[9] = plane ? c.palette_uv_color[n - 2] : c.palette_y_color[n - 2];
        for (int i = 1; i < onh + onw - 1; i++) {
            for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
                int r = i - j, order[8];
                int ctx = palette_color_context(map, bw, r, j, n, order);
                if (ctx < 0) corrupt("AV1 palette context");
                map[r * bw + j] = (uint8_t)order[sym.symbol(cdfs[ctx], n)];
            }
        }
        for (int i = 0; i < onh; i++)
            for (int j = onw; j < bw; j++) map[i * bw + j] = map[i * bw + onw - 1];
        for (int i = onh; i < bh; i++)
            for (int j = 0; j < bw; j++) map[i * bw + j] = map[(onh - 1) * bw + j];
    }
    void palette_tokens() {
        int bw = bw4 * 4, bh = bh4 * 4;
        int onh = std::min(bh, (d.mi_rows - mi_row) * 4), onw = std::min(bw, (d.mi_cols - mi_col) * 4);
        if (b.palette_size[0]) color_map_tokens(color_map[0], b.palette_size[0], bw, bh, onw, onh, 0);
        if (b.palette_size[1]) {
            bw >>= s.subsampling_x;
            bh >>= s.subsampling_y;
            onw >>= s.subsampling_x;
            onh >>= s.subsampling_y;
            if (bw < 4) bw += 2, onw += 2;
            if (bh < 4) bh += 2, onh += 2;
            color_map_tokens(color_map[1], b.palette_size[1], bw, bh, onw, onh, 1);
        }
    }

    // -- tx size (5.11.15-16) --
    uint8_t& inter_tx(int r, int col) { return d.inter_tx_size[(size_t)r * d.mi_cols + col]; }
    int above_tx_width(int r, int col) {
        if (r == mi_row) {
            if (!avail_u) return 64;
            const BlockInfo& a = at(r - 1, col);
            if (a.skip && a.is_inter) return kNum4x4W[a.mi_size] * 4;
        }
        return kTxW[inter_tx(r - 1, col)];
    }
    int left_tx_height(int r, int col) {
        if (col == mi_col) {
            if (!avail_l) return 64;
            const BlockInfo& l = at(r, col - 1);
            if (l.skip && l.is_inter) return kNum4x4H[l.mi_size] * 4;
        }
        return kTxH[inter_tx(r, col - 1)];
    }
    void read_var_tx_size(int r, int col, int tx, int depth) {
        if (r >= d.mi_rows || col >= d.mi_cols) return;
        int split = 0;
        if (tx != TX_4X4 && depth != 2) {
            int above = above_tx_width(r, col) < kTxW[tx];
            int left = left_tx_height(r, col) < kTxH[tx];
            int size = std::min(64, std::max(bw4, bh4) * 4);
            int max_tx = tx_size(size, size);
            int ctx = (kTxSizeSqrUp[tx] != max_tx) * 3 + (4 - max_tx) * 6 + above + left;
            split = sym.symbol(c.txfm_split[ctx], 2);
        }
        int w4 = kTxW[tx] >> 2, h4 = kTxH[tx] >> 2;
        if (split) {
            int sub = kSplitTxSize[tx], sw = kTxW[sub] >> 2, sh = kTxH[sub] >> 2;
            for (int i = 0; i < h4; i += sh)
                for (int j = 0; j < w4; j += sw) read_var_tx_size(r + i, col + j, sub, depth + 1);
        } else {
            for (int i = 0; i < h4; i++)
                for (int j = 0; j < w4; j++)
                    if (r + i < d.mi_rows && col + j < d.mi_cols) inter_tx(r + i, col + j) = (uint8_t)tx;
            b.tx_size = (uint8_t)tx;
        }
    }
    void read_tx_size() {
        if (f.tx_mode_select && b.mi_size > BLOCK_4X4 && b.is_inter && !b.skip && !lossless) {
            int max_tx = kMaxTxSizeRect[b.mi_size];
            int tw4 = kTxW[max_tx] >> 2, th4 = kTxH[max_tx] >> 2;
            for (int r = mi_row; r < mi_row + bh4; r += th4)
                for (int col = mi_col; col < mi_col + bw4; col += tw4) read_var_tx_size(r, col, max_tx, 0);
            return;
        }
        read_plain_tx_size(!b.skip || !b.is_inter);
        for (int y = 0; y < bh4 && mi_row + y < d.mi_rows; y++)
            for (int x = 0; x < bw4 && mi_col + x < d.mi_cols; x++) inter_tx(mi_row + y, mi_col + x) = b.tx_size;
    }
    void read_plain_tx_size(int allow_select) {
        if (lossless) {
            b.tx_size = TX_4X4;
            return;
        }
        int max_rect = kMaxTxSizeRect[b.mi_size];
        b.tx_size = (uint8_t)max_rect;
        if (b.mi_size > BLOCK_4X4 && allow_select && f.tx_mode_select) {
            int depth = 0;
            for (int t = max_rect; t != TX_4X4; t = kSplitTxSize[t]) depth++;
            int cat = depth - 1, max_depth = std::min(depth, 2);
            int above_w = 0, left_h = 0;
            if (avail_u) {
                const BlockInfo& a = at(mi_row - 1, mi_col);
                above_w = a.is_inter ? kNum4x4W[a.mi_size] * 4 : above_tx_width(mi_row, mi_col);
            }
            if (avail_l) {
                const BlockInfo& l = at(mi_row, mi_col - 1);
                left_h = l.is_inter ? kNum4x4H[l.mi_size] * 4 : left_tx_height(mi_row, mi_col);
            }
            int ctx = (above_w >= kTxW[max_rect]) + (left_h >= kTxH[max_rect]);
            uint16_t* cdf = cat == 0 ? c.tx8[ctx] : cat == 1 ? c.tx16[ctx]
                          : cat == 2 ? c.tx32[ctx] : c.tx64[ctx];
            int tx_depth = sym.symbol(cdf, max_depth + 1);
            for (int i = 0; i < tx_depth; i++) b.tx_size = kSplitTxSize[b.tx_size];
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

    // -- residual (5.11.34-39) --
    int plane_tx_size(int plane) const {
        if (plane == 0) return b.tx_size;
        int uv = kMaxTxSizeRect[residual_size(b.mi_size, plane)];
        if (kTxW[uv] == 64 || kTxH[uv] == 64) {
            if (kTxW[uv] == 16) return TX_16X32;
            if (kTxH[uv] == 16) return TX_32X16;
            return TX_32X32;
        }
        return uv;
    }
    void residual() {
        int wc = std::max(1, bw4 >> 4), hc = std::max(1, bh4 >> 4);
        for (int cy = 0; cy < hc; cy++)
            for (int cx = 0; cx < wc; cx++)
                for (int p = 0; p < 1 + has_chroma * 2; p++) {
                    int tx = lossless ? TX_4X4 : plane_tx_size(p);
                    int step_x = kTxW[tx] >> 2, step_y = kTxH[tx] >> 2;
                    int psz = residual_size(b.mi_size, p);
                    int n4w = kNum4x4W[psz], n4h = kNum4x4H[psz];
                    int sx = p ? s.subsampling_x : 0, sy = p ? s.subsampling_y : 0;
                    int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
                    if (b.is_inter && !lossless && p == 0) {
                        transform_tree((mi_col + (cx << 4)) * 4, (mi_row + (cy << 4)) * 4,
                                       std::min(n4w, 16) * 4, std::min(n4h, 16) * 4);
                        continue;
                    }
                    for (int y = 0; y < std::min(n4h, 16 >> sy); y += step_y)
                        for (int x = 0; x < std::min(n4w, 16 >> sx); x += step_x)
                            transform_block(p, base_x, base_y, tx, x + ((cx << 4) >> sx),
                                            y + ((cy << 4) >> sy));
                }
    }

    void transform_tree(int x, int y, int w, int h) {
        if (x >= d.mi_cols * 4 || y >= d.mi_rows * 4) return;
        int tx = inter_tx(y >> 2, x >> 2);
        if (w == kTxW[tx] && h == kTxH[tx]) {
            transform_block(0, x, y, tx, 0, 0);
        } else if (w > h) {
            transform_tree(x, y, w / 2, h);
            transform_tree(x + w / 2, y, w / 2, h);
        } else if (w < h) {
            transform_tree(x, y, w, h / 2);
            transform_tree(x, y + h / 2, w, h / 2);
        } else {
            transform_tree(x, y, w / 2, h / 2);
            transform_tree(x + w / 2, y, w / 2, h / 2);
            transform_tree(x, y + h / 2, w / 2, h / 2);
            transform_tree(x + w / 2, y + h / 2, w / 2, h / 2);
        }
    }

    void transform_block(int plane, int base_x, int base_y, int tx, int x, int y) {
        int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
        int sb_mask = s.use_128x128 ? 31 : 15;
        int sub_row = row & sb_mask, sub_col = col & sb_mask;
        int step_x = kTxW[tx] >> 2, step_y = kTxH[tx] >> 2;
        int max_x = d.mi_cols * 4 - 1, max_y = d.mi_rows * 4 - 1;
        if (start_x >= (max_x >> sx) + 1 || start_y >= (max_y >> sy) + 1) return;
        if (b.is_inter) {
            // predicted for the whole block in decode_block
        } else if ((plane == 0 && b.palette_size[0]) || (plane != 0 && b.palette_size[1])) {
            int w = kTxW[tx], h = kTxH[tx];
            const uint8_t* map = color_map[plane ? 1 : 0];
            int bw = plane ? (bw4 * 4) >> sx : bw4 * 4;
            if (bw < 4) bw += 2;
            const uint16_t* pal = b.palette_colors[plane];
            const uint8_t* m = map + (y * 4) * bw + x * 4;
            Plane& pl = d.cur[plane];
            if (s.bit_depth > 8) paint_palette<uint16_t>(pl, start_x, start_y, w, h, pal, m, bw);
            else paint_palette<uint8_t>(pl, start_x, start_y, w, h, pal, m, bw);
        } else {
            int is_cfl = plane > 0 && b.uv_mode == UV_CFL_PRED;
            int mode = plane == 0 ? b.y_mode : (is_cfl ? DC_PRED : b.uv_mode);
            int have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
            int have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
            int have_ar = decoded(plane, (sub_row >> sy) - 1, (sub_col >> sx) + step_x);
            int have_bl = decoded(plane, (sub_row >> sy) + step_y, (sub_col >> sx) - 1);
            if (plane == 0 && b.use_filter_intra)
                predict_filter_intra(d, plane, start_x, start_y, have_left, have_above, have_ar,
                                     have_bl, kTxWLog2[tx], kTxHLog2[tx], b.filter_intra_mode);
            else
                predict_intra(d, plane, start_x, start_y, have_left, have_above, have_ar, have_bl,
                              mode, kTxWLog2[tx], kTxHLog2[tx], b,
                              plane == 0 ? avail_u : avail_u_chroma,
                              plane == 0 ? avail_l : avail_l_chroma, mi_row, mi_col);
            if (is_cfl)
                predict_cfl(d, plane, start_x, start_y, tx,
                            plane == 1 ? b.cfl_alpha_u : b.cfl_alpha_v, max_luma_w, max_luma_h);
        }
        if (plane == 0) {
            max_luma_w = start_x + step_x * 4;
            max_luma_h = start_y + step_y * 4;
        }
        if (!b.skip) {
            int tx_type = DCT_DCT;
            int eob = coeffs(plane, start_x, start_y, tx, tx_type);
            if (eob > 0) {
                int q = get_qindex(0, b.segment_id);
                const int16_t* dcq = kDcQLookup[(s.bit_depth - 8) >> 1];
                const int16_t* acq = kAcQLookup[(s.bit_depth - 8) >> 1];
                int dc, ac;
                if (plane == 0) {
                    dc = dcq[clip3(0, 255, q + f.delta_q_y_dc)];
                    ac = acq[clip3(0, 255, q)];
                } else if (plane == 1) {
                    dc = dcq[clip3(0, 255, q + f.delta_q_u_dc)];
                    ac = acq[clip3(0, 255, q + f.delta_q_u_ac)];
                } else {
                    dc = dcq[clip3(0, 255, q + f.delta_q_v_dc)];
                    ac = acq[clip3(0, 255, q + f.delta_q_v_ac)];
                }
                int qm = !f.using_qmatrix ? 15 : plane == 0 ? f.qm_y : plane == 1 ? f.qm_u : f.qm_v;
                reconstruct(d, plane, start_x, start_y, tx, tx_type, lossless, quant, dc, ac, qm);
            }
        }
        uint8_t* lf = d.lf_tx_size[plane].data();
        for (int i = 0; i < step_y; i++)
            for (int j = 0; j < step_x; j++) {
                int rr = (row >> sy) + i, cc = (col >> sx) + j;
                if (rr < d.mi_rows && cc < d.mi_cols) lf[(size_t)rr * d.mi_cols + cc] = (uint8_t)tx;
                decoded(plane, (sub_row >> sy) + i, (sub_col >> sx) + j) = 1;
            }
    }

    // Intra sets: 0 DCT only, 1 INTRA_1, 2 INTRA_2; an intra block copy's
    // (inter) sets: 0 DCT only, 1 INTER_1, 2 INTER_2, 3 INTER_3.
    int get_tx_set(int tx) const {
        int sqr = kTxSizeSqr[tx], up = kTxSizeSqrUp[tx];
        if (up > TX_32X32) return 0;
        if (b.is_inter) {
            if (f.reduced_tx_set || up == TX_32X32) return 3;
            return sqr == TX_16X16 ? 2 : 1;
        }
        if (up == TX_32X32) return 0;
        if (f.reduced_tx_set || sqr == TX_16X16) return 2;
        return 1;
    }
    bool in_set(int set, int type) const {
        if (set == 0) return type == DCT_DCT;
        if (!b.is_inter) return true;  // chroma of intra blocks: DCT and ADST pairs only
        if (set == 2) return !(type == V_ADST || type == H_ADST || type == V_FLIPADST ||
                               type == H_FLIPADST);
        if (set == 3) return type == IDTX || type == DCT_DCT;
        return true;
    }

    void set_luma_tx_types(int x4, int y4, int w4, int h4, int type) {
        for (int j = 0; j < h4 && y4 + j < d.mi_rows; j++)
            for (int i = 0; i < w4 && x4 + i < d.mi_cols; i++)
                d.tx_types[(size_t)(y4 + j) * d.mi_cols + x4 + i] = (uint8_t)type;
    }

    int coeffs(int plane, int start_x, int start_y, int tx, int& tx_type) {
        int x4 = start_x >> 2, y4 = start_y >> 2, w4 = kTxW[tx] >> 2, h4 = kTxH[tx] >> 2;
        int tx_sz_ctx = (kTxSizeSqr[tx] + kTxSizeSqrUp[tx] + 1) >> 1;
        int ptype = plane > 0;
        int seg_eob = (tx == TX_16X64 || tx == TX_64X16) ? 512 : std::min(1024, kTxW[tx] * kTxH[tx]);
        std::memset(quant, 0, sizeof(int32_t) * seg_eob);
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int max_x4 = d.mi_cols >> sx, max_y4 = d.mi_rows >> sy;
        int psz = residual_size(b.mi_size, plane);
        // all_zero context
        int ctx;
        if (plane == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++)
                if (x4 + k < max_x4) top = std::max<int>(top, above_level[plane][x4 + k]);
            for (int k = 0; k < h4; k++)
                if (y4 + k < max_y4) left = std::max<int>(left, left_level[plane][y4 + k]);
            if (kNum4x4W[psz] * 4 == kTxW[tx] && kNum4x4H[psz] * 4 == kTxH[tx]) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
            else if (std::max(top, left) <= 3) ctx = 4;
            else if (std::min(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int i = 0; i < w4; i++)
                if (x4 + i < max_x4) above |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
            for (int i = 0; i < h4; i++)
                if (y4 + i < max_y4) left |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
            ctx = (above != 0) + (left != 0) + 7;
            if (kNum4x4W[psz] * kNum4x4H[psz] * 16 > kTxW[tx] * kTxH[tx]) ctx += 3;
        }
        int eob = 0, cul_level = 0, dc_category = 0;
        int all_zero = sym.symbol(c.txb_skip[tx_sz_ctx][ctx], 2);
        if (all_zero && plane == 0) set_luma_tx_types(x4, y4, w4, h4, DCT_DCT);
        if (!all_zero) {
            // transform_type and compute_tx_type
            int set = get_tx_set(tx);
            if (plane == 0) {
                tx_type = DCT_DCT;
                int q = f.segmentation_enabled ? get_qindex(1, b.segment_id) : f.base_q_idx;
                if (set > 0 && q > 0) {
                    int sqr = kTxSizeSqr[tx];
                    if (b.is_inter) {
                        if (set == 1) tx_type = kTxTypeInterInvSet1[sym.symbol(c.inter_tx_set1[sqr], 16)];
                        else if (set == 2) tx_type = kTxTypeInterInvSet2[sym.symbol(c.inter_tx_set2, 12)];
                        else tx_type = sym.symbol(c.inter_tx_set3[sqr], 2) ? DCT_DCT : IDTX;
                    } else {
                        int dir = b.use_filter_intra ? kFilterIntraModeToIntraDir[b.filter_intra_mode]
                                                     : b.y_mode;
                        if (set == 1) tx_type = kTxTypeIntraInvSet1[sym.symbol(c.intra_tx_set1[sqr][dir], 7)];
                        else tx_type = kTxTypeIntraInvSet2[sym.symbol(c.intra_tx_set2[sqr][dir], 5)];
                    }
                }
                set_luma_tx_types(x4, y4, w4, h4, tx_type);
            }
            if (lossless || kTxSizeSqrUp[tx] > TX_32X32) {
                tx_type = DCT_DCT;
            } else if (plane > 0) {
                if (b.is_inter) {
                    int lx = std::max(mi_col, x4 << sx), ly = std::max(mi_row, y4 << sy);
                    tx_type = d.tx_types[(size_t)ly * d.mi_cols + lx];
                } else {
                    tx_type = kModeToTxfm[b.uv_mode];
                }
                if (!in_set(set, tx_type)) tx_type = DCT_DCT;
            }
            int cls = tx_class(tx_type);
            const Scans& sc = scans();
            const int16_t* scan;
            if (tx == TX_16X64 || tx == TX_64X16 || kTxSizeSqrUp[tx] == TX_64X64 || tx_type == IDTX ||
                cls == TX_CLASS_2D)
                scan = sc.def[tx].data();
            else if (cls == TX_CLASS_VERT) scan = sc.row[tx].data();
            else scan = sc.col[tx].data();
            int eob_multisize = std::min<int>(kTxWLog2[tx], 5) + std::min<int>(kTxHLog2[tx], 5) - 4;
            int ectx = cls == TX_CLASS_2D ? 0 : 1, eob_pt;
            switch (eob_multisize) {
                case 0: eob_pt = sym.symbol(c.eob_pt16[ptype][ectx], 5) + 1; break;
                case 1: eob_pt = sym.symbol(c.eob_pt32[ptype][ectx], 6) + 1; break;
                case 2: eob_pt = sym.symbol(c.eob_pt64[ptype][ectx], 7) + 1; break;
                case 3: eob_pt = sym.symbol(c.eob_pt128[ptype][ectx], 8) + 1; break;
                case 4: eob_pt = sym.symbol(c.eob_pt256[ptype][ectx], 9) + 1; break;
                case 5: eob_pt = sym.symbol(c.eob_pt512[ptype], 10) + 1; break;
                default: eob_pt = sym.symbol(c.eob_pt1024[ptype], 11) + 1; break;
            }
            eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
            int eob_shift = eob_pt - 3;
            if (eob_shift >= 0) {
                if (sym.symbol(c.eob_extra[tx_sz_ctx][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
                for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
                    eob_shift = std::max(0, eob_pt - 2) - 1 - i;
                    if (sym.literal(1)) eob += 1 << eob_shift;
                }
            }
            int adj = kAdjustedTx[tx];
            int bwl = kTxWLog2[adj], txw = kTxW[adj], txh = kTxH[adj];
            // By the unadjusted size: 64x32 takes the wide offsets.
            const uint8_t(*offsets)[5] =
                kCoeffBaseCtxOffset[kTxW[tx] == kTxH[tx] ? 0 : kTxW[tx] > kTxH[tx] ? 1 : 2];
            int br_tx = std::min(tx_sz_ctx, (int)TX_32X32);
            for (int ci = eob - 1; ci >= 0; ci--) {
                int pos = scan[ci], level;
                int row = pos >> bwl, col = pos - (row << bwl);
                if (ci == eob - 1) {
                    int bctx = ci == 0 ? 0 : ci <= (txh << bwl) / 8 ? 1 : ci <= (txh << bwl) / 4 ? 2 : 3;
                    level = sym.symbol(c.coeff_base_eob[tx_sz_ctx][ptype][bctx], 3) + 1;
                } else {
                    int mag = 0;
                    for (int k = 0; k < 5; k++) {
                        int rr = row + kSigRefDiffOffset[cls][k][0], cc = col + kSigRefDiffOffset[cls][k][1];
                        if (rr < txh && cc < txw) mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
                    }
                    int bctx = std::min((mag + 1) >> 1, 4);
                    if (cls == TX_CLASS_2D) {
                        if (row == 0 && col == 0) bctx = 0;
                        else bctx += offsets[std::min(row, 4)][std::min(col, 4)];
                    } else {
                        int idx = cls == TX_CLASS_VERT ? row : col;
                        bctx += 26 + 5 * std::min(idx, 2);
                    }
                    level = sym.symbol(c.coeff_base[tx_sz_ctx][ptype][bctx], 4);
                }
                if (level > 2) {
                    int mag = 0;
                    for (int k = 0; k < 3; k++) {
                        int rr = row + kMagRefOffset[cls][k][0], cc = col + kMagRefOffset[cls][k][1];
                        if (rr < txh && cc < txw) mag += std::min(quant[rr * txw + cc], 15);
                    }
                    mag = std::min((mag + 1) >> 1, 6);
                    int bctx;
                    if (pos == 0) bctx = mag;
                    else if (cls == TX_CLASS_2D) bctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
                    else if (cls == TX_CLASS_HORIZ) bctx = col == 0 ? mag + 7 : mag + 14;
                    else bctx = row == 0 ? mag + 7 : mag + 14;
                    for (int idx = 0; idx < 4; idx++) {
                        int br = sym.symbol(c.coeff_br[br_tx][ptype][bctx], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            for (int ci = 0; ci < eob; ci++) {
                int pos = scan[ci], sign = 0;
                if (quant[pos] != 0) {
                    if (ci == 0) {
                        int dc = 0;
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
                        int dctx = dc < 0 ? 1 : dc > 0 ? 2 : 0;
                        sign = sym.symbol(c.dc_sign[ptype][dctx], 2);
                    } else {
                        sign = sym.literal(1);
                    }
                }
                if (quant[pos] > 14) {
                    int length = 0, bit;
                    do {
                        length++;
                        bit = sym.literal(1);
                        if (length > 32) corrupt("AV1 Golomb code too long");
                    } while (!bit);
                    int x = 1;
                    for (int i = length - 2; i >= 0; i--) x = (x << 1) | sym.literal(1);
                    quant[pos] = x + 14;
                }
                if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
                quant[pos] &= 0xFFFFF;
                cul_level += quant[pos];
                if (sign) quant[pos] = -quant[pos];
            }
            cul_level = std::min(63, cul_level);
        }
        for (int i = 0; i < w4; i++) {
            above_level[plane][x4 + i] = (uint8_t)cul_level;
            above_dc[plane][x4 + i] = (uint8_t)dc_category;
        }
        for (int i = 0; i < h4; i++) {
            left_level[plane][y4 + i] = (uint8_t)cul_level;
            left_dc[plane][y4 + i] = (uint8_t)dc_category;
        }
        return eob;
    }
};

}  // namespace

int palette_cache(const Decoder& d, int mi_row, int mi_col, int avail_u, int avail_l, int plane,
                  uint16_t* cache) {
    int above_n = 0, left_n = 0;
    const BlockInfo* above = avail_u ? &d.bi(mi_row - 1, mi_col) : nullptr;
    const BlockInfo* left = avail_l ? &d.bi(mi_row, mi_col - 1) : nullptr;
    if ((mi_row * 4) % 64 && above) above_n = above->palette_size[plane];
    if (left) left_n = left->palette_size[plane];
    const uint16_t* ac = above_n ? above->palette_colors[plane] : nullptr;
    const uint16_t* lc = left_n ? left->palette_colors[plane] : nullptr;
    int ai = 0, li = 0, n = 0;
    while (ai < above_n && li < left_n) {
        int a = ac[ai], l = lc[li];
        if (l < a) {
            if (n == 0 || l != cache[n - 1]) cache[n++] = (uint16_t)l;
            li++;
        } else {
            if (n == 0 || a != cache[n - 1]) cache[n++] = (uint16_t)a;
            ai++;
            if (l == a) li++;
        }
    }
    for (; ai < above_n; ai++)
        if (n == 0 || ac[ai] != cache[n - 1]) cache[n++] = ac[ai];
    for (; li < left_n; li++)
        if (n == 0 || lc[li] != cache[n - 1]) cache[n++] = lc[li];
    return n;
}

void decode_tile(Decoder& d, const uint8_t* data, size_t size, int tile_row, int tile_col) {
    auto t = std::make_unique<Tile>(d, tile_row, tile_col);
    t->sym.init(data, size, !d.fh.disable_cdf_update);
    t->run();
}

}  // namespace av1
