// The in-loop filters of an AV1 key frame, in the specification's order:
// deblocking (AV1 specification 7.14: every vertical edge of a plane,
// then every horizontal one), CDEF (7.15, on the deblocked frame), the
// superres upscaling (7.16, of both) and loop restoration (7.17: Wiener
// and self-guided, reading the deblocked frame above and below each
// 64-row stripe and the CDEF output within it). The result is
// Decoder::lr. Each filter is a template of the sample type; above 8 bits
// the thresholds, strengths and roundings shift by BitDepth - 8 as the
// specification sets out.

#include "av1.h"

#include "av1tables.h"

namespace av1 {

namespace {

// -- deblocking (7.14) ---------------------------------------------------------

template <typename pixel>
struct Deblock {
    Decoder& d;
    const SequenceHeader& s;
    const FrameHeader& f;
    const int shift = bit_depth<pixel>(d) - 8;
    explicit Deblock(Decoder& dec) : d(dec), s(dec.seq), f(dec.fh) {}

    int level(int row, int col, int plane, int pass) {
        const BlockInfo& b = d.bi(row, col);
        int delta = f.delta_lf_multi ? b.delta_lf[plane == 0 ? pass : plane + 1] : b.delta_lf[0];
        int i = plane == 0 ? pass : plane + 1;
        int base = clip3(0, 63, delta + f.loop_filter_level[i]);
        int lvl = base;
        int feature = 1 + i;
        if (f.segmentation_enabled && f.feature_enabled[b.segment_id][feature])
            lvl = clip3(0, 63, base + f.feature_data[b.segment_id][feature]);
        if (f.loop_filter_delta_enabled) {
            int n_shift = lvl >> 5;
            lvl += f.loop_filter_ref_deltas[0] * (1 << n_shift);
            lvl = clip3(0, 63, lvl);
        }
        return lvl;
    }

    void filter_sample(Plane& p, int x, int y, int lvl, int dx, int dy, int size, int plane) {
        int sh = f.loop_filter_sharpness > 4 ? 2 : f.loop_filter_sharpness > 0 ? 1 : 0;
        int limit = f.loop_filter_sharpness > 0 ? clip3(1, 9 - f.loop_filter_sharpness, lvl >> sh)
                                                : std::max(1, lvl >> sh);
        int blimit = (2 * (lvl + 2) + limit) << shift, thresh = (lvl >> 4) << shift;
        limit <<= shift;
        const int one = 1 << shift;  // the flatness threshold
        auto px = [&](int k) -> pixel& {  // k >= 0: q_k; k < 0: p_{-k-1}
            return p.px<pixel>(y + k * dy)[x + k * dx];
        };
        int q0 = px(0), q1 = px(1), p0 = px(-1), p1 = px(-2);
        int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
        int len = size == 4 ? 4 : plane != 0 ? 6 : size == 8 ? 8 : 16;
        int mask = std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
                   std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
        int q2 = 0, p2 = 0, q3 = 0, p3 = 0;
        if (len >= 6) {
            q2 = px(2);
            p2 = px(-3);
            mask |= std::abs(p2 - p1) > limit || std::abs(q2 - q1) > limit;
        }
        if (len >= 8) {
            q3 = px(3);
            p3 = px(-4);
            mask |= std::abs(p3 - p2) > limit || std::abs(q3 - q2) > limit;
        }
        if (mask) return;
        int flat = 0, flat2 = 0;
        if (size >= 8) {
            int m = std::abs(p1 - p0) > one || std::abs(q1 - q0) > one ||
                    std::abs(p2 - p0) > one || std::abs(q2 - q0) > one;
            if (len >= 8) m |= std::abs(p3 - p0) > one || std::abs(q3 - q0) > one;
            flat = !m;
        }
        if (size >= 16) {
            int m = 0;
            for (int k = 4; k <= 6; k++)
                m |= std::abs(px(-k - 1) - p0) > one || std::abs(px(k) - q0) > one;
            flat2 = !m;
        }
        if (size == 4 || !flat) {
            const int half = 128 << shift;
            auto c4 = [half](int v) { return clip3(-half, half - 1, v); };
            int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
            int filter = hev ? c4(ps1 - qs1) : 0;
            filter = c4(filter + 3 * (qs0 - ps0));
            int f1 = c4(filter + 4) >> 3, f2 = c4(filter + 3) >> 3;
            px(0) = (pixel)(c4(qs0 - f1) + half);
            px(-1) = (pixel)(c4(ps0 + f2) + half);
            if (!hev) {
                int fv = round2(f1, 1);
                px(1) = (pixel)(c4(qs1 - fv) + half);
                px(-2) = (pixel)(c4(ps1 + fv) + half);
            }
            return;
        }
        int log2 = (size == 8 || !flat2) ? 3 : 4;
        int n = log2 == 4 ? 6 : plane == 0 ? 3 : 2;
        int n2 = (log2 == 3 && plane == 0) ? 0 : 1;
        int F[16], out[16];
        for (int k = -(n + 1); k <= n; k++) F[k + 8] = px(k);
        for (int i = -n; i < n; i++) {
            int t = 0;
            for (int j = -n; j <= n; j++) {
                int pk = clip3(-(n + 1), n, i + j);
                int tap = std::abs(j) <= n2 ? 2 : 1;
                t += F[pk + 8] * tap;
            }
            out[i + 8] = round2(t, log2);
        }
        for (int i = -n; i < n; i++) px(i) = (pixel)out[i + 8];
    }

    void edge(int plane, int pass, int row, int col) {
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int dx = pass == 0, dy = pass == 1;
        int x = col * 4, y = row * 4;
        row |= sy;
        col |= sx;
        if (x >= f.frame_width || y >= f.frame_height) return;
        if ((pass == 0 && x == 0) || (pass == 1 && y == 0)) return;
        int xp = x >> sx, yp = y >> sy;
        int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
        int tx = d.lf_tx_size[plane][(size_t)(row >> sy) * d.mi_cols + (col >> sx)];
        int prev_tx = d.lf_tx_size[plane][(size_t)(prev_row >> sy) * d.mi_cols + (prev_col >> sx)];
        // Every transform edge of an intra frame is filtered, skipped
        // blocks' too (only an inter block's skip spares its inner edges).
        if (pass == 0 ? xp % kTxW[tx] : yp % kTxH[tx]) return;
        int base = pass == 0 ? std::min(kTxW[prev_tx], kTxW[tx]) : std::min(kTxH[prev_tx], kTxH[tx]);
        int size = plane == 0 ? std::min(16, base) : std::min(8, base);
        int lvl = level(row, col, plane, pass);
        if (lvl == 0) lvl = level(prev_row, prev_col, plane, pass);
        if (lvl == 0) return;
        Plane& p = d.cur[plane];
        for (int i = 0; i < 4; i++) filter_sample(p, xp + dy * i, yp + dx * i, lvl, dx, dy, size, plane);
    }

    void run() {
        if (!f.loop_filter_level[0] && !f.loop_filter_level[1]) return;
        for (int plane = 0; plane < s.num_planes; plane++) {
            if (plane == 1 && !f.loop_filter_level[2]) continue;
            if (plane == 2 && !f.loop_filter_level[3]) continue;
            int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
            // A luma direction at level 0 is still filtered where the
            // intra delta lifts its blocks' level (dav1d_calc_lf_values).
            for (int pass = 0; pass < 2; pass++) {
                for (int row = 0; row < d.mi_rows; row += 1 << sy)
                    for (int col = 0; col < d.mi_cols; col += 1 << sx) edge(plane, pass, row, col);
            }
        }
    }
};

// -- CDEF (7.15) -----------------------------------------------------------------

const int kCdefUvDir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                                 {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
const int kCdefDirections[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
                                      {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
                                      {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
const int kCdefPriTaps[2][2] = {{4, 2}, {3, 3}};
const int kCdefSecTaps[2][2] = {{2, 1}, {2, 1}};
const int kDivTable[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int adj = std::max(0, damping - floor_log2(threshold));
    int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -val : val;
}

template <typename pixel>
struct Cdef {
    Decoder& d;
    const SequenceHeader& s;
    const FrameHeader& f;
    const int coeff_shift = bit_depth<pixel>(d) - 8;
    explicit Cdef(Decoder& dec) : d(dec), s(dec.seq), f(dec.fh) {}

    void direction(int r, int c, int& dir, int& var) {
        int cost[8] = {0}, partial[8][15] = {{0}};
        int x0 = c * 4, y0 = r * 4;
        const Plane& p = d.cur[0];
        for (int i = 0; i < 8; i++) {
            const pixel* row = p.px<pixel>(y0 + i) + x0;
            for (int j = 0; j < 8; j++) {
                int x = (row[j] >> coeff_shift) - 128;
                partial[0][i + j] += x;
                partial[1][i + j / 2] += x;
                partial[2][i] += x;
                partial[3][3 + i - j / 2] += x;
                partial[4][7 + i - j] += x;
                partial[5][3 - i / 2 + j] += x;
                partial[6][j] += x;
                partial[7][i / 2 + j] += x;
            }
        }
        for (int i = 0; i < 8; i++) {
            cost[2] += partial[2][i] * partial[2][i];
            cost[6] += partial[6][i] * partial[6][i];
        }
        cost[2] *= kDivTable[8];
        cost[6] *= kDivTable[8];
        for (int i = 0; i < 7; i++) {
            cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) *
                       kDivTable[i + 1];
            cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) *
                       kDivTable[i + 1];
        }
        cost[0] += partial[0][7] * partial[0][7] * kDivTable[8];
        cost[4] += partial[4][7] * partial[4][7] * kDivTable[8];
        for (int i = 1; i < 8; i += 2) {
            for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
            cost[i] *= kDivTable[8];
            for (int j = 0; j < 3; j++)
                cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) *
                           kDivTable[2 * j + 2];
        }
        int best = 0;
        dir = 0;
        for (int i = 0; i < 8; i++)
            if (cost[i] > best) {
                best = cost[i];
                dir = i;
            }
        var = (best - cost[(dir + 4) & 7]) >> 10;
    }

    void filter(int plane, int r, int c, int pri, int sec, int damping, int dir) {
        int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
        int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
        const Plane& src = d.cur[plane];
        Plane& dst = d.cdef[plane];
        auto get = [&](int i, int j, int& v) {
            int y = y0 + i, x = x0 + j;
            int cr = (y << sy) >> 2, cc = (x << sx) >> 2;
            if (y < 0 || x < 0 || cr >= d.mi_rows || cc >= d.mi_cols) return false;
            v = src.px<pixel>(y)[x];
            return true;
        };
        int tap_set = (pri >> coeff_shift) & 1;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int x = src.px<pixel>(y0 + i)[x0 + j], sum = 0, mx = x, mn = x;
                for (int k = 0; k < 2; k++)
                    for (int sign = -1; sign <= 1; sign += 2) {
                        int v;
                        if (get(i + sign * kCdefDirections[dir][k][0],
                                j + sign * kCdefDirections[dir][k][1], v)) {
                            sum += kCdefPriTaps[tap_set][k] * constrain(v - x, pri, damping);
                            mx = std::max(v, mx);
                            mn = std::min(v, mn);
                        }
                        for (int off = -2; off <= 2; off += 4) {
                            int d2 = (dir + off) & 7;
                            if (get(i + sign * kCdefDirections[d2][k][0],
                                    j + sign * kCdefDirections[d2][k][1], v)) {
                                sum += kCdefSecTaps[tap_set][k] * constrain(v - x, sec, damping);
                                mx = std::max(v, mx);
                                mn = std::min(v, mn);
                            }
                        }
                    }
                dst.px<pixel>(y0 + i)[x0 + j] =
                    (pixel)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
            }
    }

    void block(int r, int c, int idx) {
        const BlockInfo* bs[4] = {&d.bi(r, c), &d.bi(r + 1, c), &d.bi(r, c + 1), &d.bi(r + 1, c + 1)};
        if (bs[0]->skip && bs[1]->skip && bs[2]->skip && bs[3]->skip) return;
        int ydir, var;
        direction(r, c, ydir, var);
        int pri = f.cdef_y_pri[idx] << coeff_shift, sec = f.cdef_y_sec[idx] << coeff_shift;
        int dir = pri == 0 ? 0 : ydir;
        int var_str = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
        pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
        const int damping = f.cdef_damping + coeff_shift;
        filter(0, r, c, pri, sec, damping, dir);
        if (s.num_planes == 1) return;
        pri = f.cdef_uv_pri[idx] << coeff_shift;
        sec = f.cdef_uv_sec[idx] << coeff_shift;
        dir = pri == 0 ? 0 : kCdefUvDir[s.subsampling_x][s.subsampling_y][ydir];
        filter(1, r, c, pri, sec, damping - 1, dir);
        filter(2, r, c, pri, sec, damping - 1, dir);
    }

    void run() {
        for (int p = 0; p < s.num_planes; p++) d.cdef[p] = d.cur[p];
        if (!s.enable_cdef || f.coded_lossless || f.allow_intrabc) return;
        for (int r = 0; r < d.mi_rows; r += 2)
            for (int c = 0; c < d.mi_cols; c += 2) {
                int idx = d.cdef_idx[(size_t)(r >> 4) * d.cdef_stride + (c >> 4)];
                if (idx != -1) block(r, c, idx);
            }
    }
};

// -- superres upscaling (7.16) ---------------------------------------------------

// A plane's rows widened from its coded width to dst_w as dav1d's resize
// computes the specification's process: 14-bit positions from x0 by step,
// the 8-tap Upscale_Filter at a position's 6-bit phase, the source
// clamped to the plane's decoded width (the samples of its last
// superblocks past the frame's edge included).
template <typename pixel>
void upscale_plane(const Plane& src, Plane& dst, int src_w, int step, int x0, int maxv) {
    for (int y = 0; y < src.height; y++) {
        const pixel* in = src.px<pixel>(y);
        pixel* out = dst.px<pixel>(y);
        int mx = x0, sx = -1;
        for (int x = 0; x < dst.width; x++) {
            const int16_t* F = kUpscaleFilter[mx >> 8];
            int sum = 0;
            for (int k = 0; k < 8; k++) sum += F[k] * in[clip3(0, src_w - 1, sx + k - 3)];
            out[x] = (pixel)clip3(0, maxv, (sum + 64) >> 7);
            mx += step;
            sx += mx >> 14;
            mx &= 0x3fff;
        }
    }
}

template <typename pixel>
void superres(Decoder& d) {
    const SequenceHeader& s = d.seq;
    const FrameHeader& f = d.fh;
    for (int p = 0; p < s.num_planes; p++) {
        int ss = p ? s.subsampling_x : 0;
        int in_w = (f.frame_width + ss) >> ss, out_w = (f.upscaled_width + ss) >> ss;
        int step = ((in_w << 14) + (out_w >> 1)) / out_w;
        int err = out_w * step - (in_w << 14);
        int x0 = ((-((out_w - in_w) << 13) + (out_w >> 1)) / out_w + 128 - err / 2) & 0x3fff;
        int src_w = (4 * f.mi_cols + ss) >> ss;
        // Loop restoration reads the deblocked frame across its stripes'
        // edges: that is upscaled too.
        for (Plane* pl : {&d.cdef[p], &d.cur[p]}) {
            if (pl == &d.cur[p] && !f.uses_lr) continue;
            Plane up;
            alloc_plane(up, out_w, pl->height, sizeof(pixel));
            upscale_plane<pixel>(*pl, up, src_w, step, x0, pixel_max<pixel>(d));
            *pl = std::move(up);
        }
    }
}

// -- loop restoration (7.17) ------------------------------------------------------

template <typename pixel>
struct Restoration {
    Decoder& d;
    const SequenceHeader& s;
    const FrameHeader& f;
    const int bd = bit_depth<pixel>(d), maxv = pixel_max<pixel>(d);
    int plane, stripe_start, stripe_end, plane_end_x, plane_end_y;
    explicit Restoration(Decoder& dec) : d(dec), s(dec.seq), f(dec.fh) {}

    int source(int x, int y) const {
        x = std::max(0, std::min(plane_end_x, x));
        y = std::max(0, std::min(plane_end_y, y));
        if (y < stripe_start) {
            y = std::max(stripe_start - 2, y);
            return d.cur[plane].px<pixel>(y)[x];
        }
        if (y > stripe_end) {
            y = std::min(stripe_end + 2, y);
            return d.cur[plane].px<pixel>(y)[x];
        }
        return d.cdef[plane].px<pixel>(y)[x];
    }

    void wiener(size_t unit, int x, int y, int w, int h) {
        const int8_t* c = &d.lr_wiener[plane][unit * 6];
        int vf[7], hf[7];
        for (int pass = 0; pass < 2; pass++) {
            int* fl = pass == 0 ? vf : hf;
            fl[3] = 128;
            for (int i = 0; i < 3; i++) {
                int v = c[pass * 3 + i];
                fl[i] = fl[6 - i] = v;
                fl[3] -= 2 * v;
            }
        }
        const int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
        int offset = 1 << (bd + 7 - round0 - 1), limit = (1 << (bd + 1 + 7 - round0)) - 1;
        int inter[10][4];
        for (int r = 0; r < h + 6; r++)
            for (int cc = 0; cc < w; cc++) {
                int sum = 0;
                for (int t = 0; t < 7; t++) sum += hf[t] * source(x + cc + t - 3, y + r - 3);
                inter[r][cc] = clip3(-offset, limit - offset, round2(sum, round0));
            }
        Plane& out = d.lr[plane];
        for (int r = 0; r < h; r++)
            for (int cc = 0; cc < w; cc++) {
                int sum = 0;
                for (int t = 0; t < 7; t++) sum += vf[t] * inter[r + t][cc];
                out.px<pixel>(y + r)[x + cc] = (pixel)clip3(0, maxv, round2(sum, round1));
            }
    }

    void box_filter(int x, int y, int w, int h, int set, int pass, int F[4][4]) {
        int r = kSgrParams[set][pass * 2], sv = kSgrParams[set][pass * 2 + 1];
        int A[6][6], B[6][6];
        int n = (2 * r + 1) * (2 * r + 1), one_over_n = ((1 << 12) + (n / 2)) / n;
        for (int i = -1; i < h + 1; i++)
            for (int j = -1; j < w + 1; j++) {
                int a = 0, b = 0;
                for (int dy = -r; dy <= r; dy++)
                    for (int dx = -r; dx <= r; dx++) {
                        int cv = source(x + j + dx, y + i + dy);
                        a += cv * cv;
                        b += cv;
                    }
                const int as = round2(a, 2 * (bd - 8)), bs = round2(b, bd - 8);
                int p = std::max(0, as * n - bs * bs);
                int z = (int)round2l((int64_t)p * sv, 20);
                int a2;
                if (z >= 255) a2 = 256;
                else if (z == 0) a2 = 1;
                else a2 = ((z << 8) + (z / 2)) / (z + 1);
                int64_t b2 = (int64_t)(256 - a2) * b * one_over_n;
                A[i + 1][j + 1] = a2;
                B[i + 1][j + 1] = (int)round2l(b2, 12);
            }
        for (int i = 0; i < h; i++) {
            int shift = (pass == 0 && (i & 1)) ? 4 : 5;
            for (int j = 0; j < w; j++) {
                int a = 0, b = 0;
                for (int dy = -1; dy <= 1; dy++)
                    for (int dx = -1; dx <= 1; dx++) {
                        int weight;
                        if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                        else weight = (dx == 0 || dy == 0) ? 4 : 3;
                        a += weight * A[i + dy + 1][j + dx + 1];
                        b += weight * B[i + dy + 1][j + dx + 1];
                    }
                int v = a * d.cdef[plane].px<pixel>(y + i)[x + j] + b;
                F[i][j] = round2(v, 8 + shift - 4);
            }
        }
    }

    void self_guided(size_t unit, int x, int y, int w, int h) {
        int set = d.lr_sgr_set[plane][unit];
        int r0 = kSgrParams[set][0], r1 = kSgrParams[set][2];
        int F0[4][4], F1[4][4];
        if (r0) box_filter(x, y, w, h, set, 0, F0);
        if (r1) box_filter(x, y, w, h, set, 1, F1);
        int w0 = d.lr_sgr_xqd[plane][unit * 2], w1 = d.lr_sgr_xqd[plane][unit * 2 + 1];
        int w2 = (1 << 7) - w0 - w1;
        Plane& out = d.lr[plane];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int u = d.cdef[plane].px<pixel>(y + i)[x + j] << 4;
                int v = w1 * u;
                v += r0 ? w0 * F0[i][j] : w0 * u;
                v += r1 ? w2 * F1[i][j] : w2 * u;
                out.px<pixel>(y + i)[x + j] = (pixel)clip3(0, maxv, round2(v, 11));
            }
    }

    void run() {
        for (int p = 0; p < s.num_planes; p++) d.lr[p] = d.cdef[p];
        if (!f.uses_lr) return;
        for (int y = 0; y < f.frame_height; y += 4)
            for (int x = 0; x < f.upscaled_width; x += 4)
                for (plane = 0; plane < s.num_planes; plane++) {
                    if (f.frame_restoration_type[plane] == RESTORE_NONE) continue;
                    int row = y >> 2, col = x >> 2;
                    int sx = plane ? s.subsampling_x : 0, sy = plane ? s.subsampling_y : 0;
                    // With subsampling, a 4x4 luma unit's chroma is done at even units.
                    if ((sx && (col & 1)) || (sy && (row & 1))) continue;
                    int stripe = (row * 4 + 8) / 64;
                    stripe_start = (-8 + stripe * 64) >> sy;
                    stripe_end = stripe_start + (64 >> sy) - 1;
                    int unit = f.loop_restoration_size[plane];
                    int unit_row = std::min(d.lr_unit_rows[plane] - 1, ((row * 4 + 8) >> sy) / unit);
                    int unit_col = std::min(d.lr_unit_cols[plane] - 1, ((col * 4) >> sx) / unit);
                    plane_end_x = round2(f.upscaled_width, sx) - 1;
                    plane_end_y = round2(f.frame_height, sy) - 1;
                    int px = (col * 4) >> sx, py = (row * 4) >> sy;
                    size_t u = (size_t)unit_row * d.lr_unit_cols[plane] + unit_col;
                    int type = d.lr_type[plane][u];
                    int bw = std::min(4, plane_end_x - px + 1), bh = std::min(4, plane_end_y - py + 1);
                    if (type == RESTORE_WIENER) wiener(u, px, py, bw, bh);
                    else if (type == RESTORE_SGRPROJ) self_guided(u, px, py, bw, bh);
                }
    }
};

}  // namespace

void loop_filter_frame(Decoder& d) {
    if (d.seq.bit_depth > 8) Deblock<uint16_t>(d).run();
    else Deblock<uint8_t>(d).run();
}
void cdef_frame(Decoder& d) {
    if (d.seq.bit_depth > 8) Cdef<uint16_t>(d).run();
    else Cdef<uint8_t>(d).run();
}
void superres_frame(Decoder& d) {
    // dav1d upscales only where the widths differ (a frame of 16 samples
    // or fewer keeps its width).
    if (d.fh.frame_width == d.fh.upscaled_width) return;
    if (d.seq.bit_depth > 8) superres<uint16_t>(d);
    else superres<uint8_t>(d);
}
void lr_frame(Decoder& d) {
    if (d.seq.bit_depth > 8) Restoration<uint16_t>(d).run();
    else Restoration<uint8_t>(d).run();
}

}  // namespace av1
