// Film grain synthesis (AV1 specification 7.18.3), applied to the output
// frame after loop restoration as dav1d 1.5 applies it by default (its
// fg_apply and filmgrain templates, 8bpc and 16bpc): a 73x82 luma grain
// template (38x44 or 73x82 for chroma) from the 16-bit shift-register
// generator and the Gaussian sequence, shaped by the auto-regressive
// filter (the chroma filter taking the co-located luma grain); scaling
// lookup tables interpolated between the signalled points; then rows of
// 32 luma lines in 32x32 blocks, each block's template offset drawn from
// a generator seeded by its row, blended with the block to its left and
// the row above over two samples where overlap is on, scaled by the
// source sample (or, for chroma, by a mix of it and the co-located source
// luma), added and clipped. Chroma reads the luma before its grain.
// Above 8 bits the grain is BitDepth - 8 bits wider (a smaller shift of the
// Gaussian sequence, wider clips), the scaling lookup has 2^BitDepth
// entries, interpolated between the 8-bit points' positions, and the
// clip ranges and chroma offset shift up by BitDepth - 8.

#include "av1.h"

#include "av1tables.h"

namespace av1 {

namespace {

constexpr int kGrainW = 82, kGrainH = 73, kBlock = 32;

// A grain template: int8_t samples at 8 bits, int16_t above.
template <typename entry>
using Template = entry[kGrainH][kGrainW];

inline int random_number(int bits, unsigned& state) {
    const int r = (int)state;
    unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    state = (r >> 1) | (bit << 15);
    return (int)((state >> (16 - bits)) & ((1u << bits) - 1));
}

inline int rnd2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

template <typename entry>
void generate_luma(const FilmGrain& g, int bd, Template<entry>& buf) {
    unsigned seed = (unsigned)g.seed;
    const int shift = 4 - (bd - 8) + g.grain_scale_shift, lag = g.ar_lag;
    const int ctr = 128 << (bd - 8);
    for (int y = 0; y < kGrainH; y++)
        for (int x = 0; x < kGrainW; x++)
            buf[y][x] = (entry)rnd2(kGaussianSequence[random_number(11, seed)], shift);
    for (int y = 3; y < kGrainH; y++)
        for (int x = 3; x < kGrainW - 3; x++) {
            const int8_t* coeff = g.ar_y;
            int sum = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) break;
                    sum += *coeff++ * buf[y + dy][x + dx];
                }
            buf[y][x] = (entry)clip3(-ctr, ctr - 1, buf[y][x] + rnd2(sum, g.ar_shift));
        }
}

template <typename entry>
void generate_chroma(const FilmGrain& g, int bd, int uv, int sx, int sy,
                     const Template<entry>& luma, Template<entry>& buf) {
    unsigned seed = (unsigned)g.seed ^ (uv ? 0x49d8 : 0xb524);
    const int shift = 4 - (bd - 8) + g.grain_scale_shift, lag = g.ar_lag;
    const int ctr = 128 << (bd - 8);
    const int w = sx ? 44 : kGrainW, h = sy ? 38 : kGrainH;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            buf[y][x] = (entry)rnd2(kGaussianSequence[random_number(11, seed)], shift);
    for (int y = 3; y < h; y++)
        for (int x = 3; x < w - 3; x++) {
            const int8_t* coeff = g.ar_uv[uv];
            int sum = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) {  // the co-located luma grain's tap
                        if (!g.num_y) break;
                        int l = 0;
                        const int lx = ((x - 3) << sx) + 3, ly = ((y - 3) << sy) + 3;
                        for (int i = 0; i <= sy; i++)
                            for (int j = 0; j <= sx; j++) l += luma[ly + i][lx + j];
                        sum += rnd2(l, sx + sy) * *coeff;
                        break;
                    }
                    sum += *coeff++ * buf[y + dy][x + dx];
                }
            buf[y][x] = (entry)clip3(-ctr, ctr - 1, buf[y][x] + rnd2(sum, g.ar_shift));
        }
}

// The scaling lookup of 2^bd entries: the 8-bit points' values at their
// positions shifted up by bd - 8, then, above 8 bits, the entries between
// interpolated (dav1d's generate_scaling).
void generate_scaling(const uint8_t (*points)[2], int num, int bd, uint8_t* scaling) {
    const int shift_x = bd - 8, size = 1 << bd;
    if (!num) {
        std::memset(scaling, 0, size);
        return;
    }
    std::memset(scaling, points[0][1], points[0][0] << shift_x);
    for (int i = 0; i < num - 1; i++) {
        const int bx = points[i][0], by = points[i][1];
        const int dx = points[i + 1][0] - bx, dy = points[i + 1][1] - by;
        const int delta = dy * ((0x10000 + (dx >> 1)) / dx);
        for (int x = 0, d = 0x8000; x < dx; x++, d += delta)
            scaling[(bx + x) << shift_x] = (uint8_t)(by + (d >> 16));
    }
    const int n = points[num - 1][0] << shift_x;
    std::memset(scaling + n, points[num - 1][1], size - n);
    if (!shift_x) return;
    const int pad = 1 << shift_x, rnd = pad >> 1;
    for (int i = 0; i < num - 1; i++) {
        const int bx = points[i][0] << shift_x, dx = (points[i + 1][0] << shift_x) - bx;
        for (int x = 0; x < dx; x += pad) {
            const int range = scaling[bx + x + pad] - scaling[bx + x];
            for (int k = 1, r = rnd; k < pad; k++) {
                r += range;
                scaling[bx + x + k] = (uint8_t)(scaling[bx + x] + (r >> shift_x));
            }
        }
    }
}

// The template sample of block offset (bx, by) (0 the current block, 1 the
// one to the left or above) at (x, y) within the block.
template <typename entry>
inline int sample(const Template<entry>& t, const int offsets[2][2], int sx, int sy, int bx,
                  int by, int x, int y) {
    const int r = offsets[bx][by];
    const int offx = 3 + (2 >> sx) * (3 + (r >> 4)), offy = 3 + (2 >> sy) * (3 + (r & 15));
    return t[offy + y + (kBlock >> sy) * by][offx + x + (kBlock >> sx) * bx];
}

// One row of blocks of a plane: dst and src at the row's first line, pw
// and bh its width and height in the plane's samples. luma (plane > 0):
// the source luma at the row's first line and its stride; uv: 0 Cb, 1 Cr.
template <typename pixel, typename entry>
void grain_row(const FilmGrain& g, int bd, pixel* dst, const pixel* src, int stride, int pw,
               int bh, int row_num, const Template<entry>& t, const uint8_t* scaling, int sx,
               int sy, const pixel* luma, int luma_stride, int uv, int lo, int hi) {
    const int ctr = 128 << (bd - 8), maxv = (1 << bd) - 1;
    const int rows = 1 + (g.overlap && row_num > 0);
    unsigned seed[2];
    for (int i = 0; i < rows; i++) {
        seed[i] = (unsigned)g.seed;
        seed[i] ^= (unsigned)((((row_num - i) * 37 + 178) & 0xFF) << 8);
        seed[i] ^= (unsigned)(((row_num - i) * 173 + 105) & 0xFF);
    }
    static const int kW[2][2][2] = {{{27, 17}, {17, 27}}, {{23, 22}, {0, 0}}};
    int offsets[2][2] = {{0, 0}, {0, 0}};
    auto add = [&](int bx, int x, int y, int grain) {
        const pixel* s = src + y * stride + bx + x;
        int val = *s;
        if (luma) {
            const pixel* l = luma + (y << sy) * luma_stride + ((bx + x) << sx);
            int avg = l[0];
            if (sx) avg = (avg + l[1] + 1) >> 1;
            val = avg;
            if (!g.chroma_from_luma) {
                const int combined = avg * g.uv_luma_mult[uv] + *s * g.uv_mult[uv];
                val = clip3(0, maxv, (combined >> 6) + g.uv_offset[uv] * (1 << (bd - 8)));
            }
        }
        const int noise = rnd2(scaling[val] * grain, g.scaling_shift);
        dst[y * stride + bx + x] = (pixel)clip3(lo, hi, *s + noise);
    };
    const int bsw = kBlock >> sx;
    for (int bx = 0; bx < pw; bx += bsw) {
        const int bw = std::min(bsw, pw - bx);
        if (g.overlap && bx)
            for (int i = 0; i < rows; i++) offsets[1][i] = offsets[0][i];
        for (int i = 0; i < rows; i++) offsets[0][i] = random_number(8, seed[i]);
        const int ystart = g.overlap && row_num ? std::min(2 >> sy, bh) : 0;
        const int xstart = g.overlap && bx ? std::min(2 >> sx, bw) : 0;
        auto blend = [&](int a, int b, const int* w) {
            return clip3(-ctr, ctr - 1, rnd2(a * w[0] + b * w[1], 5));
        };
        for (int y = ystart; y < bh; y++) {
            for (int x = xstart; x < bw; x++) add(bx, x, y, sample(t, offsets, sx, sy, 0, 0, x, y));
            for (int x = 0; x < xstart; x++)
                add(bx, x, y, blend(sample(t, offsets, sx, sy, 1, 0, x, y),
                                    sample(t, offsets, sx, sy, 0, 0, x, y), kW[sx][x]));
        }
        for (int y = 0; y < ystart; y++) {
            for (int x = xstart; x < bw; x++)
                add(bx, x, y, blend(sample(t, offsets, sx, sy, 0, 1, x, y),
                                    sample(t, offsets, sx, sy, 0, 0, x, y), kW[sy][y]));
            for (int x = 0; x < xstart; x++) {
                const int top = blend(sample(t, offsets, sx, sy, 1, 1, x, y),
                                      sample(t, offsets, sx, sy, 0, 1, x, y), kW[sx][x]);
                const int cur = blend(sample(t, offsets, sx, sy, 1, 0, x, y),
                                      sample(t, offsets, sx, sy, 0, 0, x, y), kW[sx][x]);
                add(bx, x, y, blend(top, cur, kW[sy][y]));
            }
        }
    }
}

template <typename pixel, typename entry>
void film_grain_t(Decoder& d) {
    const FilmGrain& g = d.fh.grain;
    const SequenceHeader& s = d.seq;
    const int bd = bit_depth<pixel>(d);
    const int w = d.fh.upscaled_width, h = d.fh.frame_height;
    const int sx = s.subsampling_x, sy = s.subsampling_y;
    static thread_local Template<entry> luma_t, uv_t[2];
    generate_luma(g, bd, luma_t);
    static thread_local uint8_t scaling[3][4096];
    if (g.num_y || g.chroma_from_luma) generate_scaling(g.y_points, g.num_y, bd, scaling[0]);
    for (int pl = 0; pl < 2; pl++) {
        if (s.num_planes > 1 && (g.num_uv[pl] || g.chroma_from_luma))
            generate_chroma(g, bd, pl, sx, sy, luma_t, uv_t[pl]);
        if (g.num_uv[pl]) generate_scaling(g.uv_points[pl], g.num_uv[pl], bd, scaling[1 + pl]);
    }
    const int up = bd - 8;
    const int lo = g.clip_restricted ? 16 << up : 0;
    const int hi_y = g.clip_restricted ? 235 << up : (1 << bd) - 1;
    const int hi_uv = !g.clip_restricted ? (1 << bd) - 1
                      : (s.matrix_coefficients == 0 ? 235 : 240) << up;
    // The source: the frame before its grain (chroma reads its luma), with
    // a column past an odd width where chroma is subsampled, as dav1d pads.
    Plane src = d.lr[0];
    if (sx && (w & 1))
        for (int y = 0; y < h; y++) src.px<pixel>(y)[w] = src.px<pixel>(y)[w - 1];
    const int rows = (h + kBlock - 1) / kBlock;
    for (int row = 0; row < rows; row++) {
        if (g.num_y) {
            const int bh = std::min(h - row * kBlock, kBlock);
            grain_row<pixel, entry>(g, bd, d.lr[0].px<pixel>(row * kBlock),
                                    src.px<pixel>(row * kBlock), d.lr[0].stride, w, bh, row,
                                    luma_t, scaling[0], 0, 0, nullptr, 0, 0, lo, hi_y);
        }
        if (s.num_planes == 1 || !(g.num_uv[0] || g.num_uv[1] || g.chroma_from_luma)) continue;
        const int bh = (std::min(h - row * kBlock, kBlock) + sy) >> sy;
        const int cw = (w + sx) >> sx, crow = (row * kBlock) >> sy;
        for (int pl = 0; pl < 2; pl++) {
            if (!g.chroma_from_luma && !g.num_uv[pl]) continue;
            Plane& p = d.lr[1 + pl];
            std::vector<pixel> in(p.px<pixel>(crow), p.px<pixel>(crow) + (size_t)p.stride * bh);
            grain_row<pixel, entry>(g, bd, p.px<pixel>(crow), in.data(), p.stride, cw, bh, row,
                                    uv_t[pl], scaling[g.chroma_from_luma ? 0 : 1 + pl], sx, sy,
                                    src.px<pixel>(row * kBlock), src.stride, pl, lo, hi_uv);
        }
    }
}

}  // namespace

void film_grain_frame(Decoder& d) {
    const FilmGrain& g = d.fh.grain;
    // dav1d applies grain only where it can change a sample.
    if (!g.apply || !(g.num_y || g.num_uv[0] || g.num_uv[1] ||
                      (g.clip_restricted && g.chroma_from_luma)))
        return;
    if (d.seq.bit_depth > 8) film_grain_t<uint16_t, int16_t>(d);
    else film_grain_t<uint8_t, int8_t>(d);
}

}  // namespace av1
