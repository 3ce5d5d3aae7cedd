// Film grain synthesis (AV1 specification 7.18.3), applied to the output
// frame after loop restoration as dav1d 1.5 applies it by default (its
// fg_apply and filmgrain templates at 8 bits): a 73x82 luma grain
// template (38x44 or 73x82 for chroma) from the 16-bit shift-register
// generator and the Gaussian sequence, shaped by the auto-regressive
// filter (the chroma filter taking the co-located luma grain); scaling
// lookup tables interpolated between the signalled points; then rows of
// 32 luma lines in 32x32 blocks, each block's template offset drawn from
// a generator seeded by its row, blended with the block to its left and
// the row above over two samples where overlap is on, scaled by the
// source sample (or, for chroma, by a mix of it and the co-located source
// luma), added and clipped. Chroma reads the luma before its grain.

#include "av1.h"

#include "av1tables.h"

namespace av1 {

namespace {

constexpr int kGrainW = 82, kGrainH = 73, kBlock = 32;

using Template = int8_t[kGrainH][kGrainW];

inline int random_number(int bits, unsigned& state) {
    const int r = (int)state;
    unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    state = (r >> 1) | (bit << 15);
    return (int)((state >> (16 - bits)) & ((1u << bits) - 1));
}

inline int rnd2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

void generate_luma(const FilmGrain& g, Template& buf) {
    unsigned seed = (unsigned)g.seed;
    const int shift = 4 + g.grain_scale_shift, lag = g.ar_lag;
    for (int y = 0; y < kGrainH; y++)
        for (int x = 0; x < kGrainW; x++)
            buf[y][x] = (int8_t)rnd2(kGaussianSequence[random_number(11, seed)], shift);
    for (int y = 3; y < kGrainH; y++)
        for (int x = 3; x < kGrainW - 3; x++) {
            const int8_t* coeff = g.ar_y;
            int sum = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) break;
                    sum += *coeff++ * buf[y + dy][x + dx];
                }
            buf[y][x] = (int8_t)clip3(-128, 127, buf[y][x] + rnd2(sum, g.ar_shift));
        }
}

void generate_chroma(const FilmGrain& g, int uv, int sx, int sy, const Template& luma,
                     Template& buf) {
    unsigned seed = (unsigned)g.seed ^ (uv ? 0x49d8 : 0xb524);
    const int shift = 4 + g.grain_scale_shift, lag = g.ar_lag;
    const int w = sx ? 44 : kGrainW, h = sy ? 38 : kGrainH;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            buf[y][x] = (int8_t)rnd2(kGaussianSequence[random_number(11, seed)], shift);
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
            buf[y][x] = (int8_t)clip3(-128, 127, buf[y][x] + rnd2(sum, g.ar_shift));
        }
}

void generate_scaling(const uint8_t (*points)[2], int num, uint8_t* scaling) {
    if (!num) {
        std::memset(scaling, 0, 256);
        return;
    }
    std::memset(scaling, points[0][1], points[0][0]);
    for (int i = 0; i < num - 1; i++) {
        const int bx = points[i][0], by = points[i][1];
        const int dx = points[i + 1][0] - bx, dy = points[i + 1][1] - by;
        const int delta = dy * ((0x10000 + (dx >> 1)) / dx);
        for (int x = 0, d = 0x8000; x < dx; x++, d += delta) scaling[bx + x] = (uint8_t)(by + (d >> 16));
    }
    const int n = points[num - 1][0];
    std::memset(scaling + n, points[num - 1][1], 256 - n);
}

// The template sample of block offset (bx, by) (0 the current block, 1 the
// one to the left or above) at (x, y) within the block.
inline int sample(const Template& t, const int offsets[2][2], int sx, int sy, int bx, int by,
                  int x, int y) {
    const int r = offsets[bx][by];
    const int offx = 3 + (2 >> sx) * (3 + (r >> 4)), offy = 3 + (2 >> sy) * (3 + (r & 15));
    return t[offy + y + (kBlock >> sy) * by][offx + x + (kBlock >> sx) * bx];
}

// One row of blocks of a plane: dst and src at the row's first line, pw
// and bh its width and height in the plane's samples. luma (plane > 0):
// the source luma at the row's first line and its stride; uv: 0 Cb, 1 Cr.
void grain_row(const FilmGrain& g, uint8_t* dst, const uint8_t* src, int stride, int pw,
               int bh, int row_num, const Template& t, const uint8_t* scaling, int sx, int sy,
               const uint8_t* luma, int luma_stride, int uv, int lo, int hi) {
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
        const uint8_t* s = src + y * stride + bx + x;
        int val = *s;
        if (luma) {
            const uint8_t* l = luma + (y << sy) * luma_stride + ((bx + x) << sx);
            int avg = l[0];
            if (sx) avg = (avg + l[1] + 1) >> 1;
            val = avg;
            if (!g.chroma_from_luma) {
                const int combined = avg * g.uv_luma_mult[uv] + *s * g.uv_mult[uv];
                val = clip3(0, 255, (combined >> 6) + g.uv_offset[uv]);
            }
        }
        const int noise = rnd2(scaling[val] * grain, g.scaling_shift);
        dst[y * stride + bx + x] = (uint8_t)clip3(lo, hi, *s + noise);
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
            return clip3(-128, 127, rnd2(a * w[0] + b * w[1], 5));
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

}  // namespace

void film_grain_frame(Decoder& d) {
    const FilmGrain& g = d.fh.grain;
    const SequenceHeader& s = d.seq;
    // dav1d applies grain only where it can change a sample.
    if (!g.apply || !(g.num_y || g.num_uv[0] || g.num_uv[1] ||
                      (g.clip_restricted && g.chroma_from_luma)))
        return;
    const int w = d.fh.upscaled_width, h = d.fh.frame_height;
    const int sx = s.subsampling_x, sy = s.subsampling_y;
    static thread_local Template luma_t, uv_t[2];
    generate_luma(g, luma_t);
    uint8_t scaling[3][256];
    if (g.num_y || g.chroma_from_luma) generate_scaling(g.y_points, g.num_y, scaling[0]);
    for (int pl = 0; pl < 2; pl++) {
        if (s.num_planes > 1 && (g.num_uv[pl] || g.chroma_from_luma))
            generate_chroma(g, pl, sx, sy, luma_t, uv_t[pl]);
        if (g.num_uv[pl]) generate_scaling(g.uv_points[pl], g.num_uv[pl], scaling[1 + pl]);
    }
    const int lo = g.clip_restricted ? 16 : 0;
    const int hi_y = g.clip_restricted ? 235 : 255;
    const int hi_uv = !g.clip_restricted ? 255 : s.matrix_coefficients == 0 ? 235 : 240;
    // The source: the frame before its grain (chroma reads its luma), with
    // a column past an odd width where chroma is subsampled, as dav1d pads.
    Plane src = d.lr[0];
    if (sx && (w & 1))
        for (int y = 0; y < h; y++) src.row(y)[w] = src.row(y)[w - 1];
    const int rows = (h + kBlock - 1) / kBlock;
    for (int row = 0; row < rows; row++) {
        if (g.num_y) {
            const int bh = std::min(h - row * kBlock, kBlock);
            grain_row(g, d.lr[0].row(row * kBlock), src.row(row * kBlock), d.lr[0].stride, w, bh,
                      row, luma_t, scaling[0], 0, 0, nullptr, 0, 0, lo, hi_y);
        }
        if (s.num_planes == 1 || !(g.num_uv[0] || g.num_uv[1] || g.chroma_from_luma)) continue;
        const int bh = (std::min(h - row * kBlock, kBlock) + sy) >> sy;
        const int cw = (w + sx) >> sx, crow = (row * kBlock) >> sy;
        for (int pl = 0; pl < 2; pl++) {
            if (!g.chroma_from_luma && !g.num_uv[pl]) continue;
            Plane& p = d.lr[1 + pl];
            std::vector<uint8_t> in(p.row(crow), p.row(crow) + (size_t)p.stride * bh);
            grain_row(g, p.row(crow), in.data(), p.stride, cw, bh, row, uv_t[pl],
                      scaling[g.chroma_from_luma ? 0 : 1 + pl], sx, sy, src.row(row * kBlock),
                      src.stride, pl, lo, hi_uv);
        }
    }
}

}  // namespace av1
