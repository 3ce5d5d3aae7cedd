// Plane scaling as libavif 1.3's avifImageScaleWithLimit does it when a
// decoded frame is not its item's ispe size: each plane through libyuv
// 1909's ScalePlane (8 bits) or ScalePlane_12 (10 and 12 bits) at
// kFilterBox, which libyuv first reduces by the ratio (ScaleFilterReduce)
// and then serves by the path the sizes pick: a copy, a vertical-only
// filter, the exact 3/4, 1/2, 3/8 and 1/4 reductions, a box average
// past half on both axes, the 2x bilinear and linear upsamplers, and
// the general bilinear up and down filters (16.16 fixed-point steps).
//
// libyuv picks its row functions by the CPU; the x86 rows that libavif's
// wheel runs on a CPU with SSSE3 and AVX2 compute some results otherwise
// than its C rows, and those are followed here: 8-bit horizontal
// filtering at 7-bit fractions (ScaleFilterCols_SSSE3), and the 3/4 and
// 3/8 reductions' vertical-first boxes (ScaleRowDown34_*_Box_SSSE3,
// ScaleRowDown38_2_Box_SSSE3) on the columns their loops cover, the C
// rows on the rest of a row. The other SIMD rows equal the C rows.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Filter { kNone, kLinear, kBilinear, kBox };

int fixed_div(int num, int div) { return (int)(((int64_t)num << 16) / div); }
int fixed_div1(int num, int div) { return (int)((((int64_t)num << 16) - 0x00010001) / (div - 1)); }
int center_start(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s); }
int min1(int v) { return v < 1 ? 1 : v; }

// ScaleFilterReduce.
Filter reduce(int sw, int sh, int dw, int dh, Filter f) {
    if (f == kBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kBilinear;
    if (f == kBilinear) {
        if (sh == 1) f = kLinear;
        if (dh == sh || dh * 3 == sh) f = kLinear;
        if (sw == 1) f = kNone;
    }
    if (f == kLinear) {
        if (sw == 1) f = kNone;
        if (dw == sw || dw * 3 == sw) f = kNone;
    }
    return f;
}

// ScaleSlope: the first source position and the step, 16.16.
void slope(int sw, int sh, int dw, int dh, Filter f, int& x, int& y, int& dx, int& dy) {
    if (dw == 1 && sw >= 32768) dw = sw;
    if (dh == 1 && sh >= 32768) dh = sh;
    if (f == kBox) {
        dx = fixed_div(sw, dw);
        dy = fixed_div(sh, dh);
        x = y = 0;
    } else if (f == kBilinear || f == kLinear) {
        if (dw <= sw) {
            dx = fixed_div(sw, dw);
            x = center_start(dx, -32768);
        } else if (sw > 1 && dw > 1) {
            dx = fixed_div1(sw, dw);
            x = 0;
        }
        if (f == kLinear) {
            dy = fixed_div(sh, dh);
            y = dy >> 1;
        } else if (dh <= sh) {
            dy = fixed_div(sh, dh);
            y = center_start(dy, -32768);
        } else if (sh > 1 && dh > 1) {
            dy = fixed_div1(sh, dh);
            y = 0;
        }
    } else {
        dx = fixed_div(sw, dw);
        dy = fixed_div(sh, dh);
        x = center_start(dx, 0);
        y = center_start(dy, 0);
    }
}

template <typename T>
struct Scaler {
    static constexpr bool kByte = sizeof(T) == 1;

    // InterpolateRow(_16)_C, which the SIMD rows equal.
    static void interpolate(T* dst, const T* src, ptrdiff_t stride, int width, int f) {
        const T* src1 = src + stride;
        if (f == 0) {
            std::memcpy(dst, src, width * sizeof(T));
        } else if (f == 128) {
            for (int x = 0; x < width; x++) dst[x] = (T)((src[x] + src1[x] + 1) >> 1);
        } else {
            for (int x = 0; x < width; x++)
                dst[x] = (T)((src[x] * (256 - f) + src1[x] * f + 128) >> 8);
        }
    }

    // ScaleFilterCols: ScaleFilterCols_SSSE3's 7-bit blend at 8 bits,
    // ScaleFilterCols_16_C's 16-bit one above.
    static void filter_cols(T* dst, const T* src, int width, int x, int dx) {
        for (int j = 0; j < width; j++, x += dx) {
            int xi = x >> 16, a = src[xi];
            int b = (x & 0xffff) ? src[xi + 1] : a;  // not read past a row's end
            if (kByte) {
                int f = (x >> 9) & 0x7f;
                dst[j] = (T)(((128 - f) * a + f * b + 64) >> 7);
            } else {
                dst[j] = (T)(a + (int)(((int64_t)(x & 0xffff) * (b - a) + 0x8000) >> 16));
            }
        }
    }

    static void cols(T* dst, const T* src, int width, int x, int dx) {
        for (int j = 0; j < width; j++, x += dx) dst[j] = src[x >> 16];
    }

    // -- the exact reductions -------------------------------------------------

    static void down2(int dw, int dh, const T* src, ptrdiff_t ss, T* dst, ptrdiff_t ds) {
        for (int y = 0; y < dh; y++, src += 2 * ss, dst += ds)
            for (int x = 0; x < dw; x++)
                dst[x] = (T)((src[2 * x] + src[2 * x + 1] + src[ss + 2 * x] + src[ss + 2 * x + 1] + 2) >> 2);
    }

    static void down4(int dw, int dh, const T* src, ptrdiff_t ss, T* dst, ptrdiff_t ds) {
        for (int y = 0; y < dh; y++, src += 4 * ss, dst += ds)
            for (int x = 0; x < dw; x++) {
                int sum = 0;
                for (int r = 0; r < 4; r++)
                    for (int c = 0; c < 4; c++) sum += src[r * ss + 4 * x + c];
                dst[x] = (T)((sum + 8) >> 4);
            }
    }

    // One 3/4 row of ScaleRowDown34_{0,1}_Box: `near` weights the row
    // at s 3:1 (0) or 1:1 (1) against t.
    static void down34_row(const T* s, ptrdiff_t stride, T* d, int dw, int near) {
        const T* t = s + stride;
        // The SSSE3 rows take the columns of whole 24-sample groups:
        // the rows blended first (rounding up, as pavgb), then the taps.
        int n = kByte ? dw - dw % 24 : 0;
        for (int x = 0; x < dw; x += 3, s += 4, t += 4, d += 3) {
            if (x < n) {
                int v[4];
                for (int k = 0; k < 4; k++) {
                    int avg = (s[k] + t[k] + 1) >> 1;
                    v[k] = near == 0 ? (s[k] + avg + 1) >> 1 : avg;
                }
                d[0] = (T)((v[0] * 3 + v[1] + 2) >> 2);
                d[1] = (T)((v[1] + v[2] + 1) >> 1);
                d[2] = (T)((v[2] + v[3] * 3 + 2) >> 2);
                continue;
            }
            int a0 = (s[0] * 3 + s[1] + 2) >> 2, a1 = (s[1] + s[2] + 1) >> 1;
            int a2 = (s[2] + s[3] * 3 + 2) >> 2;
            int b0 = (t[0] * 3 + t[1] + 2) >> 2, b1 = (t[1] + t[2] + 1) >> 1;
            int b2 = (t[2] + t[3] * 3 + 2) >> 2;
            if (near == 0) {
                d[0] = (T)((a0 * 3 + b0 + 2) >> 2);
                d[1] = (T)((a1 * 3 + b1 + 2) >> 2);
                d[2] = (T)((a2 * 3 + b2 + 2) >> 2);
            } else {
                d[0] = (T)((a0 + b0 + 1) >> 1);
                d[1] = (T)((a1 + b1 + 1) >> 1);
                d[2] = (T)((a2 + b2 + 1) >> 1);
            }
        }
    }

    // ScalePlaneDown34 (filtered): rows 0, 1 and 2 of each 4 source rows.
    static void down34(int dw, int dh, const T* src, ptrdiff_t ss, T* dst, ptrdiff_t ds) {
        int y = 0;
        for (; y < dh - 2; y += 3) {
            down34_row(src, ss, dst, dw, 0);
            src += ss;
            dst += ds;
            down34_row(src, ss, dst, dw, 1);
            src += ss;
            dst += ds;
            down34_row(src + ss, -ss, dst, dw, 0);
            src += ss * 2;
            dst += ds;
        }
        if (dh % 3 == 2) {
            down34_row(src, ss, dst, dw, 0);
            src += ss;
            dst += ds;
            down34_row(src, 0, dst, dw, 1);
        } else if (dh % 3 == 1) {
            down34_row(src, 0, dst, dw, 0);
        }
    }

    // ScaleRowDown38_3_Box (3 rows) or _2_Box (2 rows): 8 samples to 3.
    static void down38_row(const T* s, ptrdiff_t stride, T* d, int dw, int rows) {
        // ScaleRowDown38_2_Box_SSSE3 averages its two rows first (rounding
        // up), then sums across, on whole groups of 6 outputs.
        int n = (kByte && rows == 2) ? dw - dw % 6 : 0;
        for (int x = 0; x < dw; x += 3, s += 8, d += 3) {
            if (x < n) {
                int v[8];
                for (int k = 0; k < 8; k++) v[k] = (s[k] + s[stride + k] + 1) >> 1;
                d[0] = (T)(((v[0] + v[1] + v[2]) * (65536 / 3)) >> 16);
                d[1] = (T)(((v[3] + v[4] + v[5]) * (65536 / 3)) >> 16);
                d[2] = (T)(((v[6] + v[7]) * (65536 / 2)) >> 16);
                continue;
            }
            uint32_t sum[3] = {0, 0, 0};
            for (int r = 0; r < rows; r++) {
                const T* p = s + r * stride;
                sum[0] += p[0] + p[1] + p[2];
                sum[1] += p[3] + p[4] + p[5];
                sum[2] += p[6] + p[7];
            }
            uint32_t big = 65536u / (3 * rows), small = 65536u / (2 * rows);
            d[0] = (T)((sum[0] * big) >> 16);
            d[1] = (T)((sum[1] * big) >> 16);
            d[2] = (T)((sum[2] * small) >> 16);
        }
    }

    static void down38(int dw, int dh, const T* src, ptrdiff_t ss, T* dst, ptrdiff_t ds) {
        int y = 0;
        for (; y < dh - 2; y += 3) {
            down38_row(src, ss, dst, dw, 3);
            src += ss * 3;
            dst += ds;
            down38_row(src, ss, dst, dw, 3);
            src += ss * 3;
            dst += ds;
            down38_row(src, ss, dst, dw, 2);
            src += ss * 2;
            dst += ds;
        }
        if (dh % 3 == 2) {
            down38_row(src, ss, dst, dw, 3);
            src += ss * 3;
            dst += ds;
            down38_row(src, 0, dst, dw, 3);
        } else if (dh % 3 == 1) {
            down38_row(src, 0, dst, dw, 3);
        }
    }

    // -- box, bilinear, nearest --------------------------------------------

    // ScalePlaneBox: a box's rows summed per column, then boxes of columns,
    // each sum scaled by 65536 / area (the result's low bits kept). At 8
    // bits the column sums are 16-bit: ScaleAddRow_AVX2 saturates them on
    // whole groups of 32 columns, the C row wraps the rest.
    static void box(int sw, int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst,
                    ptrdiff_t ds) {
        int x = 0, y = 0, dx = 0, dy = 0;
        const int max_y = sh << 16;
        slope(sw, sh, dw, dh, kBox, x, y, dx, dy);
        std::vector<uint32_t> row(sw);
        for (int j = 0; j < dh; j++, dst += ds) {
            int iy = y >> 16;
            const T* s = src + (ptrdiff_t)iy * ss;
            y += dy;
            if (y > max_y) y = max_y;
            int boxh = min1((y >> 16) - iy);
            std::fill(row.begin(), row.end(), 0);
            for (int k = 0; k < boxh; k++, s += ss)
                for (int i = 0; i < sw; i++) row[i] += s[i];
            if (kByte) {
                const int simd = sw & ~31;
                for (int i = 0; i < sw; i++) row[i] = i < simd ? std::min<uint32_t>(row[i], 0xffff)
                                                              : row[i] & 0xffff;
            }
            int cx = x;
            if (dx & 0xffff) {
                int minw = dx >> 16;
                int scale[2] = {65536 / (min1(minw) * boxh), 65536 / (min1(minw + 1) * boxh)};
                for (int i = 0; i < dw; i++) {
                    int ix = cx >> 16;
                    cx += dx;
                    int bw = min1((cx >> 16) - ix);
                    uint32_t sum = 0;
                    for (int k = 0; k < bw; k++) sum += row[ix + k];
                    dst[i] = (T)((sum * (uint32_t)scale[bw - minw]) >> 16);
                }
            } else {
                int bw = min1(dx >> 16);
                uint32_t scale = 65536 / (bw * boxh);
                int ix = cx >> 16;
                for (int i = 0; i < dw; i++, ix += bw) {
                    uint32_t sum = 0;
                    for (int k = 0; k < bw; k++) sum += row[ix + k];
                    dst[i] = (T)((sum * scale) >> 16);
                }
            }
        }
    }

    // ScalePlaneBilinearUp: columns filtered first (two rows kept), then
    // rows blended.
    static void bilinear_up(int sw, int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst,
                            ptrdiff_t ds, Filter f) {
        int x = 0, y = 0, dx = 0, dy = 0;
        const int max_y = (sh - 1) << 16;
        slope(sw, sh, dw, dh, f, x, y, dx, dy);
        if (y > max_y) y = max_y;
        int yi = y >> 16;
        const T* s = src + (ptrdiff_t)yi * ss;
        std::vector<T> rows(2 * (size_t)dw + 2);
        T* rowptr = rows.data();
        ptrdiff_t rowstride = dw;
        int lasty = yi;
        filter_cols(rowptr, s, dw, x, dx);
        if (sh > 1) s += ss;
        filter_cols(rowptr + rowstride, s, dw, x, dx);
        if (sh > 2) s += ss;
        for (int j = 0; j < dh; j++, dst += ds, y += dy) {
            yi = y >> 16;
            if (yi != lasty) {
                if (y > max_y) {
                    y = max_y;
                    yi = y >> 16;
                    s = src + (ptrdiff_t)yi * ss;
                }
                if (yi != lasty) {
                    filter_cols(rowptr, s, dw, x, dx);
                    rowptr += rowstride;
                    rowstride = -rowstride;
                    lasty = yi;
                    if ((y + 65536) < max_y) s += ss;
                }
            }
            if (f == kLinear) interpolate(dst, rowptr, 0, dw, 0);
            else interpolate(dst, rowptr, rowstride, dw, (y >> 8) & 255);
        }
    }

    // ScalePlaneBilinearDown: rows blended first, then columns filtered.
    static void bilinear_down(int sw, int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst,
                              ptrdiff_t ds, Filter f) {
        int x = 0, y = 0, dx = 0, dy = 0;
        const int max_y = (sh - 1) << 16;
        slope(sw, sh, dw, dh, f, x, y, dx, dy);
        std::vector<T> row((size_t)sw + 1);
        if (y > max_y) y = max_y;
        for (int j = 0; j < dh; j++, dst += ds) {
            const T* s = src + (ptrdiff_t)(y >> 16) * ss;
            if (f == kLinear) {
                filter_cols(dst, s, dw, x, dx);
            } else {
                interpolate(row.data(), s, ss, sw, (y >> 8) & 255);
                filter_cols(dst, row.data(), dw, x, dx);
            }
            y += dy;
            if (y > max_y) y = max_y;
        }
    }

    // ScalePlaneVertical: the width kept, rows blended.
    static void vertical(int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst, ptrdiff_t ds,
                         int y, int dy, Filter f) {
        const int max_y = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
        for (int j = 0; j < dh; j++, dst += ds, y += dy) {
            if (y > max_y) y = max_y;
            interpolate(dst, src + (ptrdiff_t)(y >> 16) * ss, ss, dw, f ? (y >> 8) & 255 : 0);
        }
    }

    static void simple(int sw, int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst,
                       ptrdiff_t ds) {
        int x = 0, y = 0, dx = 0, dy = 0;
        slope(sw, sh, dw, dh, kNone, x, y, dx, dy);
        for (int i = 0; i < dh; i++, dst += ds, y += dy) cols(dst, src + (ptrdiff_t)(y >> 16) * ss, dw, x, dx);
    }

    // -- the 2x upsamplers -------------------------------------------------

    // ScaleRowUp2_Linear_Any: the ends copied, 3:1 taps between.
    static void up2_linear_row(const T* s, T* d, int dw) {
        d[0] = s[0];
        int work = (dw - 1) & ~1;
        for (int x = 0; x < work / 2; x++) {
            d[1 + 2 * x] = (T)((s[x] * 3 + s[x + 1] + 2) >> 2);
            d[2 + 2 * x] = (T)((s[x] + s[x + 1] * 3 + 2) >> 2);
        }
        d[dw - 1] = s[(dw - 1) / 2];
    }

    static void up2_linear(int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst,
                           ptrdiff_t ds) {
        if (dh == 1) {
            up2_linear_row(src + (ptrdiff_t)((sh - 1) / 2) * ss, dst, dw);
            return;
        }
        int dy = fixed_div(sh - 1, dh - 1), y = (1 << 15) - 1;
        for (int i = 0; i < dh; i++, dst += ds, y += dy)
            up2_linear_row(src + (ptrdiff_t)(y >> 16) * ss, dst, dw);
    }

    // ScaleRowUp2_Bilinear_Any: two output rows from two source rows
    // (9:3:3:1 taps), their ends from the columns' 3:1 blend.
    static void up2_bilinear_rows(const T* sa, ptrdiff_t sst, T* da, ptrdiff_t dst, int dw) {
        const T* sb = sa + sst;
        T* db = da + dst;
        da[0] = (T)((3 * sa[0] + sb[0] + 2) >> 2);
        db[0] = (T)((sa[0] + 3 * sb[0] + 2) >> 2);
        int work = (dw - 1) & ~1;
        for (int x = 0; x < work / 2; x++) {
            int s0 = sa[x], s1 = sa[x + 1], t0 = sb[x], t1 = sb[x + 1];
            T e0 = (T)((s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4);
            T e1 = (T)((s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4);
            da[1 + 2 * x] = (T)((s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4);
            da[2 + 2 * x] = (T)((s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4);
            db[1 + 2 * x] = e0;
            db[2 + 2 * x] = e1;
        }
        int last = (dw - 1) / 2;
        da[dw - 1] = (T)((3 * sa[last] + sb[last] + 2) >> 2);
        db[dw - 1] = (T)((sa[last] + 3 * sb[last] + 2) >> 2);
    }

    static void up2_bilinear(int sh, int dw, int dh, const T* src, ptrdiff_t ss, T* dst,
                             ptrdiff_t ds) {
        up2_bilinear_rows(src, 0, dst, 0, dw);
        dst += ds;
        for (int y = 0; y < sh - 1; y++, src += ss, dst += 2 * ds)
            up2_bilinear_rows(src, ss, dst, ds, dw);
        if (!(dh & 1)) up2_bilinear_rows(src, 0, dst, 0, dw);
    }

    // ScalePlane (8 bits) and ScalePlane_12 / ScalePlane_16 (above).
    static void plane(const T* src, int sw, int sh, T* dst, int dw, int dh) {
        const ptrdiff_t ss = sw, ds = dw;
        Filter f = reduce(sw, sh, dw, dh, kBox);
        if (!kByte) {  // ScalePlane_12's own 2x upsamplers come first
            if ((dw + 1) / 2 == sw && f == kLinear) return up2_linear(sh, dw, dh, src, ss, dst, ds);
            if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == kBilinear || f == kBox))
                return up2_bilinear(sh, dw, dh, src, ss, dst, ds);
        }
        if (dw == sw && dh == sh) {
            std::memcpy(dst, src, (size_t)sw * sh * sizeof(T));
            return;
        }
        if (dw == sw && f != kBox) {
            int y = 0, dy = 0;
            if (dh <= sh) {
                dy = fixed_div(sh, dh);
                y = center_start(dy, -32768);
            } else if (sh > 1 && dh > 1) {
                dy = fixed_div1(sh, dh);
            }
            return vertical(sh, dw, dh, src, ss, dst, ds, y, dy, f);
        }
        if (dw <= sw && dh <= sh) {
            if (4 * dw == 3 * sw && 4 * dh == 3 * sh) {
                if (f) return down34(dw, dh, src, ss, dst, ds);
            } else if (2 * dw == sw && 2 * dh == sh) {
                if (f) return down2(dw, dh, src, ss, dst, ds);
            } else if (8 * dw == 3 * sw && 8 * dh == 3 * sh) {
                if (f) return down38(dw, dh, src, ss, dst, ds);
            } else if (4 * dw == sw && 4 * dh == sh && (f == kBox || f == kNone)) {
                if (f) return down4(dw, dh, src, ss, dst, ds);
            }
        }
        if (f == kBox && dh * 2 < sh) return box(sw, sh, dw, dh, src, ss, dst, ds);
        if ((dw + 1) / 2 == sw && f == kLinear) return up2_linear(sh, dw, dh, src, ss, dst, ds);
        if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == kBilinear || f == kBox))
            return up2_bilinear(sh, dw, dh, src, ss, dst, ds);
        if (f && dh > sh) return bilinear_up(sw, sh, dw, dh, src, ss, dst, ds, f);
        if (f) return bilinear_down(sw, sh, dw, dh, src, ss, dst, ds, f);
        simple(sw, sh, dw, dh, src, ss, dst, ds);
    }
};

}  // namespace

extern "C" {

// One plane of src_w x src_h samples (bytes, or uint16_t when wide) to
// dst_w x dst_h, as libyuv scales it for libavif. The caller checks the
// sizes as avifImageScaleWithLimit does.
void yuv_scale_plane(const void* src, long src_w, long src_h, void* dst, long dst_w, long dst_h,
                     long wide) {
    if (wide)
        Scaler<uint16_t>::plane((const uint16_t*)src, (int)src_w, (int)src_h, (uint16_t*)dst,
                                (int)dst_w, (int)dst_h);
    else
        Scaler<uint8_t>::plane((const uint8_t*)src, (int)src_w, (int)src_h, (uint8_t*)dst,
                               (int)dst_w, (int)dst_h);
}

}
