// An AVIF image's YUV planes to 8-bit RGB or RGBA, as libavif 1.3 converts
// them for Pillow (avifImageYUVToRGB with AVIF_CHROMA_UPSAMPLING_AUTOMATIC).
//
// libavif first refuses the matrix coefficients it cannot convert (3, 10,
// 11, 13, 14, 16 and above; YCgCo, 8, at limited range). Then it takes
// libyuv 1909 wherever libyuv has constants for the matrix and range:
// BT.601 (2, 5, 6), BT.709 (1) and BT.2020 NCL (9), each at full range
// ("JPEG", "F709", "V2020") and limited range ("I601", "H709", "2020"),
// and 12 (chromaticity-derived NCL) with colour primaries 1 or 2 (BT.709's
// constants), 5 or 6 (BT.601's) or 9 (BT.2020's). libyuv upsamples 4:2:0 chroma with its bilinear filter
// (ScaleRowUp2_Linear for the first and, at an even height, the last row,
// ScaleRowUp2_Bilinear for the row pairs between) and 4:2:2 chroma with
// its linear one, then converts each pixel in its 6-bit fixed point
// (YuvPixel); a 4:0:0 image to RGBA is I400ToARGBMatrix (YPixel).
//
// Every other case is libavif's own float path (reformat.c): identity
// (0) at 4:4:4 full range is copied; 4:4:4 with Kr/Kb coefficients is
// avifImageYUV8ToRGB8Color; 4:0:0 to RGB is avifImageYUV8ToRGB8Mono; the
// rest is avifImageYUVAnyToRGBAnySlow, whose 4:2:0 and 4:2:2 chroma are
// the 9/3/3/1 bilinear weights in float. Kr and Kb come from libavif's
// table (4 FCC, 7 SMPTE 240, 15 and any other code BT.601's) or, for 12,
// from the colour primaries (H.273 equations 32-33). Float expressions
// keep libavif's order and are built without contraction into
// multiply-adds (Makefile). Pinned against Pillow's planes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct YuvConstants {
    int yg, yb, ub, ug, vg, vr;
};
// libyuv 1909's row_common.cc (UB clamped to 128 at limited range).
constexpr YuvConstants kJpeg = {16320, 32, 113, 22, 46, 90};
constexpr YuvConstants kI601 = {18997, -1160, 128, 25, 52, 102};
constexpr YuvConstants kF709 = {16320, 32, 119, 12, 30, 101};
constexpr YuvConstants kH709 = {18997, -1160, 128, 14, 34, 115};
constexpr YuvConstants kV2020 = {16320, 32, 120, 11, 37, 94};
constexpr YuvConstants k2020 = {19003, -1160, 128, 12, 42, 107};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline void yuv_pixel(int y, int u, int v, const YuvConstants& k, uint8_t* rgb) {
    int bb = k.ub * 128 - k.yb, bg = k.ug * 128 + k.vg * 128 + k.yb, br = k.vr * 128 - k.yb;
    int y1 = (int)((uint32_t)(y * 0x0101 * k.yg) >> 16);
    rgb[0] = clamp255((y1 + v * k.vr - br) >> 6);
    rgb[1] = clamp255((y1 + bg - (u * k.ug + v * k.vg)) >> 6);
    rgb[2] = clamp255((y1 + u * k.ub - bb) >> 6);
}

// libyuv's ScaleRowUp2_Linear_Any: a row of (w + 1) / 2 samples to w.
void up_linear(const uint8_t* s, int w, uint8_t* d) {
    int work = (w - 1) & ~1;
    d[0] = s[0];
    for (int x = 0; x < work / 2; x++) {
        d[2 * x + 1] = (uint8_t)((3 * s[x] + s[x + 1] + 2) >> 2);
        d[2 * x + 2] = (uint8_t)((s[x] + 3 * s[x + 1] + 2) >> 2);
    }
    d[w - 1] = s[(w - 1) / 2];
}

// libyuv's ScaleRowUp2_Bilinear_Any: rows a and b to the two rows between.
void up_bilinear(const uint8_t* a, const uint8_t* b, int w, uint8_t* da, uint8_t* db) {
    int work = (w - 1) & ~1;
    da[0] = (uint8_t)((3 * a[0] + b[0] + 2) >> 2);
    db[0] = (uint8_t)((a[0] + 3 * b[0] + 2) >> 2);
    for (int x = 0; x < work / 2; x++) {
        int s0 = a[x], s1 = a[x + 1], t0 = b[x], t1 = b[x + 1];
        da[2 * x + 1] = (uint8_t)((s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4);
        da[2 * x + 2] = (uint8_t)((s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4);
        db[2 * x + 1] = (uint8_t)((s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4);
        db[2 * x + 2] = (uint8_t)((s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4);
    }
    int l = (w - 1) / 2;
    da[w - 1] = (uint8_t)((3 * a[l] + b[l] + 2) >> 2);
    db[w - 1] = (uint8_t)((a[l] + 3 * b[l] + 2) >> 2);
}

// libavif's colour primaries (rx, ry, gx, gy, bx, by, wx, wy) of the codes
// that reach its float path with matrix 12 (1, 2, 5, 6 and 9 take libyuv);
// a code not in its table takes BT.709's.
const float* primaries_of(int code) {
    static const float kTable[][9] = {
        {1, 0.64f, 0.33f, 0.3f, 0.6f, 0.15f, 0.06f, 0.3127f, 0.329f},
        {4, 0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f},
        {7, 0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f},
        {8, 0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f},
        {10, 1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f},
        {11, 0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f, 0.351f},
        {12, 0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f, 0.3290f},
        {22, 0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f, 0.3290f},
    };
    for (const auto& row : kTable)
        if ((int)row[0] == code) return row + 1;
    return kTable[0] + 1;
}

// avifCalcYUVCoefficients: (kr, kg, kb) of the codes that reach libavif's
// float path, BT.601's for any code its table lacks.
void coefficients(int matrix, int primaries, float* kr, float* kg, float* kb) {
    float r = 0.299f, b = 0.114f;
    static const float kTable[][3] = {{4, 0.30f, 0.11f}, {7, 0.212f, 0.087f}};
    if (matrix == 12) {
        const float* p = primaries_of(primaries);
        const float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4], bY = p[5];
        const float wX = p[6], wY = p[7];
        const float rZ = 1.0f - (rX + rY), gZ = 1.0f - (gX + gY), bZ = 1.0f - (bX + bY);
        const float wZ = 1.0f - (wX + wY);
        const float den = wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) +
                                bX * (rY * gZ - gY * rZ));
        r = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) + wZ * (gX * bY - bX * gY))) /
            den;
        b = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) + wZ * (rX * gY - gX * rY))) /
            den;
    } else {
        for (const auto& row : kTable)
            if ((int)row[0] == matrix) r = row[1], b = row[2];
    }
    *kr = r;
    *kg = 1.0f - r - b;
    *kb = b;
}

// libyuv's constants for the matrix and range, or null where libavif
// converts by itself (avifGetYUVConstants).
const YuvConstants* libyuv_constants(int matrix, int primaries, int full) {
    int system = 0;  // 601, 709 or 2020
    if (matrix == 2 || matrix == 5 || matrix == 6) system = 601;
    else if (matrix == 1) system = 709;
    else if (matrix == 9) system = 2020;
    else if (matrix == 12) {
        if (primaries == 1 || primaries == 2) system = 709;
        else if (primaries == 5 || primaries == 6) system = 601;
        else if (primaries == 9) system = 2020;
    }
    switch (system) {
        case 601: return full ? &kJpeg : &kI601;
        case 709: return full ? &kF709 : &kH709;
        case 2020: return full ? &kV2020 : &k2020;
        default: return nullptr;
    }
}

inline uint8_t unorm8(float c) {
    c = c < 0.0f ? 0.0f : c > 1.0f ? 1.0f : c;
    return (uint8_t)(0.5f + c * 255.0f);
}

// libavif's float path (see the file comment). mode 0 Kr/Kb coefficients,
// 1 identity, 2 YCgCo.
void libavif_float(const uint8_t* y, const uint8_t* u, const uint8_t* v, long w, long h, long sx,
                   long sy, long mono, long full, long channels, int mode, float kr, float kg,
                   float kb, uint8_t* out) {
    float ty[256], tuv[256];
    const float bias_y = full ? 0.0f : 16.0f, range_y = full ? 255.0f : 219.0f;
    const float range_uv = full ? 255.0f : 224.0f;
    for (int i = 0; i < 256; i++) {
        ty[i] = ((float)i - bias_y) / range_y;
        tuv[i] = mode == 1 ? ty[i] : ((float)i - 128.0f) / range_uv;
    }
    if (mono) {
        for (long r = 0; r < h; r++)
            for (long c = 0; c < w; c++) {
                uint8_t g = unorm8(ty[y[r * w + c]]);
                uint8_t* o = out + (r * w + c) * channels;
                o[0] = o[1] = o[2] = g;
            }
        return;
    }
    const long cw = (w + sx) >> sx;
    const float cr_r = 2 * (1 - kr), cb_b = 2 * (1 - kb);
    const float gr = kr * (1 - kr), gb = kb * (1 - kb);
    for (long j = 0; j < h; j++) {
        const long uvj = j >> sy;
        long adj_row = 0;  // avifImageYUVAnyToRGBAnySlow's neighbour rows
        if (sy && !(j == 0 || (j == h - 1 && (j & 1)))) adj_row = (j & 1) ? 1 : -1;
        for (long i = 0; i < w; i++) {
            const long uvi = i >> sx;
            const float Y = ty[y[j * w + i]];
            float Cb, Cr;
            if (!sx) {
                Cb = tuv[u[uvj * cw + uvi]];
                Cr = tuv[v[uvj * cw + uvi]];
            } else {
                long adj_col = 0;
                if (!(i == 0 || (i == w - 1 && (i & 1)))) adj_col = (i & 1) ? 1 : -1;
                const long a = uvj * cw + uvi, bcol = a + adj_col, brow = a + adj_row * cw;
                const long bboth = brow + adj_col;
                Cb = (tuv[u[a]] * (9.0f / 16.0f)) + (tuv[u[bcol]] * (3.0f / 16.0f)) +
                     (tuv[u[brow]] * (3.0f / 16.0f)) + (tuv[u[bboth]] * (1.0f / 16.0f));
                Cr = (tuv[v[a]] * (9.0f / 16.0f)) + (tuv[v[bcol]] * (3.0f / 16.0f)) +
                     (tuv[v[brow]] * (3.0f / 16.0f)) + (tuv[v[bboth]] * (1.0f / 16.0f));
            }
            float R, G, B;
            if (mode == 1) {
                G = Y, B = Cb, R = Cr;
            } else if (mode == 2) {
                const float t = Y - Cb;
                G = Y + Cb;
                B = t - Cr;
                R = t + Cr;
            } else {
                R = Y + cr_r * Cr;
                B = Y + cb_b * Cb;
                G = Y - ((2 * ((gr * Cr) + (gb * Cb))) / kg);
            }
            uint8_t* o = out + (j * w + i) * channels;
            o[0] = unorm8(R);
            o[1] = unorm8(G);
            o[2] = unorm8(B);
        }
    }
}

}  // namespace

extern "C" {

// y (h x w), u and v (((h+sy)>>sy) x ((w+sx)>>sx); unused when mono) to
// out (h x w x channels, channels 3 or 4; the alpha byte of 4 is left as
// it is). full: the full-range flag; matrix and primaries: the CICP
// codes. Returns 0; -1 where libavif's reformat fails (nothing written).
long avif_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, long w, long h,
                     long sx, long sy, long mono, long full, long matrix, long primaries,
                     long channels, uint8_t* out) {
    if (matrix == 3 || matrix == 10 || matrix == 11 || matrix == 13 || matrix == 14 ||
        matrix >= 16 || (matrix == 8 && !full))
        return -1;
    // A 4:0:0 image with the identity matrix takes BT.601's.
    const int mc = (mono && matrix == 0) ? 6 : (int)matrix;
    const YuvConstants* kp = libyuv_constants(mc, (int)primaries, (int)full);
    if (mono && channels == 3) {  // avifImageYUV8ToRGB8Mono
        libavif_float(y, u, v, w, h, sx, sy, 1, full, 3, 0, 0, 0, 0, out);
        return 0;
    }
    if (!kp) {
        float kr = 0, kg = 0, kb = 0;
        int mode = mc == 0 ? 1 : mc == 8 ? 2 : 0;
        if (!mode) coefficients(mc, (int)primaries, &kr, &kg, &kb);
        if (mode == 1 && !sx && !sy && full) {  // avifImageIdentity8ToRGB8ColorFullRange
            for (long i = 0; i < w * h; i++) {
                uint8_t* o = out + i * channels;
                o[0] = v[i], o[1] = y[i], o[2] = u[i];
            }
            return 0;
        }
        libavif_float(y, u, v, w, h, sx, sy, mono, full, channels, mode, kr, kg, kb, out);
        return 0;
    }
    const YuvConstants& k = *kp;
    if (mono) {  // libyuv's I400ToARGBMatrix (YPixel)
        for (long r = 0; r < h; r++)
            for (long c = 0; c < w; c++) {
                int y1 = (int)((uint32_t)(y[r * w + c] * 0x0101 * k.yg) >> 16);
                uint8_t g = clamp255((y1 + k.yb) >> 6);
                uint8_t* o = out + (r * w + c) * channels;
                o[0] = o[1] = o[2] = g;
            }
        return 0;
    }
    long cw = (w + sx) >> sx;
    std::vector<uint8_t> ua(w), va(w), ub(w), vb(w);
    auto row = [&](long r, const uint8_t* ur, const uint8_t* vr) {
        for (long c = 0; c < w; c++)
            yuv_pixel(y[r * w + c], ur[c], vr[c], k, out + (r * w + c) * channels);
    };
    if (!sx) {  // 4:4:4
        for (long r = 0; r < h; r++) row(r, u + r * cw, v + r * cw);
    } else if (!sy) {  // 4:2:2
        for (long r = 0; r < h; r++) {
            up_linear(u + r * cw, (int)w, ua.data());
            up_linear(v + r * cw, (int)w, va.data());
            row(r, ua.data(), va.data());
        }
    } else {  // 4:2:0
        up_linear(u, (int)w, ua.data());
        up_linear(v, (int)w, va.data());
        row(0, ua.data(), va.data());
        long r = 1, cr = 0;
        for (; r < h - 1; r += 2, cr++) {
            up_bilinear(u + cr * cw, u + (cr + 1) * cw, (int)w, ua.data(), ub.data());
            up_bilinear(v + cr * cw, v + (cr + 1) * cw, (int)w, va.data(), vb.data());
            row(r, ua.data(), va.data());
            row(r + 1, ub.data(), vb.data());
        }
        if (!(h & 1)) {
            up_linear(u + cr * cw, (int)w, ua.data());
            up_linear(v + cr * cw, (int)w, va.data());
            row(h - 1, ua.data(), va.data());
        }
    }
    return 0;
}

}
