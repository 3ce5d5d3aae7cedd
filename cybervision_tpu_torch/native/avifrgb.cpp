// An AVIF image's YUV planes to 8-bit RGB or RGBA, as libavif 1.3 converts
// them for Pillow (avifImageYUVToRGB with AVIF_CHROMA_UPSAMPLING_AUTOMATIC).
//
// libavif first refuses the matrix coefficients it cannot convert (3, 10,
// 11, 13, 14, 17 and above; 16, YCgCo-Re, but at 10 bits full range;
// YCgCo, 8, at limited range; identity, 0, subsampled). Then it takes
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
//
// 10- and 12-bit planes (uint16_t samples) go to 8-bit RGB(A) as libavif
// 1.3 takes them. Where libyuv has the matrix's constants: 10-bit colour
// to RGBA by libyuv's 10-bit AlphaToARGB rows (chroma upsampled at 10
// bits, YuvPixel10_16, the alpha >> 2); 12-bit 4:2:0 to RGBA by
// I012ToARGBMatrix (chroma repeated, YuvPixel12_16); anything else with
// every plane first cut to 8 bits by libyuv's Convert16To8Plane
// (clamp255(v >> (depth - 8))), the alpha too but 4:0:0's, and converted
// as above. 4:0:0 to RGB and the matrices libyuv lacks take the float
// paths at the planes' own depth (tables of 2^depth entries, the limited
// range scaled by 2^(depth-8); identity included; YCgCo-Re's lifting on
// chroma rounded back to integers). An alpha no libyuv row carries is
// alpha_to_8, libavif's avifReformatAlpha (a float rescale).
// avif_unpremultiply is its avifRGBImageUnpremultiplyAlpha of 8-bit RGBA,
// which is libyuv's ARGBUnattenuate as its x86 SIMD rows compute it (see
// there). Each route pinned against the wheel's avifImageYUVToRGB.
//
// The other way, avif_rgb_to_yuv is what Pillow's AVIF writer asks of
// libavif (avifImageRGBToYUV of RGBA to 4:2:0, BT.601 at full range):
// libyuv 1909's ABGRToJ420, Y = (77 R + 150 G + 29 B + 128) >> 8 at each
// pixel, and U and V from each 2x2 quad averaged with rounding, first
// down the columns, then across (ARGBToUVJRow's pavgb; an odd last row or
// column is averaged with itself), U = (128 B - 85 G - 43 R + 0x8000) >> 8,
// V = (128 R - 107 G - 21 B + 0x8000) >> 8.

#include <algorithm>
#include <cmath>
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

// libyuv's YuvPixel (8 bits: y * 0x0101), YuvPixel10_16 (y << 6 | y >> 4,
// u and v >> 2) and YuvPixel12_16 (y << 4 | y >> 8, u and v >> 4).
inline void yuv_pixel(int y, int u, int v, const YuvConstants& k, uint8_t* rgb, int depth = 8) {
    int bb = k.ub * 128 - k.yb, bg = k.ug * 128 + k.vg * 128 + k.yb, br = k.vr * 128 - k.yb;
    uint32_t y32 = (uint32_t)y * 0x0101;
    if (depth > 8) {
        y32 = depth == 10 ? (uint32_t)(y << 6 | y >> 4) : (uint32_t)(y << 4 | y >> 8);
        u = clamp255(u >> (depth - 8));
        v = clamp255(v >> (depth - 8));
    }
    int y1 = (int)((y32 * (uint32_t)k.yg) >> 16);
    rgb[0] = clamp255((y1 + v * k.vr - br) >> 6);
    rgb[1] = clamp255((y1 + bg - (u * k.ug + v * k.vg)) >> 6);
    rgb[2] = clamp255((y1 + u * k.ub - bb) >> 6);
}

// libyuv's ScaleRowUp2_Linear_Any (and _16): a row of (w + 1) / 2 samples
// to w.
template <typename T>
void up_linear(const T* s, int w, T* d) {
    int work = (w - 1) & ~1;
    d[0] = s[0];
    for (int x = 0; x < work / 2; x++) {
        d[2 * x + 1] = (T)((3 * s[x] + s[x + 1] + 2) >> 2);
        d[2 * x + 2] = (T)((s[x] + 3 * s[x + 1] + 2) >> 2);
    }
    d[w - 1] = s[(w - 1) / 2];
}

// libyuv's ScaleRowUp2_Bilinear_Any (and _16): rows a and b to the two
// rows between.
template <typename T>
void up_bilinear(const T* a, const T* b, int w, T* da, T* db) {
    int work = (w - 1) & ~1;
    da[0] = (T)((3 * a[0] + b[0] + 2) >> 2);
    db[0] = (T)((a[0] + 3 * b[0] + 2) >> 2);
    for (int x = 0; x < work / 2; x++) {
        int s0 = a[x], s1 = a[x + 1], t0 = b[x], t1 = b[x + 1];
        da[2 * x + 1] = (T)((s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4);
        da[2 * x + 2] = (T)((s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4);
        db[2 * x + 1] = (T)((s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4);
        db[2 * x + 2] = (T)((s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4);
    }
    int l = (w - 1) / 2;
    da[w - 1] = (T)((3 * a[l] + b[l] + 2) >> 2);
    db[w - 1] = (T)((a[l] + 3 * b[l] + 2) >> 2);
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

// libavif's float path (see the file comment) at the planes' depth. mode 0
// Kr/Kb coefficients, 1 identity, 2 YCgCo, 3 YCgCo-Re (10 bits to 8: the
// chroma rounded back to integers, floorf(c * 1023 + 0.5), then H.273's
// lossless lifting, each colour clamped in turn).
template <typename pixel>
void libavif_float(const pixel* y, const pixel* u, const pixel* v, long w, long h, long sx,
                   long sy, long mono, long full, long channels, int mode, float kr, float kg,
                   float kb, int depth, uint8_t* out) {
    const int n = 1 << depth, up = depth - 8;
    std::vector<float> ty_(n), tuv_(n);
    float* ty = ty_.data();
    float* tuv = tuv_.data();
    const float max = (float)(n - 1);
    const float bias_y = full ? 0.0f : (float)(16 << up), range_y = full ? max : (float)(219 << up);
    const float range_uv = full ? max : (float)(224 << up), half = (float)(n >> 1);
    for (int i = 0; i < n; i++) {
        ty[i] = ((float)i - bias_y) / range_y;
        tuv[i] = mode == 1 ? ty[i] : ((float)i - half) / range_uv;
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
            if (mode == 3) {
                const int yy = y[j * w + i];
                const int cg = (int)std::floor(Cb * max + 0.5f);
                const int co = (int)std::floor(Cr * max + 0.5f);
                const int t = yy - (cg >> 1);
                const int g = std::clamp(t + cg, 0, 255), b = std::clamp(t - (co >> 1), 0, 255);
                uint8_t* o = out + (j * w + i) * channels;
                o[0] = (uint8_t)std::clamp(b + co, 0, 255);
                o[1] = (uint8_t)g;
                o[2] = (uint8_t)b;
                continue;
            }
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

// libyuv's route (see the file comment), for 8-bit planes or, with depth
// 10 or 12, its high bit depth rows; nearest: 4:2:0 chroma repeated over
// its 2x2 pixels (I012ToARGBMatrix), not upsampled by the filter.
template <typename T>
void libyuv_rgb(const T* y, const T* u, const T* v, long w, long h, long sx, long sy, long mono,
                long channels, const YuvConstants& k, uint8_t* out, int depth = 8,
                bool nearest = false) {
    if (mono) {  // libyuv's I400ToARGBMatrix (YPixel)
        for (long r = 0; r < h; r++)
            for (long c = 0; c < w; c++) {
                int y1 = (int)((uint32_t)(y[r * w + c] * 0x0101 * k.yg) >> 16);
                uint8_t g = clamp255((y1 + k.yb) >> 6);
                uint8_t* o = out + (r * w + c) * channels;
                o[0] = o[1] = o[2] = g;
            }
        return;
    }
    long cw = (w + sx) >> sx;
    std::vector<T> ua(w), va(w), ub(w), vb(w);
    auto row = [&](long r, const T* ur, const T* vr) {
        for (long c = 0; c < w; c++)
            yuv_pixel(y[r * w + c], ur[c], vr[c], k, out + (r * w + c) * channels, depth);
    };
    if (nearest) {
        for (long r = 0; r < h; r++) {
            for (long c = 0; c < w; c++) {
                ua[c] = u[(r >> sy) * cw + (c >> sx)];
                va[c] = v[(r >> sy) * cw + (c >> sx)];
            }
            row(r, ua.data(), va.data());
        }
    } else if (!sx) {  // 4:4:4
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
}

// libyuv's Convert16To8Plane of a plane of n samples at `depth` bits.
std::vector<uint8_t> to_8_bits(const uint16_t* p, long n, int depth) {
    std::vector<uint8_t> out(n);
    for (long i = 0; i < n; i++) out[i] = clamp255(p[i] >> (depth - 8));
    return out;
}

// libavif's avifReformatAlpha of a 10- or 12-bit alpha plane (n samples)
// to 8 bits: (int)(0.5 + a / (2^depth - 1) * 255) in float.
void alpha_to_8(const uint16_t* a, long n, long depth, uint8_t* out) {
    const float max = (float)((1 << depth) - 1);
    for (long i = 0; i < n; i++) {
        const int v = (int)(0.5f + ((float)a[i] / max) * 255.0f);
        out[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

}  // namespace

extern "C" {

// y (h x w), u and v (((h+sy)>>sy) x ((w+sx)>>sx); unused when mono) and
// the alpha a (h x w, full range; null for none), of bytes at depth 8 and
// uint16_t samples at 10 or 12, to out (h x w x channels, channels 3 or 4;
// the alpha byte of 4 is 255 without a). full: the full-range flag; matrix
// and primaries: the CICP codes. Returns 0; -1 where libavif's reformat
// fails (nothing written).
long avif_yuv_to_rgb(const void* y, const void* u, const void* v, const void* a, long w, long h,
                     long sx, long sy, long mono, long full, long matrix, long primaries,
                     long channels, long depth, uint8_t* out) {
    if (matrix == 3 || matrix == 10 || matrix == 11 || matrix == 13 || matrix == 14 ||
        matrix >= 17 || (matrix == 16 && (!full || depth != 10)) || (matrix == 8 && !full) ||
        (matrix == 0 && !mono && (sx || sy)))
        return -1;
    // A 4:0:0 image with the identity matrix takes BT.601's.
    const int mc = (mono && matrix == 0) ? 6 : (int)matrix;
    const YuvConstants* kp = libyuv_constants(mc, (int)primaries, (int)full);
    const bool wide = depth > 8, rgba = channels == 4;
    const long n = w * h;
    const uint16_t *y16 = (const uint16_t*)y, *u16 = (const uint16_t*)u, *v16 = (const uint16_t*)v;
    // The route: libavif's float paths (4:0:0 to RGB, the matrices libyuv
    // lacks), libyuv's 8-bit rows, its 10-bit AlphaToARGB rows, its
    // I012ToARGBMatrix, or every plane cut to 8 bits for its 8-bit rows.
    enum { kFloat, kLibyuv8, kLibyuv10, kI012, kCut } route;
    if ((mono && !rgba) || !kp) route = kFloat;
    else if (!wide) route = kLibyuv8;
    else if (rgba && !mono && depth == 10) route = kLibyuv10;
    else if (rgba && !mono && depth == 12 && sx && sy) route = kI012;
    else route = kCut;
    // The alpha bytes: copied at 8 bits; above, libyuv's shift where its
    // rows carry the alpha (those that cut the planes, but 4:0:0's, and the
    // 10-bit ones), else libavif's float rescale.
    if (rgba) {
        std::vector<uint8_t> a8(n, 255);
        if (a && !wide) std::memcpy(a8.data(), a, n);
        else if (a && (route == kLibyuv10 || (route == kCut && !mono)))
            a8 = to_8_bits((const uint16_t*)a, n, (int)depth);
        else if (a) alpha_to_8((const uint16_t*)a, n, depth, a8.data());
        for (long i = 0; i < n; i++) out[i * 4 + 3] = a8[i];
    }
    if (route == kFloat) {
        float kr = 0, kg = 0, kb = 0;
        int mode = mc == 0 ? 1 : mc == 8 ? 2 : mc == 16 ? 3 : 0;
        if (!mode && !mono) coefficients(mc, (int)primaries, &kr, &kg, &kb);
        if (mode == 1 && !sx && !sy && full && !wide) {  // avifImageIdentity8ToRGB8ColorFullRange
            const uint8_t *y8 = (const uint8_t*)y, *u8 = (const uint8_t*)u, *v8 = (const uint8_t*)v;
            for (long i = 0; i < n; i++) {
                uint8_t* o = out + i * channels;
                o[0] = v8[i], o[1] = y8[i], o[2] = u8[i];
            }
        } else if (wide) {  // ...YUV16ToRGB8..., AnyToRGBAnySlow
            libavif_float(y16, u16, v16, w, h, sx, sy, mono, full, channels, mode, kr, kg, kb,
                          (int)depth, out);
        } else {  // avifImageYUV8ToRGB8Mono, ...Color, AnyToRGBAnySlow
            libavif_float((const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, w, h, sx, sy,
                          mono, full, channels, mode, kr, kg, kb, 8, out);
        }
    } else if (route == kLibyuv8) {
        libyuv_rgb((const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, w, h, sx, sy, mono,
                   channels, *kp, out);
    } else if (route == kLibyuv10) {  // I010/I210/I410AlphaToARGBMatrix(Filter)
        libyuv_rgb(y16, u16, v16, w, h, sx, sy, mono, channels, *kp, out, 10);
    } else if (route == kI012) {
        libyuv_rgb(y16, u16, v16, w, h, sx, sy, mono, channels, *kp, out, 12, true);
    } else {
        const long cn = ((w + sx) >> sx) * ((h + sy) >> sy);
        std::vector<uint8_t> y8 = to_8_bits(y16, n, (int)depth);
        std::vector<uint8_t> u8 = mono ? y8 : to_8_bits(u16, cn, (int)depth);
        std::vector<uint8_t> v8 = mono ? y8 : to_8_bits(v16, cn, (int)depth);
        libyuv_rgb(y8.data(), u8.data(), v8.data(), w, h, sx, sy, mono, channels, *kp, out);
    }
    return 0;
}

// libavif's avifRGBImageUnpremultiplyAlpha of n 8-bit RGBA pixels in
// place: libyuv's ARGBUnattenuate, each colour c scaled by the 8.8 fixed
// point inverse of its alpha a (fixed_invtbl8: 0x10000 / a, 0xffff at 1,
// 0x100 at 255, 0 at 0) as (c * 0x101 * ia) >> 16 in 16-bit lanes, packed
// to bytes with signed saturation, as its SSSE3 and AVX2 rows do: at
// alpha 1 a colour of 128 or more becomes 0 (libyuv's C row clamps it to
// 255 instead).
void avif_unpremultiply(uint8_t* rgba, long n) {
    for (long i = 0; i < n; i++) {
        uint8_t* p = rgba + 4 * i;
        const uint32_t a = p[3];
        const uint32_t ia = a == 0 ? 0 : a == 1 ? 0xffff : a == 255 ? 0x100 : 0x10000 / a;
        for (int c = 0; c < 3; c++) {
            const uint32_t v = ((p[c] * 0x101u) * ia) >> 16;
            p[c] = v >= 0x8000 ? 0 : v > 255 ? 255 : (uint8_t)v;
        }
    }
}


// (h x w x 4) RGBA to y (h x w), u and v (((h+1)>>1) x ((w+1)>>1)), as
// above.
void avif_rgb_to_yuv(const uint8_t* rgba, long w, long h, uint8_t* y, uint8_t* u, uint8_t* v) {
    auto px = [&](long r, long c) { return rgba + ((size_t)r * w + c) * 4; };
    for (long r = 0; r < h; r++)
        for (long c = 0; c < w; c++) {
            const uint8_t* p = px(r, c);
            y[(size_t)r * w + c] = (uint8_t)((77 * p[0] + 150 * p[1] + 29 * p[2] + 128) >> 8);
        }
    long cw = (w + 1) >> 1, ch = (h + 1) >> 1;
    auto avg = [](int a, int b) { return (a + b + 1) >> 1; };
    for (long r = 0; r < ch; r++)
        for (long c = 0; c < cw; c++) {
            long r0 = 2 * r, r1 = std::min(2 * r + 1, h - 1), c0 = 2 * c, c1 = std::min(2 * c + 1, w - 1);
            int m[3];
            for (int k = 0; k < 3; k++)
                m[k] = avg(avg(px(r0, c0)[k], px(r1, c0)[k]), avg(px(r0, c1)[k], px(r1, c1)[k]));
            u[(size_t)r * cw + c] = (uint8_t)((128 * m[2] - 85 * m[1] - 43 * m[0] + 0x8000) >> 8);
            v[(size_t)r * cw + c] = (uint8_t)((128 * m[0] - 107 * m[1] - 21 * m[2] + 0x8000) >> 8);
        }
}

}
