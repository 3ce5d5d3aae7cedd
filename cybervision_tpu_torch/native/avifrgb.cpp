// An AVIF image's YUV planes to 8-bit RGB or RGBA, as libavif 1.3 converts
// them for Pillow (avifImageYUVToRGB with AVIF_CHROMA_UPSAMPLING_AUTOMATIC):
// through libyuv 1909 wherever it has a route, that is every 8-bit 4:2:0,
// 4:2:2 and 4:4:4 image and a 4:0:0 image to RGBA; through libavif's own
// float path for a 4:0:0 image to RGB. libyuv upsamples 4:2:0 chroma with
// its bilinear filter (ScaleRowUp2_Linear for the first and, at an even
// height, the last row, ScaleRowUp2_Bilinear for the row pairs between)
// and 4:2:2 chroma with its linear one, then converts each pixel in its
// 6-bit fixed point (YuvPixel) with the BT.601 constants: full range
// "JPEG", limited range "I601". Pinned against Pillow's planes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct YuvConstants {
    int yg, yb, ub, ug, vg, vr;
};
constexpr YuvConstants kJpeg = {16320, 32, 113, 22, 46, 90};
constexpr YuvConstants kI601 = {18997, -1160, 128, 25, 52, 102};

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

}  // namespace

extern "C" {

// y (h x w), u and v (((h+sy)>>sy) x ((w+sx)>>sx); unused when mono) to
// out (h x w x channels, channels 3 or 4; the alpha byte of 4 is left as
// it is). full: the full-range flag. Returns 0.
long avif_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, long w, long h,
                     long sx, long sy, long mono, long full, long channels, uint8_t* out) {
    const YuvConstants& k = full ? kJpeg : kI601;
    if (mono && channels == 3) {
        // libavif's avifImageYUV8ToRGB8Mono: (Y - bias) / range, clamped, then
        // 0.5 + x * 255 truncated, in float.
        uint8_t table[256];
        for (int i = 0; i < 256; i++) {
            float f = full ? (float)i / 255.0f : (float)(i - 16) / 219.0f;
            f = f < 0.0f ? 0.0f : f > 1.0f ? 1.0f : f;
            volatile float scaled = f * 255.0f;  // no fused multiply-add
            table[i] = (uint8_t)(0.5f + scaled);
        }
        for (long r = 0; r < h; r++)
            for (long c = 0; c < w; c++) {
                uint8_t g = table[y[r * w + c]];
                uint8_t* o = out + (r * w + c) * 3;
                o[0] = o[1] = o[2] = g;
            }
        return 0;
    }
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
