// K1: dense-NCC hypothesis sweep of the refine pyramid levels.
//
// Replaces cybervision_tpu/ops/pallas_ncc.py:_sweep_kernel (driven by
// ncc_sweep). For every pixel p of img1 it walks the stripes o (outer) and
// the offsets u in [-window, window] (inner), in that order. Hypothesis
// (o, u) sits at q = p + u along the epipolar axis; its candidate is
// (qx, qy) = (floor(coeff*center + add)(q) + o, center(q)) for a vertical
// corridor (the transpose for a horizontal one). It scores the 11x11 NCC
// of img1 around p against the stripe's base warp w0[o] shifted by u,
// self-normalised by the warp's own 11x11 box statistics at q, masks by
// the source band, the candidate bounds, the corridor [start, end), p_ok,
// min_stdev and threshold, and keeps the FIRST strict maximum.
//
// Forms: axis 1 ("vert") sweeps u along rows, axis 2 ("horiz") along
// columns — the static forms, one epipolar axis for the whole image, which
// the affine main path runs. Axis 0 chooses per pixel from the vert field,
// rejects hypotheses whose source pixel has the other axis, and picks the
// warp shift per window element by that element's own axis (the per-pixel
// form of refine_pass, off the affine main path).
//
// Row-halo form (K1s, replaces the row_halo=True use of _sweep_kernel by
// pallas_ncc.py:ncc_sweep_sharded): a row shard of a larger image, whose
// fields carry rows of the neighbouring shards above and below — m_img
// (KS) for img1, m_f (window) for vert/center/coeff/add, m_w0
// (KS + window) for w0 — zero rows at the global top and bottom. A read
// inside a field's haloed extent reads the stored value, a read beyond it
// reads zero; the source band and the interior test use the global row
// row0_g + r against the global height h_total. Every value a pixel sees
// and every rounding it makes are those of the unsharded sweep, so the
// sharded result equals it bit for bit. Depth 0, row0_g 0 and h_total h
// are the unsharded sweep.
//
// What bounds it on Hopper: operations. The plain version and the Pallas
// kernel compute the window product separably, _box11(img1 * warp): per
// pixel and evaluated hypothesis 1 product, 10 row sums and 10 column
// sums (21 operations), plus the warp's box statistics once per stripe.
// At 1024^2 with 5 stripes and a 33-wide window a pixel has 165
// hypotheses, of which the cheap masks admit about 78 on the main path.
//
// Design of the static forms (sweep_tile_kernel): one block of 256
// threads per output tile (16x64 for "horiz", 64x16 for "vert": short
// along the sweep axis, so the band below stays small), every operand
// in dynamic shared memory:
// - once: the img1 tile with its KS halo;
// - per stripe and chunk of offsets [u0, u1] (the offsets of a stripe in
//   increasing order, cut into chunks of the plan's length): the band of
//   w0[o] that the tile's shifts by u0..u1 read (the tile widened by
//   [u0, u1] along the sweep axis, +- KS around it), the warp's 11x11
//   box sums over the band (row sums in dx order into a scratch plane,
//   then column sums in dy order: box_sums_kernel's and _box11's order),
//   and per q of the band the candidate fields: center (NaN where q fails
//   a mask that does not depend on p — source band, candidate bounds,
//   min_stdev — so one compare rejects it), floor(coeff*center + add) + o,
//   the warp's mean and deviation. The band grows with the chunk, not the
//   window: a window whose whole band fits one block (up to 164 "horiz",
//   150 "vert" in the H100's 227 KB) runs as one chunk of 2 * window + 1
//   offsets; a wider one in the fewest chunks that fit. The first-maximum carry stays in
//   registers across chunks, so the sweep order is the same either way;
// - per offset u: a block vote (__syncthreads_or) on whether any pixel of
//   the tile admits (o, u) (p_ok and the corridor [start, end)); if none
//   does, nothing is computed. Otherwise the product plane's 11-wide row
//   sums over the tile's rows +-KS (each thread four neighbouring sums
//   from 14 products held in registers: a product is computed once per
//   four sums, not eleven), then per pixel the 11-tall column sum, the
//   normalisation and the strict '>' carry. Each thread owns four
//   vertically neighbouring pixels of one column for the whole sweep, so
//   the stripe-major / offset-minor first-maximum rule holds as before.
// The summation order is the plain version's (rows of products in dx
// order, then those sums in dy order), and every rounding that decides a
// comparison is explicit (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn),
// so no FMA contraction moves floor(coeff*center + add) by a pixel or
// flips a threshold: the kernel equals the plain version bit for bit.
// Reads beyond a field's (haloed) extent stage as zero, like the plain
// version's padding. The shared-memory layout depends on the chunk; the
// wrapper's plan (ops.ncc_sweep.sweep_tile_plan) mirrors layout() below,
// and a launch whose byte count disagrees with it is refused.
//
// The per-pixel form (sweep_pixel_kernel) is the earlier design, one
// thread per pixel reading its 11x11 operands through L1/L2, with the
// warp's box sums from box_sums_kernel.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int KS = 5;
constexpr int kTileThreads = 256;
constexpr int kPix = 4;   // pixels per thread: 4 neighbouring rows of a column
constexpr int kRun = 4;   // row sums per work item of the row-sum phase
constexpr int kMaxSmem = 232448;

// Field pointers address local row 0: a haloed field's rows -m..h+m-1
// are reachable with negative row indices. w0, sw and sww hold n_o
// planes of h + 2 * m_w0 rows each.
struct SweepArgs {
  const float *img1, *vert, *center, *coeff, *add, *avg1, *isd1, *start,
      *end, *pok, *w0, *sw, *sww;
  float* out_corr;
  int32_t *out_x, *out_y;
  int h, w, n_o, corridor_size, window, h2, w2;
  int chunk;   // offsets per chunk of the static forms' sweep
  // Halo rows above and below img1, vert/center/coeff/add and w0.
  int m_img, m_f, m_w0;
  int row0_g, h_total;   // global row of local row 0; global height
  float threshold, min_stdev;
};

// ---------------------------------------------------------------------------
// Static forms: shared-memory tiles.

template <int kAxis> struct TileShape;
template <> struct TileShape<2> { static constexpr int H = 16, W = 64; };
template <> struct TileShape<1> { static constexpr int H = 64, W = 16; };

// Shared-memory layout of one block, in floats, for a chunk of span + 1
// offsets. ops.ncc_sweep's sweep_tile_plan computes the same numbers.
struct Layout {
  int ip, ir;          // img1 tile: pitch, rows (tile +- KS)
  int wp, wr;          // w0 band: pitch, rows (+- KS, + span on the axis)
  int bp, br, bc;      // per-q band planes: pitch, rows, columns
  int rp;              // row-sum plane pitch (ir rows)
  int o_w0, o_cen, o_off, o_avg, o_sd, o_tmp, total;
};

__host__ __device__ inline Layout layout(int axis, int span) {
  const int th = axis == 2 ? TileShape<2>::H : TileShape<1>::H;
  const int tw = axis == 2 ? TileShape<2>::W : TileShape<1>::W;
  const int sy = axis == 1 ? span : 0, sx = axis == 2 ? span : 0;
  Layout L;
  L.ir = th + 2 * KS;
  L.ip = tw + 2 * KS;
  L.wr = th + 2 * KS + sy;
  L.wp = tw + 2 * KS + sx;
  L.br = th + sy;
  L.bc = tw + sx;
  // "vert" tiles are 16 wide and a warp spans two rows of a plane: four
  // floats of padding put those rows on different banks.
  L.bp = axis == 1 ? L.bc + 4 : L.bc;
  L.rp = axis == 1 ? tw + 4 : tw;
  const int band = L.br * L.bp;
  const int rs = L.ir * L.rp, tmp = 2 * L.wr * L.bp;
  L.o_w0 = L.ir * L.ip;
  L.o_cen = L.o_w0 + L.wr * L.wp;
  L.o_off = L.o_cen + band;
  L.o_avg = L.o_off + band;
  L.o_sd = L.o_avg + band;
  L.o_tmp = L.o_sd + band;
  L.total = L.o_tmp + (rs > tmp ? rs : tmp);
  return L;
}

// At least 3 blocks per SM: without the bound, the chunk loop took "vert"
// to 103 registers a thread, 2 blocks per SM at window 16 (0.690 ms
// against 0.566 ms at 78 registers and 3 blocks).
template <int kAxis>
__global__ void __launch_bounds__(kTileThreads, 3)
sweep_tile_kernel(SweepArgs a) {
  constexpr int TH = TileShape<kAxis>::H, TW = TileShape<kAxis>::W;
  constexpr bool kVert = kAxis == 1;
  static_assert(TH * TW == kTileThreads * kPix, "one thread per kPix pixels");
  extern __shared__ float sm[];
  const Layout L = layout(kAxis, a.chunk - 1);
  float* s_img = sm;
  float* s_w0 = sm + L.o_w0;
  float* s_cen = sm + L.o_cen;
  float* s_off = sm + L.o_off;
  float* s_avg = sm + L.o_avg;
  float* s_sd = sm + L.o_sd;
  float* s_tmp = sm + L.o_tmp;  // box row sums; then the row-sum plane
  float* s_rs = s_tmp;
  const int h = a.h, w = a.w, win = a.window;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int px = tid % TW, py0 = (tid / TW) * kPix;
  const float inv_kpc = (float)(1.0 / 121.0);

  float best[kPix], avg1[kPix], isd1[kPix], st[kPix], en[kPix];
  int best_x[kPix], best_y[kPix];
  unsigned pok = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int r = r0 + py0 + k, c = c0 + px;
    best[k] = -CUDART_INF_F;
    best_x[k] = best_y[k] = 0;
    avg1[k] = isd1[k] = st[k] = en[k] = 0.f;
    if (r < h && c < w) {
      const long p = (long)r * w + c;
      if (a.pok[p] > 0.5f) pok |= 1u << k;
      avg1[k] = a.avg1[p];
      isd1[k] = a.isd1[p];
      st[k] = a.start[p];
      en[k] = a.end[p];
    }
  }

  for (int i = tid; i < L.ir * L.ip; i += kTileThreads) {
    const int y = r0 - KS + i / L.ip, x = c0 - KS + i % L.ip;
    s_img[i] = (y >= -a.m_img && y < h + a.m_img && x >= 0 && x < w)
                   ? a.img1[(long)y * w + x] : 0.f;
  }

  const long w0_plane = (long)(h + 2 * a.m_w0) * w;
  for (int oi = 0; oi < a.n_o; ++oi) {
    const float o_val = (float)(oi - a.corridor_size);
    const float* w0 = a.w0 + oi * w0_plane;
    for (int u0 = -win; u0 <= win; u0 += a.chunk) {
      const int u1 = min(win, u0 + a.chunk - 1);
      // The band's origin: the tile shifted by u0 along the sweep axis.
      const int dy = kVert ? u0 : 0, dx = kVert ? 0 : u0;
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < L.wr * L.wp; i += kTileThreads) {
        const int y = r0 - KS + dy + i / L.wp, x = c0 - KS + dx + i % L.wp;
        s_w0[i] = (y >= -a.m_w0 && y < h + a.m_w0 && x >= 0 && x < w)
                      ? w0[(long)y * w + x] : 0.f;
      }
      __syncthreads();
      // Warp box statistics over the band: 11-wide row sums (dx order) of
      // w0 and w0^2, then 11-tall column sums (dy order).
      float* t_s = s_tmp;
      float* t_ss = s_tmp + L.wr * L.bp;
      for (int i = tid; i < L.wr * L.bc; i += kTileThreads) {
        const int jy = i / L.bc, bj = i % L.bc;
        const float* row = s_w0 + jy * L.wp + bj;
        float s = row[0], ss = __fmul_rn(row[0], row[0]);
#pragma unroll
        for (int d = 1; d <= 2 * KS; ++d) {
          s = __fadd_rn(s, row[d]);
          ss = __fadd_rn(ss, __fmul_rn(row[d], row[d]));
        }
        t_s[jy * L.bp + bj] = s;
        t_ss[jy * L.bp + bj] = ss;
      }
      __syncthreads();
      // Per q of the band: the candidate fields of stripe o.
      for (int i = tid; i < L.br * L.bc; i += kTileThreads) {
        const int bi = i / L.bc, bj = i % L.bc;
        float s = t_s[bi * L.bp + bj], ss = t_ss[bi * L.bp + bj];
#pragma unroll
        for (int d = 1; d <= 2 * KS; ++d) {
          s = __fadd_rn(s, t_s[(bi + d) * L.bp + bj]);
          ss = __fadd_rn(ss, t_ss[(bi + d) * L.bp + bj]);
        }
        const float avg_w = __fmul_rn(s, inv_kpc);
        const float var_w = fmaxf(
            __fsub_rn(__fmul_rn(ss, inv_kpc), __fmul_rn(avg_w, avg_w)), 0.f);
        const float sd_w = __fsqrt_rn(var_w);
        const int qr = r0 + dy + bi, qc = c0 + dx + bj;
        const int src = kVert ? a.row0_g + qr : qc;
        const int dim = kVert ? a.h_total : w;
        bool ok = qr >= -a.m_f && qr < h + a.m_f && qc >= 0 && qc < w &&
                  src >= KS && src < dim - KS;
        float cen = CUDART_NAN_F, off = 0.f;
        if (ok) {
          const long q = (long)qr * w + qc;
          cen = a.center[q];
          off = floorf(__fadd_rn(__fmul_rn(a.coeff[q], cen), a.add[q])) + o_val;
          const float qx = kVert ? off : cen, qy = kVert ? cen : off;
          ok = qx >= (float)KS && qx < (float)(a.w2 - KS) && qy >= (float)KS &&
               qy < (float)(a.h2 - KS) && sd_w >= a.min_stdev;
        }
        const int b = bi * L.bp + bj;
        s_cen[b] = ok ? cen : CUDART_NAN_F;
        s_off[b] = off;
        s_avg[b] = avg_w;
        s_sd[b] = sd_w;
      }
      __syncthreads();

      for (int u = u0; u <= u1; ++u) {
        // Band index of q = p + u for this thread's first pixel; the next
        // pixel is one band row further.
        const int b0 = kVert ? (py0 + u - u0) * L.bp + px
                             : py0 * L.bp + px + u - u0;
        unsigned adm = 0;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float cen = s_cen[b0 + k * L.bp];
          if ((pok >> k & 1u) && cen >= st[k] && cen < en[k]) adm |= 1u << k;
        }
        // Also the barrier between the previous offset's column sums and
        // this one's row sums.
        if (!__syncthreads_or(adm)) continue;
        // Row sums of img1 * (w0 shifted by u) over the tile's rows +- KS.
        const int uy = kVert ? u - u0 : 0, ux = kVert ? 0 : u - u0;
        constexpr int kItemsPerRow = TW / kRun;
        for (int i = tid; i < L.ir * kItemsPerRow; i += kTileThreads) {
          const int iy = i / kItemsPerRow, x0 = (i % kItemsPerRow) * kRun;
          const float* ir = s_img + iy * L.ip + x0;
          const float* wr = s_w0 + (iy + uy) * L.wp + x0 + ux;
          float prod[kRun + 2 * KS];
#pragma unroll
          for (int j = 0; j < kRun + 2 * KS; ++j) prod[j] = __fmul_rn(ir[j], wr[j]);
#pragma unroll
          for (int r = 0; r < kRun; ++r) {
            float s = prod[r];
#pragma unroll
            for (int d = 1; d <= 2 * KS; ++d) s = __fadd_rn(s, prod[r + d]);
            s_rs[iy * L.rp + x0 + r] = s;
          }
        }
        __syncthreads();
        if (!adm) continue;
        float rsv[kPix + 2 * KS];
#pragma unroll
        for (int j = 0; j < kPix + 2 * KS; ++j) rsv[j] = s_rs[(py0 + j) * L.rp + px];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (!(adm >> k & 1u)) continue;
          float cross = rsv[k];
#pragma unroll
          for (int d = 1; d <= 2 * KS; ++d) cross = __fadd_rn(cross, rsv[k + d]);
          const int b = b0 + k * L.bp;
          const float corr = __fdiv_rn(
              __fmul_rn(__fsub_rn(__fmul_rn(cross, inv_kpc),
                                  __fmul_rn(avg1[k], s_avg[b])),
                        isd1[k]),
              fmaxf(s_sd[b], 1e-12f));
          if (corr >= a.threshold && corr > best[k]) {
            best[k] = corr;
            const float cen = s_cen[b], off = s_off[b];
            best_x[k] = (int)(kVert ? off : cen);
            best_y[k] = (int)(kVert ? cen : off);
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int r = r0 + py0 + k, c = c0 + px;
    if (r < h && c < w) {
      const long p = (long)r * w + c;
      a.out_corr[p] = best[k];
      a.out_x[p] = best_x[k];
      a.out_y[p] = best_y[k];
    }
  }
}

// ---------------------------------------------------------------------------
// Per-pixel form: one thread per pixel.

// 11x11 window sums of every stripe's warp, zero outside the plane; rows
// of column sums, each summed in increasing offset order. The row-halo
// form passes the haloed plane (h + 2 * m_w0 rows): the sums a shard's
// sweep reads lie within `window` rows of it and see only stored rows.
__global__ void box_sums_kernel(const float* __restrict__ w0, int n_o, int h,
                                int w, float* __restrict__ sw,
                                float* __restrict__ sww) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long plane = (long)h * w;
  if (idx >= (long)n_o * plane) return;
  const int c = (int)(idx % w);
  const int r = (int)((idx / w) % h);
  const float* p = w0 + (idx / plane) * plane;
  float s = 0.f, ss = 0.f;
  for (int dy = -KS; dy <= KS; ++dy) {
    const int y = r + dy;
    float rs = 0.f, rss = 0.f;
    if (y >= 0 && y < h) {
      for (int dx = -KS; dx <= KS; ++dx) {
        const int x = c + dx;
        const float v = (x >= 0 && x < w) ? p[(long)y * w + x] : 0.f;
        rs = __fadd_rn(rs, v);
        rss = __fadd_rn(rss, __fmul_rn(v, v));
      }
    }
    s = __fadd_rn(s, rs);
    ss = __fadd_rn(ss, rss);
  }
  sw[idx] = s;
  sww[idx] = ss;
}

// 11x11 sum of img1 * warp around pixel (r, c) for the hypothesis shifted
// by u, rows of column products first, each in increasing offset order.
// Values outside a field's (haloed) extent read as zero, like the Pallas
// kernel's zero padding; kBounded = false skips img1's tests for a pixel
// whose whole window lies inside the image (every pixel p_ok admits on the
// main path). vert shares img1's test: its halo is at least as deep.
template <bool kBounded>
__device__ __forceinline__ float cross_sum(const SweepArgs& a,
                                           const float* __restrict__ w0,
                                           int r, int c, int u) {
  const int w = a.w, h = a.h;
  float cross = 0.f;
  for (int dy = -KS; dy <= KS; ++dy) {
    float rs = 0.f;
    const int y = r + dy;
    for (int dx = -KS; dx <= KS; ++dx) {
      const int x = c + dx;
      const bool in = !kBounded ||
                      (y >= -a.m_img && y < h + a.m_img && x >= 0 && x < w);
      const float iv = in ? a.img1[(long)y * w + x] : 0.f;
      // Warp element (y, x) is w0 shifted by u along the element's own
      // epipolar axis.
      const bool ve = in && a.vert[(long)y * w + x] > 0.5f;
      const int wy = ve ? y + u : y;
      const int wx = ve ? x : x + u;
      const bool win = wy >= -a.m_w0 && wy < h + a.m_w0 && wx >= 0 && wx < w;
      const float wv = win ? w0[(long)wy * w + wx] : 0.f;
      rs = __fadd_rn(rs, __fmul_rn(iv, wv));
    }
    cross = __fadd_rn(cross, rs);
  }
  return cross;
}

__global__ void sweep_pixel_kernel(SweepArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= a.h || c >= a.w) return;
  const int w = a.w, h = a.h;
  const long p = (long)r * w + c;
  float best = -CUDART_INF_F;
  int best_x = 0, best_y = 0;
  if (a.pok[p] > 0.5f) {
    const bool vert_p = a.vert[p] > 0.5f;
    const int rg = a.row0_g + r;
    const bool interior =
        rg >= KS && rg < a.h_total - KS && c >= KS && c < w - KS;
    const float start = a.start[p], end = a.end[p];
    const float avg1 = a.avg1[p], isd1 = a.isd1[p];
    const float inv_kpc = (float)(1.0 / 121.0);
    const long w0_plane = (long)(h + 2 * a.m_w0) * w;
    for (int oi = 0; oi < a.n_o; ++oi) {
      const float o_val = (float)(oi - a.corridor_size);
      const float* w0 = a.w0 + (long)oi * w0_plane;
      for (int u = -a.window; u <= a.window; ++u) {
        const int qr = vert_p ? r + u : r;
        const int qc = vert_p ? c : c + u;
        const int src = vert_p ? a.row0_g + qr : qc;
        const int dim = vert_p ? a.h_total : w;
        if (src < KS || src >= dim - KS) continue;
        const long q = (long)qr * w + qc;
        if ((a.vert[q] > 0.5f) != vert_p) continue;
        const float cen = a.center[q];
        const float off =
            floorf(__fadd_rn(__fmul_rn(a.coeff[q], cen), a.add[q])) + o_val;
        const float qx = vert_p ? off : cen;
        const float qy = vert_p ? cen : off;
        if (!(qx >= (float)KS && qx < (float)(a.w2 - KS) && qy >= (float)KS &&
              qy < (float)(a.h2 - KS)))
          continue;
        if (!(cen >= start && cen < end)) continue;
        const long bq = (long)oi * w0_plane + q;
        const float avg_w = __fmul_rn(a.sw[bq], inv_kpc);
        const float var_w = fmaxf(
            __fsub_rn(__fmul_rn(a.sww[bq], inv_kpc), __fmul_rn(avg_w, avg_w)),
            0.f);
        const float sd_w = __fsqrt_rn(var_w);
        if (!(sd_w >= a.min_stdev)) continue;
        // An interior p and the source band [KS, dim - KS) keep the whole
        // shifted window inside the image, hence inside every halo.
        const float cross = interior ? cross_sum<false>(a, w0, r, c, u)
                                     : cross_sum<true>(a, w0, r, c, u);
        const float corr = __fdiv_rn(
            __fmul_rn(__fsub_rn(__fmul_rn(cross, inv_kpc),
                                __fmul_rn(avg1, avg_w)),
                      isd1),
            fmaxf(sd_w, 1e-12f));
        if (!(corr >= a.threshold)) continue;
        if (corr > best) {
          best = corr;
          best_x = (int)qx;
          best_y = (int)qy;
        }
      }
    }
  }
  a.out_corr[p] = best;
  a.out_x[p] = best_x;
  a.out_y[p] = best_y;
}

template <int kAxis>
int launch_tiled(const SweepArgs& a, int tile_h, int tile_w, int smem_bytes,
                 cudaStream_t s) {
  constexpr int TH = TileShape<kAxis>::H, TW = TileShape<kAxis>::W;
  if (a.chunk < 1 || a.chunk > 2 * a.window + 1)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(kAxis, a.chunk - 1);
  if (tile_h != TH || tile_w != TW || smem_bytes != L.total * 4 ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // Set on every call: the limit belongs to the current device, which the
  // wrapper makes the fields'.
  cudaError_t e = cudaFuncSetAttribute(
      sweep_tile_kernel<kAxis>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.w + TW - 1) / TW, (a.h + TH - 1) / TH);
  sweep_tile_kernel<kAxis><<<grid, kTileThreads, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cv_box_sums(const void* w0, int n_o, int h, int w, void* sw,
                           void* sww, void* stream) {
  const long total = (long)n_o * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  const long grid = (total + threads - 1) / threads;
  box_sums_kernel<<<(unsigned)grid, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w0), n_o, h, w, static_cast<float*>(sw),
      static_cast<float*>(sww));
  return (int)cudaGetLastError();
}

// axis 1 / 2 launch the tiled kernel with the wrapper's plan (tile_h,
// tile_w, chunk, smem_bytes; sw and sww unused); axis 0 the per-pixel
// kernel, reading box_sums_kernel's sw and sww.
extern "C" int cv_ncc_sweep(const void* img1, const void* vert,
                            const void* center, const void* coeff,
                            const void* add, const void* avg1,
                            const void* isd1, const void* start,
                            const void* end, const void* pok, const void* w0,
                            const void* sw, const void* sww, void* out_corr,
                            void* out_x, void* out_y, int h, int w, int n_o,
                            int corridor_size, int window, int h2, int w2,
                            int axis, float threshold, float min_stdev,
                            int m_img, int m_f, int m_w0, int row0_g,
                            int h_total, int tile_h, int tile_w, int chunk,
                            int smem_bytes, void* stream) {
  if (h == 0 || w == 0) return 0;
  // Each haloed field's pointer moves to its local row 0.
  const long wl = w;
  SweepArgs a;
  a.img1 = static_cast<const float*>(img1) + m_img * wl;
  a.vert = static_cast<const float*>(vert) + m_f * wl;
  a.center = static_cast<const float*>(center) + m_f * wl;
  a.coeff = static_cast<const float*>(coeff) + m_f * wl;
  a.add = static_cast<const float*>(add) + m_f * wl;
  a.avg1 = static_cast<const float*>(avg1);
  a.isd1 = static_cast<const float*>(isd1);
  a.start = static_cast<const float*>(start);
  a.end = static_cast<const float*>(end);
  a.pok = static_cast<const float*>(pok);
  a.w0 = static_cast<const float*>(w0) + m_w0 * wl;
  a.sw = sw ? static_cast<const float*>(sw) + m_w0 * wl : nullptr;
  a.sww = sww ? static_cast<const float*>(sww) + m_w0 * wl : nullptr;
  a.out_corr = static_cast<float*>(out_corr);
  a.out_x = static_cast<int32_t*>(out_x);
  a.out_y = static_cast<int32_t*>(out_y);
  a.h = h;
  a.w = w;
  a.n_o = n_o;
  a.corridor_size = corridor_size;
  a.window = window;
  a.chunk = chunk;
  a.h2 = h2;
  a.w2 = w2;
  a.m_img = m_img;
  a.m_f = m_f;
  a.m_w0 = m_w0;
  a.row0_g = row0_g;
  a.h_total = h_total;
  a.threshold = threshold;
  a.min_stdev = min_stdev;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) return launch_tiled<1>(a, tile_h, tile_w, smem_bytes, s);
  if (axis == 2) return launch_tiled<2>(a, tile_h, tile_w, smem_bytes, s);
  if (!sw || !sww) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  sweep_pixel_kernel<<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
