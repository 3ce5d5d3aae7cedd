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
// form of refine_pass: the perspective path's, wherever the epipolar lines
// cross the image at an angle).
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
//   then column sums in dy order: _box11's order),
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
// The per-pixel form (sweep_pixel_tile_kernel). What bounds it is the same
// 21 operations per evaluated hypothesis; a thread per pixel reading its
// 121 window elements through L1/L2 would spend 363 loads and a 121-long
// dependent chain on each, compute every product again for each of the
// 121 pixels that share it, and diverge on every mask. The tiled design
// rests on one fact of the plain version: the warp of window
// element (y, x) follows that element's axis, not the scored pixel's, so
// for each (o, u) ONE product plane img1 * warp_u serves every pixel of a
// tile whatever its axis, and its 11x11 sums are separable as in the
// static forms. Only the candidate fields a pixel reads differ: a "vert"
// pixel reads q = p + u down the rows, a "horiz" one along the columns.
// One block of 256 threads per 32x32 output tile (square: the bands grow
// along both axes), four pixels a thread, the carry in registers:
// - once: img1 and the element axes over the tile +- KS; vote 1 (which
//   axes occur among those elements: which bands of w0 the product plane
//   reads); vote 2 (per axis, the smallest and largest offset any pixel
//   of that axis can admit, from the masks that hold for every stripe —
//   source band, vert(q) == vert(p), the centre's own bound, the
//   corridor). The sweep covers only [lo, hi] of the union: on a scene
//   whose corridors are narrow, the bands shrink with it.
// - per stripe and chunk of [lo, hi]: the row band of w0 (the tile +- KS
//   widened by the chunk down the rows) if a "vert" element reads it, the
//   column band (widened along the columns) if a "horiz" one does; for
//   each axis whose pixels can admit an offset of the chunk, the warp's
//   box sums over its band and its per-q planes, with the centre NaN where
//   q fails a mask that does not depend on p — including the axis gate,
//   vert(q) false in the row band and true in the column band.
// - per offset u: the block vote on whether any pixel admits (o, u) from
//   its own axis's planes; then the one product plane's row sums (element
//   by element from the band of its axis; a tile whose elements share one
//   axis reads that band alone) and per pixel the column sum, the
//   normalisation and the carry, as in the static forms.
// The rounding is the static forms', so the per-pixel kernel too equals
// the plain version bit for bit, and a uniform vert field gives the static
// kernel's result. Its plan (sweep_tile_plan(h, w, window, None)) keeps a
// chunk within 113 KB, two blocks per SM; pixel_layout() mirrors it and a
// launch whose byte count disagrees is refused. Reading the warp's box
// sums from planes made by a separate pass, instead of summing the band,
// was measured slower on the H100 and is not kept.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int KS = 5;
constexpr int kTileThreads = 256;
constexpr int kPix = 4;   // pixels per thread: 4 neighbouring rows of a column
constexpr int kRun = 4;   // row sums per work item of the row-sum phase
constexpr int kMaxSmem = 232448;
constexpr float kInvKpc = (float)(1.0 / 121.0);  // 1 / (11 * 11)

// Field pointers address local row 0: a haloed field's rows -m..h+m-1
// are reachable with negative row indices. w0 holds n_o planes of
// h + 2 * m_w0 rows each.
struct SweepArgs {
  const float *img1, *vert, *center, *coeff, *add, *avg1, *isd1, *start,
      *end, *pok, *w0;
  float* out_corr;
  int32_t *out_x, *out_y;
  int h, w, n_o, corridor_size, window, h2, w2;
  int chunk;   // offsets per chunk of the sweep
  // Halo rows above and below img1, vert/center/coeff/add and w0.
  int m_img, m_f, m_w0;
  int row0_g, h_total;   // global row of local row 0; global height
  float threshold, min_stdev;
};

// The warp's box statistics, shared by every form: the plain version's
// _box11 order on a band staged in shared memory.

// Warp mean and deviation from an 11x11 box sum of w0 and of w0^2.
__device__ __forceinline__ void warp_stats(float s, float ss, float& avg_w,
                                           float& sd_w) {
  avg_w = __fmul_rn(s, kInvKpc);
  const float var_w = fmaxf(
      __fsub_rn(__fmul_rn(ss, kInvKpc), __fmul_rn(avg_w, avg_w)), 0.f);
  sd_w = __fsqrt_rn(var_w);
}

// The NCC of a pixel's 11x11 window product sum `cross`, normalised by
// img1's mean and inverse deviation at p and the warp's at q.
__device__ __forceinline__ float ncc(float cross, float avg1, float isd1,
                                     float avg_w, float sd_w) {
  return __fdiv_rn(__fmul_rn(__fsub_rn(__fmul_rn(cross, kInvKpc),
                                       __fmul_rn(avg1, avg_w)),
                             isd1),
                   fmaxf(sd_w, 1e-12f));
}

// 11-wide row sums (dx order) of w0 and w0^2 over `rows` rows and `cols`
// columns of a band, into t_s / t_ss with pitch tp.
__device__ __forceinline__ void band_row_sums(const float* band, int bp,
                                              int rows, int cols, float* t_s,
                                              float* t_ss, int tp, int tid) {
  for (int i = tid; i < rows * cols; i += kTileThreads) {
    const int jy = i / cols, bj = i % cols;
    const float* row = band + jy * bp + bj;
    float s = row[0], ss = __fmul_rn(row[0], row[0]);
#pragma unroll
    for (int d = 1; d <= 2 * KS; ++d) {
      s = __fadd_rn(s, row[d]);
      ss = __fadd_rn(ss, __fmul_rn(row[d], row[d]));
    }
    t_s[jy * tp + bj] = s;
    t_ss[jy * tp + bj] = ss;
  }
}

// 11-tall column sums (dy order) of t_s / t_ss at (bi, bj).
__device__ __forceinline__ void box_at(const float* t_s, const float* t_ss,
                                       int tp, int bi, int bj, float& s,
                                       float& ss) {
  s = t_s[bi * tp + bj];
  ss = t_ss[bi * tp + bj];
#pragma unroll
  for (int d = 1; d <= 2 * KS; ++d) {
    s = __fadd_rn(s, t_s[(bi + d) * tp + bj]);
    ss = __fadd_rn(ss, t_ss[(bi + d) * tp + bj]);
  }
}

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
      // Warp box statistics over the band.
      float* t_s = s_tmp;
      float* t_ss = s_tmp + L.wr * L.bp;
      band_row_sums(s_w0, L.wp, L.wr, L.bc, t_s, t_ss, L.bp, tid);
      __syncthreads();
      // Per q of the band: the candidate fields of stripe o.
      for (int i = tid; i < L.br * L.bc; i += kTileThreads) {
        const int bi = i / L.bc, bj = i % L.bc;
        float s, ss, avg_w, sd_w;
        box_at(t_s, t_ss, L.bp, bi, bj, s, ss);
        warp_stats(s, ss, avg_w, sd_w);
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
          const float corr = ncc(cross, avg1[k], isd1[k], s_avg[b], s_sd[b]);
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
// Per-pixel form: shared-memory tiles over both epipolar axes.

constexpr int PTH = 32, PTW = 32;  // output tile of the per-pixel form

// Shared-memory layout of one per-pixel block, in floats, for a chunk of
// span + 1 offsets. ops.ncc_sweep's sweep_tile_plan computes the same
// numbers. Both bands hold the tile +- KS: the row band (read by "vert"
// elements) widened by span rows, the column band ("horiz" elements) by
// span columns. Each band has four per-q planes (centre, offset, warp
// mean, warp deviation) for the pixels of its axis: (PTH + span) x PTW
// for the row band, PTH x (PTW + span) for the column band.
struct PixLayout {
  int ip, ir;   // img1 and element-axis tile: pitch, rows (tile +- KS)
  int rwp;      // row band of w0: pitch (rows ir + span)
  int cwp;      // column band of w0: pitch (rows ir)
  int rqr;      // row band's per-q planes: rows (pitch PTW)
  int cqp;      // column band's per-q planes: pitch (rows PTH)
  int o_sel, o_rw, o_cw, o_rq, o_cq, o_tmp, total;
};

__host__ __device__ inline PixLayout pixel_layout(int span) {
  PixLayout L;
  L.ir = PTH + 2 * KS;
  L.ip = PTW + 2 * KS;
  L.rwp = L.ip;
  L.cwp = L.ip + span;
  L.rqr = PTH + span;
  L.cqp = PTW + span;
  const int img = L.ir * L.ip;
  L.o_sel = img;                          // one byte per element
  L.o_rw = L.o_sel + (img + 3) / 4;
  L.o_cw = L.o_rw + (L.ir + span) * L.rwp;
  L.o_rq = L.o_cw + L.ir * L.cwp;
  L.o_cq = L.o_rq + 4 * L.rqr * PTW;
  L.o_tmp = L.o_cq + 4 * PTH * L.cqp;
  // Scratch: the box row sums of one band (w0 and w0^2), later the
  // product plane's row sums.
  const int box_r = 2 * (L.ir + span) * PTW, box_c = 2 * L.ir * L.cqp;
  const int rs = L.ir * PTW;
  const int m = box_r > box_c ? box_r : box_c;
  L.total = L.o_tmp + (m > rs ? m : rs);
  return L;
}

// The masks of hypothesis u at pixel (r, c) that depend on no stripe:
// the source band, the axis gate vert(q) == vert(p), the centre's own
// candidate bound and the corridor. Every stripe's admission implies it.
// Branch-free (a q outside the source band reads p's own fields), so an
// unrolled scan keeps several offsets' loads in flight.
__device__ __forceinline__ bool admits_some_stripe(const SweepArgs& a, int r,
                                                   int c, bool vp, int u,
                                                   float st, float en) {
  const int g = vp ? a.row0_g + r + u : c + u;
  const bool src = g >= KS && g < (vp ? a.h_total : a.w) - KS;
  const long q = src ? (vp ? (long)(r + u) * a.w + c : (long)r * a.w + c + u)
                     : (long)r * a.w + c;
  const bool vq = __ldg(a.vert + q) > 0.5f;
  const float cen = __ldg(a.center + q);
  const float lim = (float)((vp ? a.h2 : a.w2) - KS);
  return src && vq == vp && cen >= st && cen < en && cen >= (float)KS &&
         cen < lim;
}

// Row sums of the product plane img1 * warp_u over the tile's rows +- KS,
// each work item four neighbouring sums from 14 products held in
// registers. Element (y, x) takes w0 shifted by u along its own axis: the
// row band one row further per offset, the column band one column.
// kMode 1: every element reads the row band, 2: the column band, 3: the
// band of its own axis (s_sel).
template <int kMode>
__device__ __forceinline__ void product_row_sums(
    const PixLayout& L, const float* s_img, const unsigned char* s_sel,
    const float* s_rw, const float* s_cw, float* s_rs, int du, int tid) {
  constexpr int kItemsPerRow = PTW / kRun;
  for (int i = tid; i < L.ir * kItemsPerRow; i += kTileThreads) {
    const int iy = i / kItemsPerRow, x0 = (i % kItemsPerRow) * kRun;
    const float* im = s_img + iy * L.ip + x0;
    const float* rw = s_rw + (iy + du) * L.rwp + x0;
    const float* cw = s_cw + iy * L.cwp + x0 + du;
    const unsigned char* sel = s_sel + iy * L.ip + x0;
    float prod[kRun + 2 * KS];
#pragma unroll
    for (int j = 0; j < kRun + 2 * KS; ++j) {
      const float wv = kMode == 1 ? rw[j] : kMode == 2 ? cw[j]
                                          : (sel[j] ? rw[j] : cw[j]);
      prod[j] = __fmul_rn(im[j], wv);
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      float s = prod[r];
#pragma unroll
      for (int d = 1; d <= 2 * KS; ++d) s = __fadd_rn(s, prod[r + d]);
      s_rs[iy * PTW + x0 + r] = s;
    }
  }
}

__global__ void __launch_bounds__(kTileThreads, 2)
sweep_pixel_tile_kernel(SweepArgs a) {
  extern __shared__ float sm[];
  __shared__ int s_lo[2], s_hi[2];
  __shared__ unsigned s_flags;
  const PixLayout L = pixel_layout(a.chunk - 1);
  float* s_img = sm;
  unsigned char* s_sel = reinterpret_cast<unsigned char*>(sm + L.o_sel);
  float* s_rw = sm + L.o_rw;
  float* s_cw = sm + L.o_cw;
  float* s_rq = sm + L.o_rq;   // centre, offset, mean, deviation planes
  float* s_cq = sm + L.o_cq;
  float* s_tmp = sm + L.o_tmp;  // box row sums; then the row-sum plane
  float* s_rs = s_tmp;
  const int rq_n = L.rqr * PTW, cq_n = PTH * L.cqp;
  const int h = a.h, w = a.w, win = a.window;
  const int r0 = blockIdx.y * PTH, c0 = blockIdx.x * PTW;
  const int tid = threadIdx.x;
  const int px = tid % PTW, py0 = (tid / PTW) * kPix;

  float best[kPix], avg1[kPix], isd1[kPix], st[kPix], en[kPix];
  int best_x[kPix], best_y[kPix];
  unsigned pok = 0, vmask = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int r = r0 + py0 + k, c = c0 + px;
    best[k] = -CUDART_INF_F;
    best_x[k] = best_y[k] = 0;
    avg1[k] = isd1[k] = st[k] = en[k] = 0.f;
    if (r < h && c < w) {
      const long p = (long)r * w + c;
      if (a.pok[p] > 0.5f) pok |= 1u << k;
      if (a.vert[p] > 0.5f) vmask |= 1u << k;
      avg1[k] = a.avg1[p];
      isd1[k] = a.isd1[p];
      st[k] = a.start[p];
      en[k] = a.end[p];
    }
  }
  if (tid == 0) {
    s_lo[0] = s_lo[1] = win + 1;
    s_hi[0] = s_hi[1] = -win - 1;
    s_flags = 0;
  }

  // img1 and the element axes over the tile +- KS. Vote 1: which axes
  // occur among the elements inside img1's extent (bit 0 "vert", bit 1
  // "horiz"), i.e. which bands of w0 the product plane reads.
  unsigned flags = 0;
  for (int i = tid; i < L.ir * L.ip; i += kTileThreads) {
    const int y = r0 - KS + i / L.ip, x = c0 - KS + i % L.ip;
    float v = 0.f;
    bool ve = false;
    if (y >= -a.m_img && y < h + a.m_img && x >= 0 && x < w) {
      const long e = (long)y * w + x;
      v = __ldg(a.img1 + e);
      ve = __ldg(a.vert + e) > 0.5f;
      flags |= ve ? 1u : 2u;
    }
    s_img[i] = v;
    s_sel[i] = ve;
  }
  // Vote 2: the offsets the tile's pixels of each axis can admit, from the
  // masks that hold for every stripe. A pixel tests only the offsets
  // outside the range its thread has found so far for its axis.
  int lo[2] = {win + 1, win + 1}, hi[2] = {-win - 1, -win - 1};
  for (int k = 0; k < kPix; ++k) {
    if (!(pok >> k & 1u)) continue;
    const bool vp = vmask >> k & 1u;
    const int ax = vp ? 0 : 1, r = r0 + py0 + k, c = c0 + px;
    const int l0 = lo[ax], h0 = hi[ax];
    int l = l0, hh = h0;
#pragma unroll 4
    for (int u = -win; u <= win; ++u) {
      if (u >= l0 && u <= h0) continue;
      if (admits_some_stripe(a, r, c, vp, u, st[k], en[k])) {
        l = min(l, u);
        hh = max(hh, u);
      }
    }
    lo[ax] = l;
    hi[ax] = hh;
  }
  __syncthreads();
#pragma unroll
  for (int ax = 0; ax < 2; ++ax) {
    if (lo[ax] <= hi[ax]) {
      atomicMin(&s_lo[ax], lo[ax]);
      atomicMax(&s_hi[ax], hi[ax]);
    }
  }
  if (flags) atomicOr(&s_flags, flags);
  __syncthreads();
  const int lo_v = s_lo[0], hi_v = s_hi[0], lo_h = s_lo[1], hi_h = s_hi[1];
  const int mode = s_flags & 3u;
  const int lo_t = min(lo_v, lo_h), hi_t = max(hi_v, hi_h);

  const long w0_plane = (long)(h + 2 * a.m_w0) * w;
  // A tile whose pixels admit nothing (lo_t > hi_t) skips the sweep.
  for (int oi = 0; oi < a.n_o && lo_t <= hi_t; ++oi) {
    const float o_val = (float)(oi - a.corridor_size);
    const float* w0 = a.w0 + oi * w0_plane;
    for (int u0 = lo_t; u0 <= hi_t; u0 += a.chunk) {
      const int u1 = min(hi_t, u0 + a.chunk - 1), span = u1 - u0;
      // The per-q planes of an axis are staged only where a pixel of that
      // axis can admit an offset of this chunk; the others sit it out.
      const bool need_rq = lo_v <= u1 && hi_v >= u0;
      const bool need_cq = lo_h <= u1 && hi_h >= u0;
      if (!need_rq && !need_cq) continue;
      const unsigned act = pok & ((need_rq ? vmask : 0u) | (need_cq ? ~vmask : 0u));
      __syncthreads();  // the previous chunk's readers are done
      if (mode & 1) {
#pragma unroll 4
        for (int i = tid; i < (L.ir + span) * L.rwp; i += kTileThreads) {
          const int y = r0 - KS + u0 + i / L.rwp, x = c0 - KS + i % L.rwp;
          s_rw[i] = (y >= -a.m_w0 && y < h + a.m_w0 && x >= 0 && x < w)
                        ? __ldg(w0 + (long)y * w + x) : 0.f;
        }
      }
      if (mode & 2) {
        const int nc = L.ip + span;
#pragma unroll 4
        for (int i = tid; i < L.ir * nc; i += kTileThreads) {
          const int iy = i / nc, ix = i % nc;
          const int y = r0 - KS + iy, x = c0 - KS + u0 + ix;
          s_cw[iy * L.cwp + ix] =
              (y >= -a.m_w0 && y < h + a.m_w0 && x >= 0 && x < w)
                  ? __ldg(w0 + (long)y * w + x) : 0.f;
        }
      }
      __syncthreads();
      if (need_rq) {
        // q = p + u down the rows: (PTH + span) x PTW, box sums from the
        // row band; NaN centre where q is no "vert" source of stripe o.
        float* t_s = s_tmp;
        float* t_ss = s_tmp + (L.ir + span) * PTW;
        band_row_sums(s_rw, L.rwp, L.ir + span, PTW, t_s, t_ss, PTW, tid);
        __syncthreads();
#pragma unroll 2
        for (int i = tid; i < (PTH + span) * PTW; i += kTileThreads) {
          const int bi = i / PTW, bj = i % PTW;
          float s, ss, avg_w, sd_w;
          box_at(t_s, t_ss, PTW, bi, bj, s, ss);
          warp_stats(s, ss, avg_w, sd_w);
          const int qr = r0 + u0 + bi, qc = c0 + bj, src = a.row0_g + qr;
          bool ok = qr >= -a.m_f && qr < h + a.m_f && qc < w && src >= KS &&
                    src < a.h_total - KS;
          float cen = CUDART_NAN_F, off = 0.f;
          if (ok) {
            const long q = (long)qr * w + qc;
            cen = __ldg(a.center + q);
            off = floorf(__fadd_rn(__fmul_rn(__ldg(a.coeff + q), cen),
                                   __ldg(a.add + q))) + o_val;
            ok = __ldg(a.vert + q) > 0.5f && off >= (float)KS &&
                 off < (float)(a.w2 - KS) && cen >= (float)KS &&
                 cen < (float)(a.h2 - KS) && sd_w >= a.min_stdev;
          }
          s_rq[i] = ok ? cen : CUDART_NAN_F;
          s_rq[rq_n + i] = off;
          s_rq[2 * rq_n + i] = avg_w;
          s_rq[3 * rq_n + i] = sd_w;
        }
        if (need_cq) __syncthreads();  // the column band reuses the scratch
      }
      if (need_cq) {
        // q = p + u along the columns: PTH x (PTW + span), box sums from
        // the column band; NaN centre where q is no "horiz" source.
        const int nq = PTW + span;
        float* t_s = s_tmp;
        float* t_ss = s_tmp + L.ir * L.cqp;
        band_row_sums(s_cw, L.cwp, L.ir, nq, t_s, t_ss, L.cqp, tid);
        __syncthreads();
#pragma unroll 2
        for (int i = tid; i < PTH * nq; i += kTileThreads) {
          const int bi = i / nq, bj = i % nq;
          float s, ss, avg_w, sd_w;
          box_at(t_s, t_ss, L.cqp, bi, bj, s, ss);
          warp_stats(s, ss, avg_w, sd_w);
          const int qr = r0 + bi, qc = c0 + u0 + bj;
          bool ok = qr >= -a.m_f && qr < h + a.m_f && qc >= KS && qc < w - KS;
          float cen = CUDART_NAN_F, off = 0.f;
          if (ok) {
            const long q = (long)qr * w + qc;
            cen = __ldg(a.center + q);
            off = floorf(__fadd_rn(__fmul_rn(__ldg(a.coeff + q), cen),
                                   __ldg(a.add + q))) + o_val;
            ok = !(__ldg(a.vert + q) > 0.5f) && cen >= (float)KS &&
                 cen < (float)(a.w2 - KS) && off >= (float)KS &&
                 off < (float)(a.h2 - KS) && sd_w >= a.min_stdev;
          }
          const int b = bi * L.cqp + bj;
          s_cq[b] = ok ? cen : CUDART_NAN_F;
          s_cq[cq_n + b] = off;
          s_cq[2 * cq_n + b] = avg_w;
          s_cq[3 * cq_n + b] = sd_w;
        }
      }
      __syncthreads();

      for (int u = u0; u <= u1; ++u) {
        const int du = u - u0;
        unsigned adm = 0;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (!(act >> k & 1u)) continue;
          const float cen = (vmask >> k & 1u)
                                ? s_rq[(py0 + k + du) * PTW + px]
                                : s_cq[(py0 + k) * L.cqp + px + du];
          if (cen >= st[k] && cen < en[k]) adm |= 1u << k;
        }
        // Also the barrier between the previous offset's column sums and
        // this one's row sums.
        if (!__syncthreads_or(adm)) continue;
        if (mode == 1)
          product_row_sums<1>(L, s_img, s_sel, s_rw, s_cw, s_rs, du, tid);
        else if (mode == 2)
          product_row_sums<2>(L, s_img, s_sel, s_rw, s_cw, s_rs, du, tid);
        else
          product_row_sums<3>(L, s_img, s_sel, s_rw, s_cw, s_rs, du, tid);
        __syncthreads();
        if (!adm) continue;
        float rsv[kPix + 2 * KS];
#pragma unroll
        for (int j = 0; j < kPix + 2 * KS; ++j) rsv[j] = s_rs[(py0 + j) * PTW + px];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (!(adm >> k & 1u)) continue;
          float cross = rsv[k];
#pragma unroll
          for (int d = 1; d <= 2 * KS; ++d) cross = __fadd_rn(cross, rsv[k + d]);
          const bool vp = vmask >> k & 1u;
          const float* q = vp ? s_rq + (py0 + k + du) * PTW + px
                              : s_cq + (py0 + k) * L.cqp + px + du;
          const int n = vp ? rq_n : cq_n;
          const float corr = ncc(cross, avg1[k], isd1[k], q[2 * n], q[3 * n]);
          if (corr >= a.threshold && corr > best[k]) {
            best[k] = corr;
            const float cen = q[0], off = q[n];
            best_x[k] = (int)(vp ? off : cen);
            best_y[k] = (int)(vp ? cen : off);
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

int launch_pixel(const SweepArgs& a, int tile_h, int tile_w, int smem_bytes,
                 cudaStream_t s) {
  if (a.chunk < 1 || a.chunk > 2 * a.window + 1)
    return (int)cudaErrorInvalidValue;
  const PixLayout L = pixel_layout(a.chunk - 1);
  if (tile_h != PTH || tile_w != PTW || smem_bytes != L.total * 4 ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_pixel_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.w + PTW - 1) / PTW, (a.h + PTH - 1) / PTH);
  sweep_pixel_tile_kernel<<<grid, kTileThreads, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the tiled kernel of `axis` (0 per-pixel, 1 "vert", 2 "horiz")
// with the wrapper's plan (tile_h, tile_w, chunk, smem_bytes); a plan
// that disagrees with the kernel's layout is refused.
extern "C" int cv_ncc_sweep(const void* img1, const void* vert,
                            const void* center, const void* coeff,
                            const void* add, const void* avg1,
                            const void* isd1, const void* start,
                            const void* end, const void* pok, const void* w0,
                            void* out_corr, void* out_x, void* out_y, int h,
                            int w, int n_o, int corridor_size, int window,
                            int h2, int w2, int axis, float threshold,
                            float min_stdev, int m_img, int m_f, int m_w0,
                            int row0_g, int h_total, int tile_h, int tile_w,
                            int chunk, int smem_bytes, void* stream) {
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
  return launch_pixel(a, tile_h, tile_w, smem_bytes, s);
}
