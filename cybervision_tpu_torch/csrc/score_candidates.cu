// K2: batched RANSAC hypothesis scoring.
//
// Replaces cybervision_tpu/ops/pallas_score.py:_score_kernel (driven by
// score_candidates): for each candidate F (C of them) against every match
// (M), the Sampson error
//   err = (p2h^T F p1h)^2 / ((F p1h)_x^2 + (F p1h)_y^2 + (F^T p2h)_x^2 + (F^T p2h)_y^2)
// and per candidate the count of valid matches with err <= t and the sum of
// those errors.
//
// What bounds it on Hopper: operations, over the matches whose mask is set.
// The main path's table is a power-of-two bucket (32,768 rows for 13,066
// matches at 1024^2): the work these inputs need is C x M_valid elements of
// ~36 f32 operations each (24 G at C 50,000), against 1.8 MB of candidates
// and 0.5 MB of matches in and 400 KB of results out.
//
// Design:
// - A 2-D grid, candidate tiles x match splits, so the launch is several
//   waves on 132 SMs (7.7 over the main path's valid rows). A thread keeps
//   the nine F entries of kCandsPerThread candidates in registers: two
//   independent chains. The kernel is latency-bound, so few registers and
//   many resident warps (10 blocks of 4 warps per SM at 48 registers) beat
//   more candidates per thread, and short splits give more blocks. A block
//   stages its split, one slab of kSlab matches, through shared memory as
//   float4 (x1, y1, x2, y2) plus the mask, and every thread reads the
//   same match at once (a broadcast).
// - Padding costs nothing: a slab whose mask is all false is skipped by a
//   block-uniform vote (__syncthreads_or), and a masked row inside a slab
//   by a block-uniform branch. Nothing would have been added for either,
//   so the result is identical; holes anywhere in the table still work.
// - Deterministic reduction: each block writes per (split, candidate) an
//   exact int32 count and a compensated (Kahan) f32 sum in match order;
//   score_reduce_kernel adds them in split order, counts exactly and sums again
//   compensated. No atomics, so the result does not depend on scheduling.
// - Every product and sum is __fmul_rn / __fadd_rn in the order of
//   ops.score.sampson_error: no FMA contraction changes a rounding, so
//   the numerator and denominator equal the plain PyTorch version's bit
//   for bit. The quotient is first taken with __fdividef (a reciprocal
//   and a product, no branch), whose error is at most 2 ulp (2^-22
//   relative) for a denominator in [2^-126, 2^126]. Where that estimate
//   lies within t * 2^-18 of the threshold, or the denominator is outside
//   [2^-125, 2^125] (or NaN), the exactly rounded __fdiv_rn replaces it.
//   Outside the band the estimate and the exact quotient lie on the same
//   side of t with 2^-18 / 2^-22 = 16 times the error to spare, so every
//   count equals the plain version's bit for bit; a sum takes the estimate
//   (2^-22 relative per term, far inside rtol 1e-5). NaN (0/0) and +inf
//   compare false against the finite threshold, like the plain isfinite
//   guard.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kCandsPerThread = 2;
constexpr int kCandsPerBlock = kThreads * kCandsPerThread;
constexpr int kSlab = 256;

__device__ __forceinline__ float lin3(float a, float x, float b, float y,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// Sampson error of one candidate at one match, exact where it decides a
// count: see the note at the top.
__device__ __forceinline__ float sampson(const float* f, float4 p, float t,
                                         float band) {
  const float x1 = p.x, y1 = p.y, x2 = p.z, y2 = p.w;
  const float la = lin3(f[0], x1, f[1], y1, f[2]);
  const float lb = lin3(f[3], x1, f[4], y1, f[5]);
  const float lw = lin3(f[6], x1, f[7], y1, f[8]);
  const float ra = lin3(f[0], x2, f[3], y2, f[6]);
  const float rb = lin3(f[1], x2, f[4], y2, f[7]);
  const float bil = lin3(x2, la, y2, lb, lw);
  const float num = __fmul_rn(bil, bil);
  const float den = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(la, la), __fmul_rn(lb, lb)),
                __fmul_rn(ra, ra)),
      __fmul_rn(rb, rb));
  const float est = __fdividef(num, den);
  const bool in_range = den >= 0x1p-125f && den <= 0x1p125f;
  return in_range && !(fabsf(__fsub_rn(est, t)) <= band) ? est
                                                         : __fdiv_rn(num, den);
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float s = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(s, sum), y);
  sum = s;
}

// Block (x, y): candidates x * kCandsPerBlock + threadIdx.x + k * kThreads
// (k < kCandsPerThread) against matches [y * kSlab, (y + 1) * kSlab).
__global__ void __launch_bounds__(kThreads)
score_split_kernel(const float* __restrict__ ff, const float4* __restrict__ pts,
                   const uint8_t* __restrict__ mask, int c, int m, float t,
                   int32_t* __restrict__ part_count,
                   float* __restrict__ part_sum) {
  __shared__ float4 s_pt[kSlab];
  __shared__ uint8_t s_ok[kSlab];
  const int base = blockIdx.x * kCandsPerBlock + threadIdx.x;
  float f[kCandsPerThread][9];
  int cnt[kCandsPerThread];
  float sum[kCandsPerThread], comp[kCandsPerThread];
#pragma unroll
  for (int k = 0; k < kCandsPerThread; ++k) {
    const int cand = base + k * kThreads;
#pragma unroll
    for (int i = 0; i < 9; ++i) f[k][i] = cand < c ? ff[(long)cand * 9 + i] : 0.f;
    cnt[k] = 0;
    sum[k] = 0.f;
    comp[k] = 0.f;
  }
  const float band = __fmul_rn(t, 0x1p-18f);
  const int m0 = blockIdx.y * kSlab;
  const int n = min(kSlab, m - m0);
  int any = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint8_t ok = mask[m0 + i];
    s_ok[i] = ok;
    if (ok) s_pt[i] = pts[m0 + i];
    any |= ok;
  }
  // A slab with no valid row adds nothing: its partials stay 0.
  if (__syncthreads_or(any)) {
    for (int i = 0; i < n; ++i) {
      if (!s_ok[i]) continue;  // the same for every thread of the block
      const float4 p = s_pt[i];
#pragma unroll
      for (int k = 0; k < kCandsPerThread; ++k) {
        const float err = sampson(f[k], p, t, band);
        if (err <= t) {
          ++cnt[k];
          kahan_add(sum[k], comp[k], err);
        }
      }
    }
  }
  const long row = (long)blockIdx.y * c;
#pragma unroll
  for (int k = 0; k < kCandsPerThread; ++k) {
    const int cand = base + k * kThreads;
    if (cand < c) {
      part_count[row + cand] = cnt[k];
      part_sum[row + cand] = sum[k];
    }
  }
}

// Per candidate, the splits' partials in split order.
__global__ void score_reduce_kernel(const int32_t* __restrict__ part_count,
                                    const float* __restrict__ part_sum, int c,
                                    int n_splits, int32_t* __restrict__ count,
                                    float* __restrict__ esum) {
  const int cand = blockIdx.x * blockDim.x + threadIdx.x;
  if (cand >= c) return;
  int cnt = 0;
  float sum = 0.f, comp = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    cnt += part_count[(long)s * c + cand];
    kahan_add(sum, comp, part_sum[(long)s * c + cand]);
  }
  count[cand] = cnt;
  esum[cand] = sum;
}

}  // namespace

// The grid comes from the wrapper's plan (ops.score.score_plan), which
// mirrors kThreads, kCandsPerThread and kSlab; a plan that does not fit
// these constants is refused before anything launches.
extern "C" int cv_score_candidates(const void* ff, const void* pts,
                                   const void* mask, int c, int m, float t,
                                   int cand_tiles, int n_splits,
                                   void* part_count, void* part_sum,
                                   void* count, void* esum, void* stream) {
  if (c == 0) return 0;
  const bool tiles_ok = (long)cand_tiles * kCandsPerBlock >= c &&
                        (long)(cand_tiles - 1) * kCandsPerBlock < c;
  const bool splits_ok = n_splits == (m + kSlab - 1) / kSlab && n_splits <= 65535;
  if (!tiles_ok || !splits_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits > 0) {
    const dim3 grid(cand_tiles, n_splits);
    score_split_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(ff), static_cast<const float4*>(pts),
        static_cast<const uint8_t*>(mask), c, m, t,
        static_cast<int32_t*>(part_count), static_cast<float*>(part_sum));
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  score_reduce_kernel<<<(c + 255) / 256, 256, 0, s>>>(
      static_cast<const int32_t*>(part_count),
      static_cast<const float*>(part_sum), c, n_splits,
      static_cast<int32_t*>(count), static_cast<float*>(esum));
  return (int)cudaGetLastError();
}
