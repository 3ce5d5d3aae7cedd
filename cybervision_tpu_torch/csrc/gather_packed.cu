// K3: packed coordinate-table gather for RANSAC sampling.
//
// Replaces cybervision_tpu/ops/pallas_gather.py:_gather_kernel (driven by
// gather_packed): out[r][i] = table[r][idx[i]] for the (2, M) int32 table
// of 16/16-packed match coordinates, i.e. exactly take(table, idx, axis=1).
//
// What bounds it on Hopper: bytes. Each index is read once and two int32
// values are written (12 bytes per element, ~31 MB for the main path's
// 13 x 4 x 50,000 draws); the table itself is tiny. Random table reads are
// the only irregular access.
//
// Design: the table is read through the read-only L1/L2 path: at most
// 256 KB for the buckets RANSAC uses, it stays L2 resident, and a table of
// up to 8192 rows (64 KB) mostly in each SM's L1. The index and output
// streams are coalesced grid-stride loops over 16 blocks per SM. (Staging
// a small table into shared memory, the design up to 8192 rows before,
// held two blocks per SM and lost to torch.index_select on the H100:
// 18.6 vs 17.3 us of device time at 8192 rows, against 10.9 us for this
// path at 32768.)

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

__global__ void gather_packed_kernel(const int32_t* __restrict__ table, int m,
                                     const int32_t* __restrict__ idx, long k,
                                     int32_t* __restrict__ out0,
                                     int32_t* __restrict__ out1) {
  const int32_t* t0 = table;
  const int32_t* t1 = table + m;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += stride) {
    const int j = idx[i];
    // Indices come from randint over [0, top_limit) with top_limit <= M;
    // an out-of-range value writes 0 instead of reading out of bounds.
    const bool ok = j >= 0 && j < m;
    out0[i] = ok ? __ldg(t0 + j) : 0;
    out1[i] = ok ? __ldg(t1 + j) : 0;
  }
}

}  // namespace

extern "C" int cv_gather_packed(const void* table, int m, const void* idx,
                                long k, void* out, void* stream) {
  int32_t* out0 = static_cast<int32_t*>(out);
  int32_t* out1 = out0 + k;
  if (k == 0) return 0;
  // The wrapper makes the table's device the current one.
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long want = (k + kThreads - 1) / kThreads;
  const long cap = (long)kBlocksPerSm * sms;
  gather_packed_kernel<<<(int)(want < cap ? want : cap), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), m, static_cast<const int32_t*>(idx),
      k, out0, out1);
  return (int)cudaGetLastError();
}
