// LanePack segmented-reduce SpMV. Per 128-slot chunk c:
//   p[s]   = vals[c, s] * x[col_off[c]*128 + lane[c, s]]   (KW*128 window)
//   incl   = inclusive prefix sum of p over the chunk
//   y[chunk_rb[c]*128 + l] += incl[ends[c, l]]
//                             - (starts[c, l] < 0 ? 0 : incl[starts[c, l]])
//
// Replaces: sparse_matrix_tpu/ops/spmv.py, _make_lanepack_kernel (called by
// _spmv_lanepack_jit).
//
// Bound on the H100: device-memory bandwidth, about 8 bytes per slot (f32
// value, int16 lane, int8 end, int8 start) plus 8 bytes of chunk metadata
// per 128 slots; the KW*128 x window of a chunk is served by L2.
//
// First version: one warp per chunk, eight chunks (one slab) per block. The
// warp stages its 128 products in shared memory with coalesced loads, each
// thread scans four consecutive products, and a warp-shuffle scan of the
// thread totals completes the inclusive prefix sum in fp32 on the CUDA
// cores. The TPU kernel took the scan as a triangular matmul pinned to
// HIGHEST precision; no tensor core is used here, so no TF32 rounding can
// enter. Lanes with no run (ends == starts == 0, whose difference is an
// exact zero) skip their atomic; every other lane adds its run sum to y
// with one atomicAdd, which replaces the TPU's two-target (rb_a/rb_b/split)
// accumulation. The scan rounds differently from the reference's and the
// atomics make a row's sum vary in its last bits from run to run. The
// caller zeroes y.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kChunksPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void lanepack_kernel(const float* __restrict__ vals,
                                const int16_t* __restrict__ lane,
                                const int8_t* __restrict__ ends,
                                const int8_t* __restrict__ starts,
                                const int32_t* __restrict__ col_off,
                                const int32_t* __restrict__ chunk_rb,
                                int64_t num_chunks, int64_t cols,
                                const float* __restrict__ x,
                                float* __restrict__ y) {
  __shared__ float prefix[kChunksPerBlock][128];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * kChunksPerBlock + warp;
  if (c >= num_chunks) return;  // whole warp leaves; only warp syncs below
  const int64_t base = c * 128;
  const int64_t window = (int64_t)__ldg(col_off + c) * 128;
  float* p = prefix[warp];

  for (int k = 0; k < 4; ++k) {
    const int s = t + 32 * k;
    const int64_t j = window + lane[base + s];
    const float xv = j < cols ? __ldg(x + j) : 0.0f;
    p[s] = vals[base + s] * xv;
  }
  __syncwarp();

  // thread t owns products 4t .. 4t+3
  const float a0 = p[4 * t];
  const float a1 = a0 + p[4 * t + 1];
  const float a2 = a1 + p[4 * t + 2];
  const float a3 = a2 + p[4 * t + 3];
  float incl = a3;
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFullMask, incl, d);
    if (t >= d) incl += up;
  }
  float excl = __shfl_up_sync(kFullMask, incl, 1);
  if (t == 0) excl = 0.0f;
  __syncwarp();
  p[4 * t] = excl + a0;
  p[4 * t + 1] = excl + a1;
  p[4 * t + 2] = excl + a2;
  p[4 * t + 3] = excl + a3;
  __syncwarp();

  float* yrow = y + (int64_t)__ldg(chunk_rb + c) * 128;
  for (int k = 0; k < 4; ++k) {
    const int s = t + 32 * k;
    const int e = ends[base + s];
    const int st = starts[base + s];
    if (e == 0 && st == 0) continue;
    atomicAdd(yrow + s, p[e] - (st < 0 ? 0.0f : p[st]));
  }
}

}  // namespace

SPMX_API int spmx_lanepack(int device, const float* vals, const int16_t* lane,
                           const int8_t* ends, const int8_t* starts,
                           const int32_t* col_off, const int32_t* chunk_rb,
                           int64_t num_chunks, int64_t cols, const float* x,
                           float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_chunks == 0) return 0;
  const int64_t blocks = (num_chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  lanepack_kernel<<<(unsigned)blocks, 32 * kChunksPerBlock, 0,
                    (cudaStream_t)stream>>>(vals, lane, ends, starts, col_off,
                                            chunk_rb, num_chunks, cols, x, y);
  return (int)cudaGetLastError();
}
