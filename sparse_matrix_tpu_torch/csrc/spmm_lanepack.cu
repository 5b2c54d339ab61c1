// LanePack SpMM in the packed multi-RHS layout: x3 (>= c128, K, 128) holds
// x[j, q] at x3[j/128, q, j%128]; y3 (>= r128, K, 128) the same for y. Per
// 128-slot chunk c and column q:
//   p[s]  = vals[c, s] * x3[col_off[c] + (lane[c, s] >> 7), q, lane[c, s] & 127]
//   incl  = inclusive prefix sum of p over the chunk
//   y3[chunk_rb[c], q, l] += incl[ends[c, l]]
//                           - (starts[c, l] < 0 ? 0 : incl[starts[c, l]])
// (x past cols reads 0, so x3 needs no guard rows).
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_lanepack_spmm_kernel
// (called by _spmm_lanepack_jit).
//
// Bound on the H100: device-memory bandwidth. A slot's value, lane, end and
// start (8 bytes) and its chunk's metadata are read once for all K columns;
// x3 and y3 move 4*K bytes per row; the kw windows of a chunk (K rows of
// 128 floats each) are served by L2.
//
// First version: one warp per chunk, eight chunks per block, as in
// spmv_lanepack.cu. Each thread loads its four consecutive slots' value,
// lane, end and start once into registers, then loops over the K columns:
// it gathers its four x values, scans them, and a warp-shuffle scan of the
// thread totals completes the fp32 inclusive prefix sum (the TPU kernel
// batched the K scans into one triangular matmul at HIGHEST precision; no
// tensor core is used here). The prefix sums go through shared memory so
// that each lane can read the two it needs, and lanes with a run add their
// run sum to y3 with one atomicAdd. The empty default (ends = starts = 0)
// is skipped, so it adds nothing; starts = -1 opens a run at slot 0. Both
// packs (dense, per_rb) target rows through chunk_rb only. The caller zeroes
// y3 (or passes an accumulator); atomics make a row's sum vary in its last
// bits from run to run.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kChunksPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void lanepack_spmm_kernel(const float* __restrict__ vals,
                                     const int16_t* __restrict__ lane,
                                     const int8_t* __restrict__ ends,
                                     const int8_t* __restrict__ starts,
                                     const int32_t* __restrict__ col_off,
                                     const int32_t* __restrict__ chunk_rb,
                                     int64_t num_chunks, int64_t cols, int k,
                                     const float* __restrict__ x3,
                                     float* __restrict__ y3) {
  __shared__ float prefix[kChunksPerBlock][128];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * kChunksPerBlock + warp;
  if (c >= num_chunks) return;  // whole warp leaves; only warp syncs below
  const int64_t base = c * 128 + 4 * t;  // thread t owns slots 4t .. 4t+3
  const int64_t w0 = __ldg(col_off + c);
  float v[4];
  int64_t xoff[4];
  int e[4], st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ln = lane[base + i];
    // a slot past the columns reads 0: its value is dropped
    v[i] = w0 * 128 + ln < cols ? vals[base + i] : 0.0f;
    xoff[i] = ((w0 + (ln >> 7)) * k) * 128 + (ln & 127);
    e[i] = ends[base + i];
    st[i] = starts[base + i];
  }
  float* p = prefix[warp];
  float* yrow = y3 + ((int64_t)__ldg(chunk_rb + c) * k) * 128 + 4 * t;

  for (int q = 0; q < k; ++q) {
    const int64_t qo = (int64_t)q * 128;
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = v[i] == 0.0f ? 0.0f : v[i] * __ldg(x3 + xoff[i] + qo);
    }
    a[1] += a[0];
    a[2] += a[1];
    a[3] += a[2];
    float incl = a[3];
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFullMask, incl, d);
      if (t >= d) incl += up;
    }
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (t == 0) excl = 0.0f;
    __syncwarp();  // the previous column's reads of p are done
#pragma unroll
    for (int i = 0; i < 4; ++i) p[4 * t + i] = excl + a[i];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (e[i] == 0 && st[i] == 0) continue;
      atomicAdd(yrow + qo + i, p[e[i]] - (st[i] < 0 ? 0.0f : p[st[i]]));
    }
  }
}

}  // namespace

SPMX_API int spmx_lanepack_spmm(int device, const float* vals,
                                const int16_t* lane, const int8_t* ends,
                                const int8_t* starts, const int32_t* col_off,
                                const int32_t* chunk_rb, int64_t num_chunks,
                                int64_t cols, int k, const float* x3, float* y3,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_chunks == 0 || k == 0) return 0;
  const int64_t blocks = (num_chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  lanepack_spmm_kernel<<<(unsigned)blocks, 32 * kChunksPerBlock, 0,
                         (cudaStream_t)stream>>>(vals, lane, ends, starts,
                                                 col_off, chunk_rb, num_chunks,
                                                 cols, k, x3, y3);
  return (int)cudaGetLastError();
}
