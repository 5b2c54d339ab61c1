// BCSR SpMM: Y = A @ X for a block-sparse A of dense bs x bs blocks stored
// by block row (block_cols, block_offsets), held transposed (blocks_t[p] =
// blocks[p]^T, so column k of a block is a contiguous row):
//   Y[br*bs + i, n] = sum_{p in [off[br], off[br+1])} sum_k
//                     blocks_t[p, k, i] * X[block_cols[p]*bs + k, n]
// X (bcols*bs, F) and Y (brows*bs, F) row-major f32, F a multiple of 128.
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_bcsr_kernel (called by
// _spmm_bcsr_jit).
//
// Bound on the H100: the operations the product needs, 2*nnz*F, at
// 67 TFLOP/s, against A's entries plus X and Y once at 3.35 TB/s; at
// bs = 128 and F = 128 the dense-block work (2*bs^2*F per stored block) is
// 64 flops per byte of a block.
//
// Design: the block row's depth is the concatenation of its stored blocks'
// columns, and the live-depth stream of ops/spmm.py (bcsr_depth_stream)
// lists, per (block row, 64-row tile) in block then column order, the pairs
// (A row, X row) = (p*bs + k, block_cols[p]*bs + k) for the columns k of
// block p that hold a nonzero in the tile's rows. X arrives with each
// call, so the skip is on A's side only and
// holds only while X is finite (0 * inf is NaN): x_sum, the sum of X's
// elements that the wrapper computes with one device reduction, is finite
// only if every element is (an inf or NaN makes the sum inf or NaN; an
// overflow of finite values just takes the full walk), and then selects
// the live stream; else the kernel walks every column of every stored
// block (p*bs + k for k < bs).
// One 128-thread block per (block row, 64-row tile, 64-column tile of F),
// so small matrices still fill the card (blocked_2k: 16 block rows, 64
// blocks); each walks its stream through block_tile.h (cp.async ring, FP64
// MMA, f64 accumulators, one rounding to f32) and writes its tile once: a
// fixed sum order, no atomics, zeros for a block row with no block. The
// TPU kernel revisited the output block in a sequential grid, one MXU
// matmul per stored block.
#include <cuda_runtime.h>

#include "block_tile.h"
#include "spmx_cuda.h"

namespace {

using spmx_tile::kThreads;
using spmx_tile::kTile;

// stream position e -> (A row, X row): the live stream, or (when X is not
// finite) position e of the full depth, block e / bs, column e % bs
struct BcsrIndex {
  const int2* __restrict__ stream;
  const int32_t* __restrict__ block_cols;
  int bs;
  bool live;
  __device__ __forceinline__ int2 operator()(int64_t e) const {
    if (live) return stream[e];
    const int p = (int)(e / bs);
    const int k = (int)(e - (int64_t)p * bs);
    return make_int2((int)e, block_cols[p] * bs + k);
  }
};

__global__ void __launch_bounds__(kThreads)
    bcsr_spmm_kernel(const float* __restrict__ blocks_t,
                     const int32_t* __restrict__ block_cols,
                     const int32_t* __restrict__ block_offsets,
                     const int2* __restrict__ stream, int64_t stream_len,
                     const int32_t* __restrict__ stream_offsets,
                     const float* __restrict__ x_sum, int bs,
                     int tiles_m, int64_t f, const float* __restrict__ x,
                     float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t tiles_n = f / kTile;
  const int64_t bid = blockIdx.x;
  const int64_t per = tiles_m * tiles_n;
  const int64_t br = bid / per;
  const int tm = (int)((bid % per) / tiles_n);
  const int64_t n0 = (bid % per) % tiles_n * kTile;
  const bool live = isfinite(*x_sum);
  int64_t beg, end;
  if (live) {
    beg = spmx_tile::clamp_len(stream_offsets[br * tiles_m + tm], stream_len);
    end = spmx_tile::clamp_len(stream_offsets[br * tiles_m + tm + 1], stream_len);
  } else {
    beg = (int64_t)block_offsets[br] * bs;
    end = (int64_t)block_offsets[br + 1] * bs;
  }
  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;
    }
  }
  const int m0 = tm * kTile;
  // X's columns [n0, n0 + 64) all exist: the column offset goes into the
  // base pointer and the tile reads columns [0, 64) of rows of pitch f
  spmx_tile::block_product(blocks_t, bs, m0, bs, x + n0, f, 0, kTile, beg, end,
                           BcsrIndex{stream, block_cols, bs, live},
                           reinterpret_cast<float*>(smem_raw), acc);
  spmx_tile::store(y + (br * bs + m0) * f + n0, f, min(kTile, bs - m0), kTile,
                   acc);
}

}  // namespace

SPMX_API int spmx_bcsr_spmm(int device, const float* blocks_t,
                            const int32_t* block_cols,
                            const int32_t* block_offsets, const int32_t* stream,
                            int64_t stream_len, const int32_t* stream_offsets,
                            const float* x_sum, int64_t brows, int bs,
                            int64_t f, const float* x, float* y,
                            void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bs % 16 || bs < 16 || bs > 128 || f % 128 || brows < 0 || f < 0 ||
      stream_len < 0 || stream_len > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (brows == 0 || f == 0) return 0;
  const int tiles_m = (bs + kTile - 1) / kTile;
  const int64_t grid = brows * tiles_m * (f / kTile);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int smem = spmx_tile::smem_bytes<float>();
  err = cudaFuncSetAttribute(bcsr_spmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bcsr_spmm_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream_handle>>>(
      blocks_t, block_cols, block_offsets, (const int2*)stream, stream_len,
      stream_offsets, x_sum, bs, tiles_m, f, x, y);
  return (int)cudaGetLastError();
}
