// BCSR SpMM: Y = A @ X for a block-sparse A of dense bs x bs blocks stored
// by block row (blocks (nnzb, bs, bs), block_cols, block_offsets):
//   Y[br*bs + i, n] = sum_{p in [off[br], off[br+1])} sum_j
//                     blocks[p, i, j] * X[block_cols[p]*bs + j, n]
// X (bcols*bs, F) and Y (brows*bs, F) row-major, F a multiple of 128.
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_bcsr_kernel (called by
// _spmm_bcsr_jit).
//
// Bound on the H100: the FP32 operations, 2*bs^2*F per stored block, at
// 67 TFLOP/s (the CUDA cores: the work is held to FP32, not TF32), against
// the blocks' 4*bs^2 bytes each plus X and Y once at 3.35 TB/s; at
// bs = 128 and F = 128 a block does 64 flops per byte it brings.
//
// First version: one thread block per (block row, 128-column tile of F). It
// walks the block row's stored blocks through block_offsets and accumulates
// each block's product with its X block row in registers (block_tile.h:
// shared-memory staged FP32 fma tile, 8 x 8 outputs a thread), so the sum
// order is fixed and needs no atomics; Y is written once, zeros for a block
// row with no block. The TPU kernel revisited the output block in a
// sequential grid, one MXU matmul per stored block. bs is a runtime
// argument, any multiple of 16 up to 128 (rows past bs of the 128-row tile
// idle).
#include <cuda_runtime.h>

#include "block_tile.h"
#include "spmx_cuda.h"

namespace {

using spmx_tile::kThreads;
using spmx_tile::kTile;

__global__ void __launch_bounds__(kThreads)
    bcsr_spmm_kernel(const float* __restrict__ blocks,
                     const int32_t* __restrict__ block_cols,
                     const int32_t* __restrict__ block_offsets, int bs,
                     int64_t f, const float* __restrict__ x,
                     float* __restrict__ y) {
  __shared__ spmx_tile::Smem sm;
  const int64_t br = blockIdx.x;
  const int64_t n0 = (int64_t)blockIdx.y * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int64_t bsq = (int64_t)bs * bs;
  const int p1 = block_offsets[br + 1];
  for (int p = block_offsets[br]; p < p1; ++p) {
    const float* xb = x + ((int64_t)block_cols[p] * bs) * f + n0;
    spmx_tile::mma_acc(blocks + p * bsq, bs, bs, xb, f, kTile, bs, sm, acc);
  }
  spmx_tile::store(y + (br * bs) * f + n0, f, bs, kTile, acc);
}

}  // namespace

SPMX_API int spmx_bcsr_spmm(int device, const float* blocks,
                            const int32_t* block_cols,
                            const int32_t* block_offsets, int64_t brows, int bs,
                            int64_t f, const float* x, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bs % spmx_tile::kStep || bs < spmx_tile::kStep || bs > kTile ||
      f % kTile || brows > 0x7fffffff || f / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (brows == 0 || f == 0) return 0;
  const dim3 grid((unsigned)brows, (unsigned)(f / kTile));
  bcsr_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, block_cols, block_offsets, bs, f, x, y);
  return (int)cudaGetLastError();
}
