// Block SpGEMM numeric phase: for every C block q,
//   C[q] = sum_{p in [seg[q], seg[q+1])} A_blocks[pair_a[p]] @ B_blocks[pair_b[p]]
// over bs x bs dense blocks (f32, or bf16 widened to f32), pairs sorted by C
// block (seg: their per-block offsets), C f32.
//
// Replaces: sparse_matrix_tpu/ops/spgemm_block.py, _make_block_kernel
// (called by _block_numeric_one).
//
// Bound on the H100: the operations, 2*bs^3 per pair: at 67 TFLOP/s for f32
// blocks (held to FP32, not TF32) and at the 989 TFLOP/s of the bf16 tensor
// cores for bf16 blocks (a bf16 x bf16 product is exact in f32, so a
// tensor-core design could do the same work), against each pair's two
// blocks and C once at 3.35 TB/s.
//
// First version: one thread block per C block. It walks the C block's pair
// segment in pair order and accumulates every product in registers
// (block_tile.h: shared-memory staged FP32 fma tile, 8 x 8 outputs a
// thread; bf16 blocks are widened at the shared-memory load), then writes C
// once, so no atomics and a fixed sum order. The TPU kernel revisited the C
// block along a sequential grid of pairs, one MXU matmul each, and split the
// pair stream into 64K-pair calls for its 1 MB SMEM; here each block reads
// its own pair indices from device memory, so the stream is never split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_tile.h"
#include "spmx_cuda.h"

namespace {

using spmx_tile::kThreads;
using spmx_tile::kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_spgemm_kernel(const T* __restrict__ a_blocks,
                        const T* __restrict__ b_blocks,
                        const int32_t* __restrict__ pair_a,
                        const int32_t* __restrict__ pair_b,
                        const int32_t* __restrict__ seg, int bs,
                        float* __restrict__ c) {
  __shared__ spmx_tile::Smem sm;
  const int64_t q = blockIdx.x;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int64_t bsq = (int64_t)bs * bs;
  const int p1 = seg[q + 1];
  for (int p = seg[q]; p < p1; ++p) {
    spmx_tile::mma_acc(a_blocks + pair_a[p] * bsq, bs, bs,
                       b_blocks + pair_b[p] * bsq, bs, bs, bs, sm, acc);
  }
  spmx_tile::store(c + q * bsq, bs, bs, bs, acc);
}

}  // namespace

SPMX_API int spmx_block_spgemm(int device, const void* a_blocks,
                               const void* b_blocks, int blocks_bf16,
                               const int32_t* pair_a, const int32_t* pair_b,
                               const int32_t* seg, int64_t num_c, int bs,
                               float* c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bs % spmx_tile::kStep || bs < spmx_tile::kStep || bs > kTile ||
      num_c > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (num_c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks_bf16) {
    block_spgemm_kernel<__nv_bfloat16><<<(unsigned)num_c, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a_blocks, (const __nv_bfloat16*)b_blocks, pair_a,
        pair_b, seg, bs, c);
  } else {
    block_spgemm_kernel<float><<<(unsigned)num_c, kThreads, 0, s>>>(
        (const float*)a_blocks, (const float*)b_blocks, pair_a, pair_b, seg, bs,
        c);
  }
  return (int)cudaGetLastError();
}
