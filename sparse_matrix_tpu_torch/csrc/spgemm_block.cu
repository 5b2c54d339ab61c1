// Block SpGEMM numeric phase: for every C block q,
//   C[q] = sum_{p in seg(q)} A_blocks[pair_a[p]] @ B_blocks[pair_b[p]]
// over bs x bs dense blocks (f32, or bf16), pairs sorted by C block, C f32,
// evaluated over the live-depth stream of ops/spgemm_block.py
// (block_depth_stream): a C block's pairs are one product whose depth is
// all the pairs' depth laid end to end, and the stream keeps, per segment
// (C block, 64 x 64 output tile) in pair then depth order, the rows
// (ia, ib) = (pair_a * bs + k, pair_b * bs + k) of the transposed A blocks
// and of the B blocks for the depth indices k that can contribute to the
// tile. k is dropped only when every term it adds to the tile is an exact
// zero (column k of A all zero on the tile's rows and row k of B all
// finite on its columns, or the reverse), so C is the dense block
// product's, inf and NaN included.
//
// Replaces: sparse_matrix_tpu/ops/spgemm_block.py, _make_block_kernel
// (called by _block_numeric_one).
//
// Bound on the H100: the operations the product needs, 2 per expanded
// scalar product, at 67 TFLOP/s, or the bytes of A, B and C once; both far
// below what any dense-block engine does. The work this kernel does is
// 2 * bs^2 per live stream row, on the FP64 tensor cores (67 TFLOP/s), and
// every live row gathers one A^T row and one B row (f32 or bf16).
//
// Design: one 128-thread block per segment, the tiles of one C block
// adjacent in the grid so that their gathers of the same rows meet in L2.
// Each walks its segment of the stream in order through
// block_tile.h (cp.async ring, FP64 MMA, f64 accumulators) and writes its
// tile once, rounded from f64: no atomics and a fixed sum order; a C block
// tile with an empty segment is written as zeros. bf16 blocks are staged as bf16
// (half the bytes) and widened in the fragment loads. The TPU kernel
// revisited the C block along a sequential grid of pairs, one full MXU
// matmul each, and split the pair stream into 64K-pair calls for its 1 MB
// SMEM; here each block reads its own stream offsets, so it is never split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_tile.h"
#include "spmx_cuda.h"

namespace {

using spmx_tile::kThreads;
using spmx_tile::kTile;

struct StreamIndex {
  const int2* __restrict__ rows;
  __device__ __forceinline__ int2 operator()(int64_t e) const { return rows[e]; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_spgemm_kernel(const T* __restrict__ a_blocks_t,
                        const T* __restrict__ b_blocks,
                        const int2* __restrict__ stream, int64_t stream_len,
                        const int32_t* __restrict__ offsets, int bs, int tiles,
                        float* __restrict__ c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bid = blockIdx.x;
  const int per = tiles * tiles;
  const int64_t q = bid / per;
  const int tm = (int)(bid % per) / tiles;
  const int tn = (int)(bid % per) % tiles;
  const int64_t beg = spmx_tile::clamp_len(offsets[bid], stream_len);
  const int64_t end = spmx_tile::clamp_len(offsets[bid + 1], stream_len);
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
  const int n0 = tn * kTile;
  spmx_tile::block_product(a_blocks_t, bs, m0, bs, b_blocks, bs, n0, bs, beg,
                           end, StreamIndex{stream},
                           reinterpret_cast<T*>(smem_raw), acc);
  const int64_t bsq = (int64_t)bs * bs;
  spmx_tile::store(c + q * bsq + (int64_t)m0 * bs + n0, bs, min(kTile, bs - m0),
                   min(kTile, bs - n0), acc);
}

template <typename T>
int launch(const void* a_blocks_t, const void* b_blocks, const int32_t* stream,
           int64_t stream_len, const int32_t* offsets, int64_t num_c, int bs,
           float* c, cudaStream_t s) {
  const int tiles = (bs + kTile - 1) / kTile;
  const int64_t grid = num_c * tiles * tiles;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int smem = spmx_tile::smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      block_spgemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  block_spgemm_kernel<T><<<(unsigned)grid, kThreads, smem, s>>>(
      (const T*)a_blocks_t, (const T*)b_blocks, (const int2*)stream, stream_len,
      offsets, bs, tiles, c);
  return (int)cudaGetLastError();
}

}  // namespace

SPMX_API int spmx_block_tile(void) { return kTile; }

SPMX_API int spmx_block_spgemm(int device, const void* a_blocks_t,
                               const void* b_blocks, int blocks_bf16,
                               const int32_t* stream, int64_t stream_len,
                               const int32_t* offsets, int64_t num_c, int bs,
                               float* c, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bs % 16 || bs < 16 || bs > 128 || stream_len < 0 ||
      stream_len > 0x7fffffff || num_c < 0)
    return (int)cudaErrorInvalidValue;
  if (num_c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream_handle;
  if (blocks_bf16)
    return launch<__nv_bfloat16>(a_blocks_t, b_blocks, stream, stream_len,
                                 offsets, num_c, bs, c, s);
  return launch<float>(a_blocks_t, b_blocks, stream, stream_len, offsets, num_c,
                       bs, c, s);
}
