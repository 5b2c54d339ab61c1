// The dense block product shared by the BCSR SpMM (spmm_bcsr.cu) and the
// block SpGEMM (spgemm_block.cu) kernels: a 256-thread block accumulates one
// 128 x 128 f32 output tile, acc += A @ B, with A (m_valid x depth) and B
// (depth x n_valid) row-major in device memory, f32 or bf16.
//
// A plain shared-memory SGEMM tile on the CUDA cores: depth steps of 16 are
// staged in shared memory (A transposed to depth-major, bf16 widened to f32
// at the load), and each thread holds an 8 x 8 block of the output in
// registers, rows ty + 16*i and columns tx + 16*j (ty, tx < 16), so that a
// warp's shared-memory reads are broadcasts or 16 neighbouring words and its
// stores to the output are coalesced. Every product and sum is an FP32 fma:
// no tensor core and no TF32 (ROADMAP.md C5). wgmma and TMA are later work.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace spmx_tile {

constexpr int kTile = 128;     // output tile edge; block sizes are <= kTile
constexpr int kStep = 16;      // depth staged per step; depth % kStep == 0
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Smem {
  float a[kStep][kTile + 4];  // A tile, depth-major; padded against conflicts
  float b[kStep][kTile];
};

// acc[i][j] += sum_d A[ty + 16 i, d] * B[d, tx + 16 j] over d < depth; rows
// of A at or past m_valid and columns of B at or past n_valid read 0.
template <typename T>
__device__ __forceinline__ void mma_acc(const T* __restrict__ A, int64_t lda,
                                        int m_valid, const T* __restrict__ B,
                                        int64_t ldb, int n_valid, int depth,
                                        Smem& sm, float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  for (int d0 = 0; d0 < depth; d0 += kStep) {
    // A: 128 rows x 16 depth, 16 neighbouring threads on one row
#pragma unroll
    for (int p = 0; p < (kTile * kStep) / kThreads; ++p) {
      const int e = tid + kThreads * p;
      const int r = e >> 4;
      const int d = e & 15;
      sm.a[d][r] = r < m_valid ? widen(A[r * lda + d0 + d]) : 0.0f;
    }
    // B: 16 depth x 128 columns, a warp on 32 neighbouring columns
#pragma unroll
    for (int p = 0; p < (kTile * kStep) / kThreads; ++p) {
      const int e = tid + kThreads * p;
      const int d = e >> 7;
      const int cc = e & 127;
      sm.b[d][cc] = cc < n_valid ? widen(B[(d0 + d) * ldb + cc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kStep; ++d) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.a[d][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sm.b[d][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// out[(ty + 16 i) * ldo + tx + 16 j] = acc[i][j] for rows < m_valid and
// columns < n_valid
__device__ __forceinline__ void store(float* __restrict__ out, int64_t ldo,
                                      int m_valid, int n_valid,
                                      const float (&acc)[8][8]) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= m_valid) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = tx + 16 * j;
      if (cc < n_valid) out[r * ldo + cc] = acc[i][j];
    }
  }
}

}  // namespace spmx_tile
