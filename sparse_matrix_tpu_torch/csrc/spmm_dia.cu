// Streaming DIA SpMM in the packed multi-RHS layout: for K <= 16 right-hand
// sides held as x3 (x_lo + c128 + guard, K, 128) — x[j, k] at
// x3[x_lo + j/128, k, j%128] —
//   y3[y_lo + i/128, k, i%128] = sum_b data[b, i] * x[i + off_b, k]
// (x outside [0, cols) reads 0); every other y3 element, guard rows and the
// rows past `rows` in the last row block, is written 0.
//
// Replaces: sparse_matrix_tpu/ops/spmv_dia.py, _make_dia_spmm_kernel
// (called by _spmm_dia_stream_packed).
//
// Bound on the H100: device-memory bandwidth. The band planes are read once
// for all K columns (4 bytes per band slot in f32, 2 in bf16), x3 once and
// y3 written once (4*K bytes per row each); x3's neighbouring bands hit L2.
//
// First version: one thread per y3 row lane. A thread reads each band value
// once, widens bf16 to f32, and folds it into up to 16 accumulators, one per
// column, in the reference's band order. For a fixed (band, k) the 32
// threads of a warp read 32 neighbouring lanes of one (row block, k) plane,
// so every load is coalesced. The TPU kernel's (br, K, 128) window blocks,
// two-view lane shifts and guard rows existed to keep x slices static in
// VMEM; here the guard rows are only layout (the index is bounds-checked),
// which keeps the packed CG iterates' guard rows at zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kMaxK = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void dia_spmm_kernel(const T* __restrict__ data,
                                const int32_t* __restrict__ offsets, int nb,
                                int64_t rows, int64_t cols, int k,
                                const float* __restrict__ x3, int64_t x_lo,
                                float* __restrict__ y3, int64_t y_lo,
                                int64_t y_slots) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= y_slots) return;
  const int64_t yrow = t >> 7;
  const int lane = (int)(t & 127);
  const int64_t i = (yrow - y_lo) * 128 + lane;
  float acc[kMaxK];
#pragma unroll
  for (int c = 0; c < kMaxK; ++c) acc[c] = 0.0f;
  if (i >= 0 && i < rows) {
    for (int b = 0; b < nb; ++b) {
      const int64_t j = i + __ldg(offsets + b);
      if (j < 0 || j >= cols) continue;
      const float d = widen(data[(int64_t)b * rows + i]);
      const float* xp = x3 + ((x_lo + (j >> 7)) * k) * 128 + (j & 127);
#pragma unroll
      for (int c = 0; c < kMaxK; ++c) {
        if (c < k) acc[c] += d * __ldg(xp + c * 128);
      }
    }
  }
  float* yp = y3 + (yrow * k) * 128 + lane;
#pragma unroll
  for (int c = 0; c < kMaxK; ++c) {
    if (c < k) yp[c * 128] = acc[c];
  }
}

}  // namespace

SPMX_API int spmx_dia_spmm(int device, const void* data, int values_bf16,
                           const int32_t* offsets, int nb, int64_t rows,
                           int64_t cols, int k, const float* x3, int64_t x_lo,
                           float* y3, int64_t y_lo, int64_t y_rows_total,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const int64_t slots = y_rows_total * 128;
  if (slots == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (slots + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    dia_spmm_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)data, offsets, nb, rows, cols, k, x3, x_lo, y3,
        y_lo, slots);
  } else {
    dia_spmm_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)data, offsets, nb, rows, cols, k, x3, x_lo, y3, y_lo,
        slots);
  }
  return (int)cudaGetLastError();
}
