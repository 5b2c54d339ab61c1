// BELL (blocked-ELL layers) SpMM in the packed multi-RHS layout: for K <= 16
// right-hand sides held as x3 (>= c128, K, 128) — x[j, q] at
// x3[j/128, q, j%128] — and row block rb, lane l, layer k with bucket base
// d = ds[k] and pos = lane[k, rb, l] + bias:
//   y3[rb, q, l] = sum_k vals[k, rb, l] * x3[rb + d + (pos >> 7), q, pos & 127]
// (an x index outside [0, cols) reads 0). Every element of y3 (r128, K, 128)
// is written.
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_bell_spmm_kernel (called
// by _spmm_bell_jit).
//
// Bound on the H100: device-memory bandwidth. The slot planes (5 bytes per
// slot at span 128, 6 at span 256, one or two less with bf16 values) are
// read once for all K columns; x3 and y3 move 4*K bytes per row each; the
// x rows a layer reads lie within a few rows of the row block's own, so L2
// serves the K-fold gathers.
//
// First version: one thread per (row block, lane) of the r128 grid, as in
// spmv_bell.cu, with up to 16 f32 accumulators in registers. Per layer the
// thread reads the slot value (bf16 widened) and lane once, computes the
// x row from the layer base and the slot's 128-half, and folds the K
// gathered values into its accumulators in plan order; y3 is written once,
// with no atomics. The TPU kernel's static window slices, its per-(layer,
// half) gathers merged by the half masks (modes) and its BR row padding kept
// the gathers inside VMEM tiles; here a slot reads only the half it points
// at (padded slots hold 0 and point into a used half), so a half outside
// the layer's mode is never read, and x3 needs no guard rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kMaxK = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V, typename L>
__global__ void bell_spmm_kernel(const V* __restrict__ vals,
                                 const L* __restrict__ lane, int bias,
                                 const int32_t* __restrict__ ds,
                                 int num_layers, int64_t r128, int64_t cols,
                                 int k, const float* __restrict__ x3,
                                 float* __restrict__ y3) {
  const int64_t plane = r128 * 128;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int64_t rb = i >> 7;
  float acc[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) acc[q] = 0.0f;
  for (int layer = 0; layer < num_layers; ++layer) {
    const int64_t s = layer * plane + i;
    const int pos = (int)lane[s] + bias;
    const int64_t j = (rb + __ldg(ds + layer) + (pos >> 7)) * 128 + (pos & 127);
    if (j < 0 || j >= cols) continue;
    const float v = widen(vals[s]);
    const float* xp = x3 + ((j >> 7) * k) * 128 + (j & 127);
#pragma unroll
    for (int q = 0; q < kMaxK; ++q) {
      if (q < k) acc[q] += v * __ldg(xp + q * 128);
    }
  }
  float* yp = y3 + (rb * k) * 128 + (i & 127);
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) {
    if (q < k) yp[q * 128] = acc[q];
  }
}

template <typename V>
void launch(const void* vals, const void* lane, int lane_bytes, int bias,
            const int32_t* ds, int num_layers, int64_t r128, int64_t cols,
            int k, const float* x3, float* y3, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((r128 * 128 + threads - 1) / threads);
  if (lane_bytes == 1) {
    bell_spmm_kernel<V, int8_t><<<blocks, threads, 0, s>>>(
        (const V*)vals, (const int8_t*)lane, bias, ds, num_layers, r128, cols,
        k, x3, y3);
  } else {
    bell_spmm_kernel<V, int16_t><<<blocks, threads, 0, s>>>(
        (const V*)vals, (const int16_t*)lane, bias, ds, num_layers, r128, cols,
        k, x3, y3);
  }
}

}  // namespace

SPMX_API int spmx_bell_spmm(int device, const void* vals, int values_bf16,
                            const void* lane, int lane_bytes, int bias,
                            const int32_t* ds, int num_layers, int64_t r128,
                            int64_t cols, int k, const float* x3, float* y3,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lane_bytes != 1 && lane_bytes != 2) return (int)cudaErrorInvalidValue;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (r128 == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    launch<__nv_bfloat16>(vals, lane, lane_bytes, bias, ds, num_layers, r128,
                          cols, k, x3, y3, s);
  } else {
    launch<float>(vals, lane, lane_bytes, bias, ds, num_layers, r128, cols, k,
                  x3, y3, s);
  }
  return (int)cudaGetLastError();
}
