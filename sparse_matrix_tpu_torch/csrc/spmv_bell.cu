// BELL (blocked-ELL layers) SpMV. For row block rb, lane l and layer k with
// bucket base d = ds[k] and pos = lane[k, rb, l] + bias:
//   y[rb*128 + l] = sum_k vals[k, rb, l] * x[(rb + d + (pos >> 7))*128 + (pos & 127)]
// (an x index outside [0, cols) reads 0).
//
// Replaces: sparse_matrix_tpu/ops/spmv_bell.py, _make_bell_kernel (called by
// _spmv_bell_jit).
//
// Bound on the H100: device-memory bandwidth, 5 bytes per slot at span 128
// (f32 value + int8 lane), 6 at span 256 (int16 lane), 3 or 4 with bf16
// value planes; the x rows each layer reads lie within a few 512-byte lines
// of the row block's own, so L2 serves them.
//
// First version: one thread per (row block, lane) walks the layers in plan
// order and accumulates in f32, so every layer plane is read by a warp as a
// coalesced line and y is written once with no atomics. The TPU kernel's
// static window slices, per-layer half masks (modes) and BR row padding
// existed to keep the gathers inside VMEM tiles; here the thread computes the
// x index from the layer base and the stored position directly, so the masks
// are not needed: padded slots hold zero values and point into a used half.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V, typename L>
__global__ void bell_kernel(const V* __restrict__ vals,
                            const L* __restrict__ lane, int bias,
                            const int32_t* __restrict__ ds, int num_layers,
                            int64_t r128, int64_t rows, int64_t cols,
                            const float* __restrict__ x,
                            float* __restrict__ y) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int64_t rb = i >> 7;
  const int64_t plane = r128 * 128;
  float acc = 0.0f;
  for (int k = 0; k < num_layers; ++k) {
    const int pos = (int)lane[k * plane + i] + bias;
    const int64_t j = (rb + __ldg(ds + k) + (pos >> 7)) * 128 + (pos & 127);
    const float xv = (j >= 0 && j < cols) ? __ldg(x + j) : 0.0f;
    acc += widen(vals[k * plane + i]) * xv;
  }
  y[i] = acc;
}

template <typename V>
void launch(const void* vals, const void* lane, int lane_bytes, int bias,
            const int32_t* ds, int num_layers, int64_t r128, int64_t rows,
            int64_t cols, const float* x, float* y, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  if (lane_bytes == 1) {
    bell_kernel<V, int8_t><<<blocks, threads, 0, s>>>(
        (const V*)vals, (const int8_t*)lane, bias, ds, num_layers, r128, rows,
        cols, x, y);
  } else {
    bell_kernel<V, int16_t><<<blocks, threads, 0, s>>>(
        (const V*)vals, (const int16_t*)lane, bias, ds, num_layers, r128,
        rows, cols, x, y);
  }
}

}  // namespace

SPMX_API int spmx_bell(int device, const void* vals, int values_bf16,
                       const void* lane, int lane_bytes, int bias,
                       const int32_t* ds, int num_layers, int64_t r128,
                       int64_t rows, int64_t cols, const float* x, float* y,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lane_bytes != 1 && lane_bytes != 2) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    launch<__nv_bfloat16>(vals, lane, lane_bytes, bias, ds, num_layers, r128,
                          rows, cols, x, y, s);
  } else {
    launch<float>(vals, lane, lane_bytes, bias, ds, num_layers, r128, rows,
                  cols, x, y, s);
  }
  return (int)cudaGetLastError();
}
