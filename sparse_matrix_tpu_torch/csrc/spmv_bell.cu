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
// Design: one thread per (row block, lane) walks the layers in plan order
// and accumulates in f32, so every layer plane is read by a warp as a
// coalesced line and y is written once with no atomics (BELL only writes y;
// a spill sub-plan adds into it with its own kernel). The TPU kernel's
// static window slices, per-layer half masks (modes) and BR row padding
// existed to keep the gathers inside VMEM tiles; here the thread computes the
// x index from the layer base and the stored position directly, so the masks
// are not needed: padded slots hold zero values and point into a used half.
// Four rows a thread with 16-byte plane loads, and one row a thread with four
// layers unrolled, both with streaming loads (__ldcs), ran 1.1-1.25x slower
// on the H100 on Poisson and femlike plans (5 and 9 layers) and 1.1x faster
// only on a 48-layer plan (PERF.md section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
bell_kernel(const SpmxBellPlan p, const float* __restrict__ x, float* __restrict__ y) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.rows) return;
  const int64_t rb = i >> 7;
  const int64_t plane = p.r128 * 128;
  const V* vals = reinterpret_cast<const V*>(p.vals) + i;
  const L* lane = reinterpret_cast<const L*>(p.lane) + i;
  float acc = 0.0f;
  for (int k = 0; k < p.num_layers; ++k) {
    const int pos = (int)lane[k * plane] + p.bias;
    const int64_t j = (rb + __ldg(p.ds + k) + (pos >> 7)) * 128 + (pos & 127);
    const float xv = (j >= 0 && j < p.cols) ? __ldg(x + j) : 0.0f;
    acc += widen(vals[k * plane]) * xv;
  }
  y[i] = acc;
}

template <typename V>
cudaError_t launch(const SpmxBellPlan& p, const float* x, float* y, cudaStream_t s) {
  const unsigned blocks = (unsigned)((p.rows + kThreads - 1) / kThreads);
  if (p.lane_bytes == 1)
    bell_kernel<V, int8_t><<<blocks, kThreads, 0, s>>>(p, x, y);
  else
    bell_kernel<V, int16_t><<<blocks, kThreads, 0, s>>>(p, x, y);
  return cudaGetLastError();
}

}  // namespace

SPMX_API int spmx_bell(const SpmxBellPlan* plan, const float* x, float* y, int add,
                       void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->lane_bytes != 1 && plan->lane_bytes != 2) return (int)cudaErrorInvalidValue;
  if (add) return (int)cudaErrorNotSupported;  // BELL only writes y
  if (plan->rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  err = plan->values_bf16 ? launch<__nv_bfloat16>(*plan, x, y, s)
                          : launch<float>(*plan, x, y, s);
  return (int)err;
}
