// BELL (blocked-ELL layers) SpMM: Y = A @ X for 1 <= K <= 16 columns, X
// (cols, K) and Y (rows, K) row-major, as the caller holds them. For row i
// = rb*128 + l and layer k with bucket base d = ds[k] and pos = lane[k, rb,
// l] + bias, j = (rb + d + (pos >> 7))*128 + (pos & 127):
//   Y[i, q] = sum_k vals[k, rb, l] * X[j, q]   (j outside [0, cols) adds nothing)
// summed in layer order, each product and sum rounded on its own (no
// contraction), which is what the plain version computes. Every row of Y
// is written.
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_bell_spmm_kernel (called
// by _spmm_bell_jit).
//
// Bound on the H100: device-memory bandwidth. The slot planes (5 bytes per
// slot at span 128, 6 at span 256, one or two less with bf16 values) are
// read once for all K columns; X and Y move 4*K bytes per row each; the X
// rows a layer reads lie within a few row blocks of the row's own, so L2
// serves the gathers of neighbouring rows.
//
// Design: one thread a row, as in the BELL SpMV kernel (spmv_bell.cu), with
// K f32 sums in registers. Per layer the thread reads its slot's value
// (bf16 widened) and lane once and the K values of X's row j with 16-byte
// loads (8-byte or 4-byte ones where K or the pointers allow no wider), and
// writes its K sums as one contiguous run of Y's row, so a warp writes 32
// neighbouring rows (staging a block's rows of Y in shared memory first,
// for whole runs a warp, ran up to 5 % slower on the H100: PERF.md section
// 6). Products and sums go through __fmul_rn/__fadd_rn, so that no
// multiply-add is contracted. The TPU kernel's packed (rows, K, 128)
// layout, with its x3 relayout before and y3 relayout after every call, is
// gone: its static window slices, half masks and BR row padding kept the
// gathers inside VMEM tiles; here a slot reads only the half it points at
// (padded slots hold 0 and point into a used half). A spill sub-plan adds
// onto Y with the LanePack SpMM kernel in add mode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (VEC == 2) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <typename V, typename L, int VEC>
__global__ void __launch_bounds__(kThreads)
bell_spmm_kernel(const SpmxBellPlan p, const float* __restrict__ x, float* __restrict__ y,
                 int k) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.rows) return;
  const int64_t rb = i >> 7;
  const int64_t plane = p.r128 * 128;
  const V* vals = reinterpret_cast<const V*>(p.vals) + i;
  const L* lane = reinterpret_cast<const L*>(p.lane) + i;
  float acc[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) acc[q] = 0.f;
  for (int layer = 0; layer < p.num_layers; ++layer) {
    const int pos = (int)lane[layer * plane] + p.bias;
    const int64_t j = (rb + __ldg(p.ds + layer) + (pos >> 7)) * 128 + (pos & 127);
    if (j < 0 || j >= p.cols) continue;
    const float v = widen(vals[layer * plane]);
    const float* xp = x + j * k;
#pragma unroll
    for (int q = 0; q < kMaxK; q += VEC) {
      if (q >= k) break;
      float xv[VEC];
      load_vec<VEC>(xp + q, xv);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[q + u] = __fadd_rn(acc[q + u], __fmul_rn(v, xv[u]));
    }
  }
  float* yp = y + i * k;
#pragma unroll
  for (int q = 0; q < kMaxK; q += VEC) {
    if (q >= k) break;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(yp + q) = make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(yp + q) = make_float2(acc[q], acc[q + 1]);
    } else {
      yp[q] = acc[q];
    }
  }
}

template <typename V, int VEC>
cudaError_t launch(const SpmxBellPlan& p, const float* x, float* y, int k, cudaStream_t s) {
  const unsigned blocks = (unsigned)((p.rows + kThreads - 1) / kThreads);
  if (p.lane_bytes == 1)
    bell_spmm_kernel<V, int8_t, VEC><<<blocks, kThreads, 0, s>>>(p, x, y, k);
  else
    bell_spmm_kernel<V, int16_t, VEC><<<blocks, kThreads, 0, s>>>(p, x, y, k);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_vec(const SpmxBellPlan& p, const float* x, float* y, int k, cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (k % 4 == 0 && a % 16 == 0) return launch<V, 4>(p, x, y, k, s);
  if (k % 2 == 0 && a % 8 == 0) return launch<V, 2>(p, x, y, k, s);
  return launch<V, 1>(p, x, y, k, s);
}

}  // namespace

SPMX_API int spmx_bell_spmm(const SpmxBellPlan* plan, const float* x, float* y, int k,
                            void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->lane_bytes != 1 && plan->lane_bytes != 2) return (int)cudaErrorInvalidValue;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (plan->rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  err = plan->values_bf16 ? launch_vec<__nv_bfloat16>(*plan, x, y, k, s)
                          : launch_vec<float>(*plan, x, y, k, s);
  return (int)err;
}
