// Stripe SpMV: multi-level destinations. A slab is 8 chunks of one stripe
// (L row blocks); per chunk c of slab s:
//   p[t]  = vals[c, t] * x[col_off[c]*128 + lane[c, t]]   (x past cols reads 0)
//   scan:   g[l, d] = incl[ends[s, l, c%8, d]]
//                     - (starts[s, l, c%8, d] < 0 ? 0 : incl[starts[s, l, c%8, d]])
//   select: g[l, d] = p[ends[s, l, c%8, d]]                (slot 0 is a zero)
//   y[(stripe_rb[s] + l)*128 + d] += sum over the slab's chunks of g[l, d]
//
// Replaces: sparse_matrix_tpu/ops/spmv.py, _make_stripe_kernel (called by
// _spmv_stripe_jit).
//
// Bound on the H100: device-memory bandwidth. A slot streams 4 bytes of
// value and 1 or 2 of lane; each (slot, level) 1 byte of ends and, in scan
// mode, 1 of starts; x windows (kw_g*128 floats per chunk) come mostly from
// L2, and y gets one atomic per (slab, level, lane) that holds a run.
//
// First version: one block of 256 threads per slab. Warp w stages chunk w's
// 128 products in shared memory with coalesced loads and, in scan mode,
// replaces them by their inclusive prefix sum (each thread scans four
// consecutive products, a warp-shuffle scan joins the 32 thread totals), in
// fp32 on the CUDA cores: the TPU kernel's triangular HIGHEST-precision
// matmul has no counterpart, so no TF32 rounding can enter. After one block
// barrier each thread owns (level, lane) pairs, sums that pair's value over
// the slab's 8 chunks, reading ends/starts coalesced along the lanes, and
// adds the sum to y with one atomicAdd. That replaces the TPU kernel's
// stacked (L, 128) tile added into a VMEM-resident y, whose sequential grid
// carried the sums. A pair with no run in any chunk (ends == starts == 0 in
// scan mode, ends == 0 in select mode: an exact zero either way) adds
// nothing. The caller zeroes y, which holds r128_padded*128 floats. Atomics
// make a row's sum vary in its last bits from run to run.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kChunks = 8;  // chunks per slab, one warp each
constexpr int kThreads = 32 * kChunks;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename LaneT, bool kScan>
__global__ void stripe_kernel(const float* __restrict__ vals,
                              const LaneT* __restrict__ lane,
                              const int8_t* __restrict__ ends,
                              const int8_t* __restrict__ starts,
                              const int32_t* __restrict__ stripe_rb,
                              const int32_t* __restrict__ col_off,
                              int levels, int64_t cols,
                              const float* __restrict__ x,
                              float* __restrict__ y) {
  __shared__ float prefix[kChunks][128];
  const int64_t s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t c = s * kChunks + warp;
  const int64_t base = c * 128;
  const int64_t window = (int64_t)__ldg(col_off + c) * 128;
  float* p = prefix[warp];

  for (int k = 0; k < 4; ++k) {
    const int i = t + 32 * k;
    const int64_t j = window + (int64_t)lane[base + i];
    const float xv = j < cols ? __ldg(x + j) : 0.0f;
    p[i] = vals[base + i] * xv;
  }
  if (kScan) {
    __syncwarp();
    // thread t owns products 4t .. 4t+3
    const float a0 = p[4 * t];
    const float a1 = a0 + p[4 * t + 1];
    const float a2 = a1 + p[4 * t + 2];
    const float a3 = a2 + p[4 * t + 3];
    float incl = a3;
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFullMask, incl, d);
      if (t >= d) incl += up;
    }
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (t == 0) excl = 0.0f;
    __syncwarp();
    p[4 * t] = excl + a0;
    p[4 * t + 1] = excl + a1;
    p[4 * t + 2] = excl + a2;
    p[4 * t + 3] = excl + a3;
  }
  __syncthreads();

  // (level, lane) pairs of this slab; ends/starts are (S, L, 8, 128)
  const int64_t rb0 = __ldg(stripe_rb + s);
  for (int q = threadIdx.x; q < levels * 128; q += kThreads) {
    const int l = q >> 7;
    const int d = q & 127;
    const int64_t at = ((s * levels + l) * kChunks) * 128 + d;
    float acc = 0.0f;
    bool any = false;
    for (int w = 0; w < kChunks; ++w) {
      const int e = ends[at + w * 128];
      if (kScan) {
        const int st = starts[at + w * 128];
        if (e == 0 && st == 0) continue;
        acc += prefix[w][e] - (st < 0 ? 0.0f : prefix[w][st]);
      } else {
        if (e == 0) continue;
        acc += prefix[w][e];
      }
      any = true;
    }
    if (any) atomicAdd(y + (rb0 + l) * 128 + d, acc);
  }
}

template <typename LaneT>
void launch(const float* vals, const void* lane, const int8_t* ends,
            const int8_t* starts, const int32_t* stripe_rb,
            const int32_t* col_off, int64_t num_slabs, int levels,
            int64_t cols, const float* x, float* y, cudaStream_t stream) {
  const LaneT* ln = (const LaneT*)lane;
  if (starts != nullptr) {
    stripe_kernel<LaneT, true><<<(unsigned)num_slabs, kThreads, 0, stream>>>(
        vals, ln, ends, starts, stripe_rb, col_off, levels, cols, x, y);
  } else {
    stripe_kernel<LaneT, false><<<(unsigned)num_slabs, kThreads, 0, stream>>>(
        vals, ln, ends, starts, stripe_rb, col_off, levels, cols, x, y);
  }
}

}  // namespace

SPMX_API int spmx_stripe(int device, const float* vals, const void* lane,
                         int lane_bytes, const int8_t* ends,
                         const int8_t* starts, const int32_t* stripe_rb,
                         const int32_t* col_off, int64_t num_slabs, int levels,
                         int64_t cols, const float* x, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_slabs == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lane_bytes == 1) {
    launch<int8_t>(vals, lane, ends, starts, stripe_rb, col_off, num_slabs,
                   levels, cols, x, y, s);
  } else {
    launch<int16_t>(vals, lane, ends, starts, stripe_rb, col_off, num_slabs,
                    levels, cols, x, y, s);
  }
  return (int)cudaGetLastError();
}
