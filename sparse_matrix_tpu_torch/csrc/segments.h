// Row-block ownership for the aligned (spmv_aligned.cu) and LanePack
// (spmv_lanepack.cu) SpMV kernels.
//
// The host (ops/spmv.py::chunk_segments) cuts a plan's chunks into
// segments: runs of at most SEGMENT_CHUNKS consecutive chunks of one row
// block, in plan order, sorted by row block; a row block with no chunk
// gets one empty segment, so every row block has at least one. One warp
// owns one segment, thread t the four rows 4t .. 4t+3 of its row block,
// and sums its chunks in registers in plan order. The warp then
//   * stores (or, in add mode, adds) its four sums into y when the
//     segment is its row block's only one;
//   * else writes them to its scratch slot, and the last of the row
//     block's segments to finish (an atomic ticket per row block) adds
//     the slots in segment order and writes y, then resets the ticket to 0
//     for the next launch.
// Each row of y therefore has one writer, nothing is added with atomics,
// and a call gives the same bits every time. Store mode writes every row
// of y[:rows] (an empty or masked row block gets 0), so y needs no
// zeroing. The ticket array and the scratch slots belong to the plan's
// device arrays: one launch at a time may use them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmx_cuda.h"

namespace spmx {

constexpr unsigned kFullMask = 0xffffffffu;

struct Segment {
  int rb, first, count, slot;  // slot < 0: the row block's only segment
};

__device__ __forceinline__ Segment load_segment(const int32_t* segments, int64_t s) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(segments) + s);
  return Segment{v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// rows 4t .. 4t+3 of row block rb: y = v (store) or y = y + v (add),
// rows >= `rows` untouched; y is 16-byte aligned
__device__ __forceinline__ void write_rows(float* y, int64_t rows, int rb, int t,
                                           float4 v, int add) {
  const int64_t r0 = (int64_t)rb * 128 + 4 * t;
  if (r0 + 3 < rows) {
    float4* p = reinterpret_cast<float4*>(y + r0);
    if (add) v = add4(*p, v);
    *p = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
  for (int k = 0; k < 4 && r0 + k < rows; ++k) y[r0 + k] = add ? y[r0 + k] + w[k] : w[k];
}

// the warp's four sums a thread for segment `s`; every lane of the warp
// calls this
__device__ __forceinline__ void finish_segment(const SpmxSegPlan& p, int64_t s,
                                               const Segment& seg, int t, float4 acc,
                                               float* y, int add) {
  if (seg.slot < 0) {
    if (add && seg.count == 0) return;
    write_rows(y, p.rows, seg.rb, t, acc, add);
    return;
  }
  reinterpret_cast<float4*>(p.scratch)[(int64_t)seg.slot * 32 + t] = acc;
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (t == 0) ticket = atomicAdd(p.tickets + seg.rb, 1);
  ticket = __shfl_sync(kFullMask, ticket, 0);
  const int first = __ldg(p.rb_seg + seg.rb);
  const int nseg = __ldg(p.rb_seg + seg.rb + 1) - first;
  if (ticket != nseg - 1) return;
  __threadfence();
  const int64_t base = (int64_t)seg.slot - (s - first);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < nseg; ++k)
    sum = add4(sum, __ldcg(reinterpret_cast<const float4*>(p.scratch) + (base + k) * 32 + t));
  write_rows(y, p.rows, seg.rb, t, sum, add);
  if (t == 0) p.tickets[seg.rb] = 0;
}

}  // namespace spmx
