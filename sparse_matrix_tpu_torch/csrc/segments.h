// One owner for each row's sum: the segment scheme of the aligned
// (spmv_aligned.cu), LanePack (spmv_lanepack.cu) and stripe
// (spmv_stripe.cu) SpMV kernels.
//
// The host (ops/spmv.py: chunk_segments, stripe_segments) cuts a plan's
// work into segments: runs of consecutive chunks of one row block (aligned,
// LanePack), or of consecutive slabs of one stripe (stripe), in plan order,
// sorted by row block or stripe; one with no work gets one empty segment,
// so every row block or stripe has at least one. One owner (a warp for the
// aligned and LanePack kernels, a thread block for the stripe kernel) sums
// a segment in registers in plan order, each thread V consecutive rows.
// The owner then
//   * stores (or, in add mode, adds) its sums into y when the segment is
//     its row block's or stripe's only one;
//   * else writes them to its scratch slot, and the last of the segments
//     to finish (an atomic ticket each) adds the slots in segment order and
//     writes y, then resets the ticket to 0 for the next launch.
// Each row of y therefore has one writer, nothing is added with atomics,
// and a call gives the same bits every time. Store mode writes every row
// of y[:rows], so y needs no zeroing. The ticket array and the scratch
// slots belong to the plan's device arrays: one launch at a time may use
// them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmx_cuda.h"

namespace spmx {

constexpr unsigned kFullMask = 0xffffffffu;

struct Segment {
  int rb, first, count, slot;  // rb: row block or stripe; slot < 0: its only segment
};

__device__ __forceinline__ Segment load_segment(const int32_t* segments, int64_t s) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(segments) + s);
  return Segment{v.x, v.y, v.z, v.w};
}

// V consecutive floats at p (V-float aligned): stored, loaded, or added
// from L2
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (V == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void add_cg(float (&acc)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 w = __ldcg(reinterpret_cast<const float4*>(p));
    acc[0] += w.x;
    acc[1] += w.y;
    acc[2] += w.z;
    acc[3] += w.w;
  } else if constexpr (V == 2) {
    const float2 w = __ldcg(reinterpret_cast<const float2*>(p));
    acc[0] += w.x;
    acc[1] += w.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += __ldcg(p + k);
  }
}

// rows r0 .. r0+V-1 (r0 a multiple of V): y = v (store) or y = y + v (add),
// rows >= `rows` untouched; y is 16-byte aligned
template <int V>
__device__ __forceinline__ void write_rows(float* y, int64_t rows, int64_t r0, float (&v)[V],
                                           int add) {
  if (r0 + V - 1 < rows) {
    if (add) {
      float w[V];
      load_v<V>(y + r0, w);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = w[k] + v[k];
    }
    store_v<V>(y + r0, v);
    return;
  }
  for (int k = 0; k < V && r0 + k < rows; ++k) y[r0 + k] = add ? y[r0 + k] + v[k] : v[k];
}

// Owners. sync_from0(f) synchronises the owner's threads, runs f() on its
// first thread and hands the result to every thread.
struct WarpOwner {
  int t;  // lane
  __device__ __forceinline__ bool first() const { return t == 0; }
  template <class F>
  __device__ __forceinline__ int sync_from0(F f) const {
    __syncwarp();
    int v = 0;
    if (t == 0) v = f();
    return __shfl_sync(kFullMask, v, 0);
  }
};

struct BlockOwner {
  int* cell;  // one int of shared memory
  __device__ __forceinline__ bool first() const { return threadIdx.x == 0; }
  template <class F>
  __device__ __forceinline__ int sync_from0(F f) const {
    __syncthreads();
    if (threadIdx.x == 0) *cell = f();
    __syncthreads();
    return *cell;
  }
};

// The end of a segment that shares its row block or stripe with others:
// `acc` holds this thread's sums of the floats [off, off + V) of a slot of
// `width` (threads with !active hold none). Every owner writes its slot
// and takes a ticket; the last of the `nseg` owners replaces acc by the
// sum of slots base .. base + nseg - 1 in segment order, resets the ticket
// and returns true, the others return false. Every thread of the owner
// calls this.
template <int V, class Owner>
__device__ __forceinline__ bool last_of_segments(const Owner& o, float* scratch, int64_t width,
                                                 int64_t slot, int64_t base, int nseg,
                                                 int64_t off, bool active, float (&acc)[V],
                                                 int32_t* ticket) {
  if (active) store_v<V>(scratch + slot * width + off, acc);
  __threadfence();
  const int got = o.sync_from0([&] { return atomicAdd(ticket, 1); });
  if (got != nseg - 1) return false;
  __threadfence();
  if (active) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int k = 0; k < nseg; ++k) add_cg<V>(acc, scratch + (base + k) * width + off);
  }
  if (o.first()) *ticket = 0;
  return true;
}

// the warp's four sums a thread for segment `s` of an aligned or LanePack
// plan (thread t: rows 4t .. 4t+3 of the row block); every lane of the
// warp calls this
__device__ __forceinline__ void finish_segment(const SpmxSegPlan& p, int64_t s,
                                               const Segment& seg, int t, float4 sums,
                                               float* y, int add) {
  float acc[4] = {sums.x, sums.y, sums.z, sums.w};
  if (seg.slot >= 0) {
    const int first = __ldg(p.rb_seg + seg.rb);
    const int nseg = __ldg(p.rb_seg + seg.rb + 1) - first;
    if (!last_of_segments<4>(WarpOwner{t}, p.scratch, 128, seg.slot, seg.slot - (s - first),
                             nseg, 4 * t, true, acc, p.tickets + seg.rb))
      return;
  } else if (add && seg.count == 0) {
    return;
  }
  write_rows<4>(y, p.rows, (int64_t)seg.rb * 128 + 4 * t, acc, add);
}

}  // namespace spmx
