// LanePack segmented-reduce SpMV. Per 128-slot chunk c of row block rb:
//   p[s]   = vals[c, s] * x[col_off[c]*128 + lane[c, s]]   (KW*128 window)
//   incl   = inclusive prefix sum of p over the chunk
//   y[rb*128 + l] gets incl[ends[c, l]] - (starts[c, l] < 0 ? 0 : incl[starts[c, l]])
//
// Replaces: sparse_matrix_tpu/ops/spmv.py, _make_lanepack_kernel (called by
// _spmv_lanepack_jit).
//
// Bound on the H100: device-memory bandwidth. The plan streams 8 bytes a
// slot (f32 value, int16 lane, int8 end, int8 start) and 4 bytes of
// col_off a chunk; the KW*128 x window of a chunk is served by L1 and L2.
//
// Design: one warp owns one segment of its row block's chunks (segments.h).
// It streams them through a ring of kRing stages in shared memory, 1024
// bytes a chunk (values, lanes, ends, starts), filled by 16-byte cp.async
// copies, so kRing - 1 chunks are in flight while it computes and no
// register holds them; lane t of the warp loads the window base of the
// segment's chunk t once (a segment holds at most 32 chunks). The x values
// of the next chunk are gathered through L1 before this chunk's arithmetic.
// Thread t multiplies slots 4t .. 4t+3; the products stay in registers: a
// scan inside the thread and a warp-shuffle scan of the thread totals give
// the inclusive prefix sum in fp32 on the CUDA cores (the TPU kernel's
// triangular matmul at HIGHEST precision; no tensor core, so no TF32
// rounding can enter). The prefix sums go through 512 bytes of shared
// memory, from which thread t takes the run differences of lanes 4t ..
// 4t+3 and adds them to four f32 sums in registers, in plan order. A lane
// with no run in the chunk (ends == starts == 0) takes incl[0] - incl[0],
// as the plain version does: an exact zero for finite x. The sums reach y
// through the segment's single writer (store mode for spmv_lanepack, add
// mode on the rows the aligned or BELL kernel wrote for a spill): no
// atomics on y, no zeroing of y, the same bits on every call. Three
// stages (28 KB a block of eight warps, with the prefix sums) leave room
// for L1 to hold the x windows; on the H100 deeper rings ran slower
// (PERF.md §6). The TPU's two-target (rb_a/rb_b/split) accumulation is
// not carried over.
#include <cuda_runtime.h>

#include "block_tile.h"
#include "lanepack_stage.h"
#include "segments.h"
#include "spmx_cuda.h"

namespace {

constexpr int kRing = 3;
constexpr int kWarps = 8;  // segments a thread block

using Stage = spmx::LanePackStage;

__device__ __forceinline__ float4 gather(const Stage& st, int t, int window,
                                         const float* __restrict__ x, int64_t cols) {
  int ln[4];
  spmx::stage_lanes(st, t, ln);
  const int64_t w = (int64_t)window * 128;
  const int64_t j0 = w + ln[0], j1 = w + ln[1], j2 = w + ln[2], j3 = w + ln[3];
  return make_float4(j0 < cols ? __ldg(x + j0) : 0.f, j1 < cols ? __ldg(x + j1) : 0.f,
                     j2 < cols ? __ldg(x + j2) : 0.f, j3 < cols ? __ldg(x + j3) : 0.f);
}

__global__ void __launch_bounds__(32 * kWarps, 4)
lanepack_kernel(const SpmxSegPlan p, const float* __restrict__ x, float* __restrict__ y,
                int add) {
  __shared__ Stage ring[kWarps][kRing];
  __shared__ float4 prefix[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * kWarps + warp;
  if (s >= p.num_segments) return;  // whole warp leaves; only warp syncs below
  const spmx::Segment seg = spmx::load_segment(p.segments, s);
  const int n = seg.count;
  const int window = t < n ? __ldg(p.col_off + seg.first + t) : 0;
  Stage* st = ring[warp];
  const float* pre = reinterpret_cast<const float*>(prefix[warp]);
  const spmx::LanePackCopier copy(p, t);

  auto issue = [&](int i) {  // chunk i into stage i % kRing; one group a call
    if (i < n) copy(st[i % kRing], (int64_t)seg.first + i);
    spmx_tile::commit();
  };

  for (int i = 0; i < kRing - 1; ++i) issue(i);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xc = acc;
  if (n > 0) {
    spmx_tile::wait_pending<kRing - 2>();  // chunk 0 landed
    __syncwarp();
    xc = gather(st[0], t, __shfl_sync(spmx::kFullMask, window, 0), x, p.cols);
  }
  for (int i = 0; i < n; ++i) {
    issue(i + kRing - 1);
    spmx_tile::wait_pending<kRing - 2>();  // chunks <= i + 1 landed
    __syncwarp();
    float4 xn = xc;
    if (i + 1 < n)
      xn = gather(st[(i + 1) % kRing], t, __shfl_sync(spmx::kFullMask, window, i + 1), x,
                  p.cols);
    const Stage& cur = st[i % kRing];
    const float4 v = cur.vals[t];
    const float a0 = v.x * xc.x;
    const float a1 = a0 + v.y * xc.y;
    const float a2 = a1 + v.z * xc.z;
    const float a3 = a2 + v.w * xc.w;
    float incl = a3;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(spmx::kFullMask, incl, d);
      if (t >= d) incl += up;
    }
    float excl = __shfl_up_sync(spmx::kFullMask, incl, 1);
    if (t == 0) excl = 0.f;
    prefix[warp][t] = make_float4(excl + a0, excl + a1, excl + a2, excl + a3);
    __syncwarp();
    const char4 e = cur.ends[t], b = cur.starts[t];
    acc.x += pre[e.x] - (b.x < 0 ? 0.f : pre[b.x]);
    acc.y += pre[e.y] - (b.y < 0 ? 0.f : pre[b.y]);
    acc.z += pre[e.z] - (b.z < 0 ? 0.f : pre[b.z]);
    acc.w += pre[e.w] - (b.w < 0 ? 0.f : pre[b.w]);
    xc = xn;
    __syncwarp();  // prefix and stage i % kRing are rewritten next iteration
  }
  spmx::finish_segment(p, s, seg, t, acc, y, add);
}

}  // namespace

SPMX_API int spmx_lanepack(const SpmxSegPlan* plan, const float* x, float* y,
                           int add, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->num_segments == 0) return 0;
  const int64_t blocks = (plan->num_segments + kWarps - 1) / kWarps;
  lanepack_kernel<<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      *plan, x, y, add);
  return (int)cudaGetLastError();
}
