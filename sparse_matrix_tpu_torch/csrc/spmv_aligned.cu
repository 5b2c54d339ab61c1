// Aligned SpMV: slot lane == destination row % 128, so every product is
// already a per-row contribution:
//   y[rb*128 + l] = sum over the row block's chunks c of
//                   vals[c, l] * x[col_off[c]*128 + lane[c, l]].
//
// Replaces: sparse_matrix_tpu/ops/spmv.py, _make_aligned_kernel (called by
// _spmv_aligned_jit).
//
// Bound on the H100: device-memory bandwidth. The plan streams 5 bytes a
// slot (f32 value, int8 lane) and 4 bytes of col_off a chunk; the x window
// of a chunk is one 512-byte line that L1 and L2 serve to its neighbours.
//
// Design: one warp owns one segment of its row block's chunks (segments.h)
// and thread t the rows 4t .. 4t+3. The warp streams its chunks through a
// ring of kRing stages in shared memory, 640 bytes a chunk (values, lanes),
// filled by 16-byte cp.async copies, so kRing - 1 chunks are in flight
// while it computes and no register holds them. Lane t of the warp loads
// the window base of the segment's chunk t once (a segment holds at most
// 32 chunks). The x values of the next chunk are gathered through L1
// before this chunk's four multiply-adds, so their latency overlaps too.
// The four f32 sums a thread stay in registers, added in plan order, and
// reach y through the segment's single writer: no atomics on y, no zeroing
// of y, the same bits on every call. Three stages (15 KB a block of eight
// warps) and at most 32 registers a thread let 64 warps share an SM, so
// Poisson 1024^2's 8192 segments run in one wave; on the H100 deeper
// rings ran slower (PERF.md §6). The TPU kernel's two-target slab
// split (rb_a/rb_b/split) and its alternating y buffers served a
// sequential grid and are not carried over.
#include <cuda_runtime.h>

#include "block_tile.h"
#include "segments.h"
#include "spmx_cuda.h"

namespace {

constexpr int kRing = 3;
constexpr int kWarps = 8;  // segments a thread block

struct Stage {
  float4 vals[32];  // slots 4t .. 4t+3 at [t]
  char4 lane[32];
};

__device__ __forceinline__ float4 gather(const Stage& st, int t, int window,
                                         const float* __restrict__ x, int64_t cols) {
  const char4 l = st.lane[t];
  const int64_t w = (int64_t)window * 128;  // lanes are column % 128, in [0, 128)
  const int64_t j0 = w + l.x, j1 = w + l.y, j2 = w + l.z, j3 = w + l.w;
  return make_float4(j0 < cols ? __ldg(x + j0) : 0.f, j1 < cols ? __ldg(x + j1) : 0.f,
                     j2 < cols ? __ldg(x + j2) : 0.f, j3 < cols ? __ldg(x + j3) : 0.f);
}

__global__ void __launch_bounds__(32 * kWarps, 8)
aligned_kernel(const SpmxSegPlan p, const float* __restrict__ x, float* __restrict__ y,
               int add) {
  __shared__ Stage ring[kWarps][kRing];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * kWarps + warp;
  if (s >= p.num_segments) return;  // whole warp leaves; only warp syncs below
  const spmx::Segment seg = spmx::load_segment(p.segments, s);
  const int n = seg.count;
  const int window = t < n ? __ldg(p.col_off + seg.first + t) : 0;
  Stage* st = ring[warp];
  const float4* vals = reinterpret_cast<const float4*>(p.vals);
  const float4* lane = reinterpret_cast<const float4*>(p.lane);

  auto issue = [&](int i) {  // chunk i into stage i % kRing; one group a call
    if (i < n) {
      const int64_t c = (int64_t)seg.first + i;
      spmx_tile::copy16(&st[i % kRing].vals[t], vals + c * 32 + t, true);
      if (t < 8) spmx_tile::copy16(&st[i % kRing].lane[4 * t], lane + c * 8 + t, true);
    }
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
    const float4 v = st[i % kRing].vals[t];
    acc.x += v.x * xc.x;
    acc.y += v.y * xc.y;
    acc.z += v.z * xc.z;
    acc.w += v.w * xc.w;
    xc = xn;
    __syncwarp();  // stage i % kRing is refilled next iteration
  }
  spmx::finish_segment(p, s, seg, t, acc, y, add);
}

}  // namespace

SPMX_API int spmx_aligned(const SpmxSegPlan* plan, const float* x, float* y,
                          int add, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->num_segments == 0) return 0;
  const int64_t blocks = (plan->num_segments + kWarps - 1) / kWarps;
  aligned_kernel<<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      *plan, x, y, add);
  return (int)cudaGetLastError();
}
