// ESC SpGEMM k-major expansion, driven by the plan's per-k segments: for
// every contraction index k with lk = nnz(A[:, k]) > 0 and rk = nnz(B[k, :])
// > 0, segment j holds the slots [start, start + lk*rk) and slot start + r*lk
// + l gets
//   p = lv[la + l] * rv[ra + r]     (lv_csr[perm[la + l]] with csr_order)
// (rhs entry major, lhs entry minor: the plan order of esc_expand.py); the
// padding slots past num_products get 0.
//
// Replaces: sparse_matrix_tpu/ops/esc_expand.py, _make_expand_kernel (called
// by _expand_jit).
//
// Bound on the H100: device-memory bandwidth. The product stream written
// (4 bytes a product) is most of the bytes; A and B are read about once.
//
// Design. The first version ran one thread a slot that read two int16
// lanes and two window rows from device memory (8 bytes a product besides
// the product itself). Here no per-slot array exists: a block takes a tile
// of kTile consecutive slots and, in one round of loads, stages the tile's
// lhs and rhs value windows (host-planned, `tiles`; the lhs through `perm`
// for CSR-order values) and the starts of its segments in shared memory.
// Each thread owns kSlots consecutive slots: it finds the segment of its
// first slot by a binary search over the staged starts, splits that slot's
// offset into (r, l) once (a float reciprocal corrected to the exact
// quotient), then steps lane by lane, row by row and segment by segment (a
// segment starts at (0, 0); a countdown finds its end), reading both
// operands from shared memory, and stores its products as two 16-byte
// vectors. kMinBlocks = 8 holds the kernel to 32 registers, so a full SM of
// threads hides the staging round. A tile whose windows or starts outgrow
// shared memory (a segment whose lhs column or rhs row is longer than
// kStage, gaps between segments, more than kSegStage segments), and the
// thread holding the last real slot, take one slot at a time from device
// memory instead, so nothing is refused. Every product is one IEEE f32
// multiply (no contraction), equal bit for bit to the plain versions'.
// The design search (femlike_262k squared, device time; PERF.md §6): one
// slot a lane with a warp cursor on the segment heads 0.0806 ms, the lane
// kernel 0.0883; eight slots a thread with a binary search in device
// memory 0.0671; this kernel 0.0476 (0.070 at 53 registers).
#include <climits>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;  // 32 registers: a full SM of threads
constexpr int kSlots = 8;  // consecutive slots a thread
constexpr int kTile = kThreads * kSlots;  // slots a block
constexpr int kStage = 2048;  // values of each operand window in shared memory
constexpr int kSegStage = 1024;  // segment starts of a tile in shared memory

// the row r and lhs lane l of offset w in a segment of lk lhs entries:
// w = r * lk + l, 0 <= l < lk (a float estimate, then exact corrections)
__device__ __forceinline__ void split(int w, int lk, float rcp, int& r, int& l) {
  r = __float2int_rz(__int2float_rz(w) * rcp);
  l = w - r * lk;
  r += __float2int_rz(__int2float_rz(l) * rcp);
  l = w - r * lk;
  while (l < 0) {
    --r;
    l += lk;
  }
  while (l >= lk) {
    ++r;
    l -= lk;
  }
}

// p[s] for the real slot s of segment row g = (start, lk, la, ra), read
// from device memory (the path of tiles whose windows or segment starts are
// not staged)
__device__ __forceinline__ float product(int4 g, int s, const int32_t* __restrict__ perm,
                                         const float* __restrict__ lv,
                                         const float* __restrict__ rv) {
  int r, l;
  split(s - g.x, g.y, __fdividef(1.0f, __int2float_rn(g.y)), r, l);
  const int a = g.z + l;
  return __fmul_rn(perm ? __ldg(lv + __ldg(perm + a)) : __ldg(lv + a), __ldg(rv + g.w + r));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    esc_expand_kernel(const int4* __restrict__ segs, const int4* __restrict__ tiles,
                      const int32_t* __restrict__ perm, const float* __restrict__ lv,
                      const float* __restrict__ rv, int n, int slots, float* __restrict__ p) {
  __shared__ float s_lv[kStage];
  __shared__ float s_rv[kStage];
  __shared__ int s_start[kSegStage];
  const int t0 = blockIdx.x * kTile;
  // tile: first and last segment, lhs window [a_lo, a_hi), rhs window
  // [e_lo, e_hi)
  const int4 td = __ldg(tiles + 2 * blockIdx.x);
  const int4 te = __ldg(tiles + 2 * blockIdx.x + 1);
  const int j_first = td.x, a_lo = td.y, a_n = td.z - td.y, e_lo = td.w, e_n = te.x - td.w;
  const int seg_n = te.y - j_first + 2;  // the tile's segments and the next one
  const bool staged = a_n <= kStage && e_n <= kStage && seg_n <= kSegStage;
  if (staged) {  // one round of loads: both windows and the segment starts
    for (int i = threadIdx.x; i < a_n; i += kThreads)
      s_lv[i] = perm ? __ldg(lv + __ldg(perm + a_lo + i)) : __ldg(lv + a_lo + i);
    for (int i = threadIdx.x; i < e_n; i += kThreads) s_rv[i] = __ldg(rv + e_lo + i);
    for (int i = threadIdx.x; i < seg_n; i += kThreads) s_start[i] = __ldg(&segs[j_first + i].x);
  }
  __syncthreads();

  const int s0 = t0 + threadIdx.x * kSlots;
  if (s0 >= slots) return;
  if (!staged || s0 + kSlots > n) {
    // a tile too wide for shared memory, or the thread holding the last
    // real slot: one slot at a time from device memory
    int j = j_first, hi = te.y;
    while (s0 < n && j < hi) {  // the segment holding s0
      const int mid = (j + hi + 1) >> 1;
      if (__ldg(&segs[mid].x) <= s0)
        j = mid;
      else
        hi = mid - 1;
    }
#pragma unroll 1
    for (int s = s0; s < s0 + kSlots; ++s) {
      float v = 0.0f;
      if (s < n) {
        while (__ldg(&segs[j + 1].x) <= s) ++j;
        v = product(__ldg(segs + j), s, perm, lv, rv);
      }
      p[s] = v;
    }
    return;
  }
  // the segment holding s0: the last of the tile's starting at or before it
  int lo = 0, hi = seg_n - 2;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_start[mid] <= s0)
      lo = mid;
    else
      hi = mid - 1;
  }
  int j = lo;
  int4 g = __ldg(segs + j_first + j);  // start, lk, la, ra
  int left = s_start[j + 1] - s0;      // its slots from s0 on
  int r, l;
  split(s0 - g.x, g.y, __fdividef(1.0f, __int2float_rn(g.y)), r, l);
  const float* x = s_lv + (g.z - a_lo);
  const float* y = s_rv + (g.w - e_lo);
  float v[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (left == 0) {  // the next segment starts here, at (0, 0)
      g = __ldg(segs + j_first + ++j);
      left = s_start[j + 1] - g.x;
      x = s_lv + (g.z - a_lo);
      y = s_rv + (g.w - e_lo);
      r = l = 0;
    }
    v[i] = __fmul_rn(x[l], y[r]);
    --left;
    if (++l == g.y) {
      l = 0;
      ++r;
    }
  }
  float4* out = reinterpret_cast<float4*>(p + s0);
#pragma unroll
  for (int i = 0; i < kSlots / 4; ++i)
    out[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

}  // namespace

SPMX_API int spmx_esc_expand_tile(void) { return kTile; }

SPMX_API int spmx_esc_expand_stage(void) { return kStage; }

SPMX_API int spmx_esc_expand_seg_stage(void) { return kSegStage; }

SPMX_API int spmx_esc_expand(const SpmxEscPlan* plan, const float* lv, const float* rv,
                             int csr_order, float* p, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (plan->num_slots + kTile - 1) / kTile;
  if (plan->num_slots > (1 << 30) || plan->num_products > plan->num_slots ||
      plan->num_segments >= INT_MAX || plan->num_tiles != tiles)
    return (int)cudaErrorInvalidValue;
  if (plan->num_slots == 0) return 0;
  esc_expand_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(plan->segments), reinterpret_cast<const int4*>(plan->tiles),
      csr_order ? plan->perm : nullptr, lv, rv, (int)plan->num_products, (int)plan->num_slots,
      p);
  return (int)cudaGetLastError();
}
