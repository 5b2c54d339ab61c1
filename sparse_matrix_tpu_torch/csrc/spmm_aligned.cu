// Aligned SpMM: Y = A @ X for K columns on an aligned plan. Slot lane ==
// destination row % 128, so each product is a per-row contribution: row
// rb*128 + l of chunk c's row block gets, in column q,
//   vals[c, l] * X[col_off[c]*128 + lane[c, l], q]   (X past cols reads 0).
// X and Y are either packed, (blocks, K, 128) with X[j, q] at
// x3[j/128, q, j%128] (spmm_aligned_packed, aligned_matvec_multi), or
// row-major (cols, K) and (rows, K) (spmm_aligned, SpmvOperator.matmat):
// one template each.
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_aligned_spmm_kernel
// (called by _spmm_aligned_jit).
//
// Bound on the H100: device-memory bandwidth. A slot's value and lane (5
// bytes) are read once for all K columns; X and Y move 4*K bytes a row
// each; a chunk's (128, K) window of X is served by L1 and L2.
//
// Design: the segments of the aligned SpMV kernel (spmv_aligned.cu,
// segments.h) with the SpMM ownership of spmm_segments.h, as the LanePack
// SpMM (spmm_lanepack.cu) has it: one warp owns one segment, at most 32
// consecutive chunks of one row block in plan order, and at most 8 of the
// launch's columns (a launch takes at most 16; the wrapper cuts wider X into
// launches of 16 columns). Its chunks (values and lanes, 640 bytes) stream
// through a 3-stage ring of 16-byte cp.async copies once for all its columns.
// Thread t gathers the x values of its four slots for every column of the
// next chunk (32 independent loads at 8 columns; 16-byte loads of X's rows in
// the row-major layout) before it adds this chunk's products to its sums, so
// that the gathers' latency overlaps the products and the ring's copies (on
// the H100 this cut the device time by a third on Poisson 1024^2 and by 2.7x
// on randlocal_262k; PERF.md section 6). The 8 x 4 sums stay in registers, in
// plan order, each product and sum rounded on its own (__fmul_rn, __fadd_rn):
// with no spill the result is the segment-order plain version
// (ops/spmv.py::_segments_torch on the (cols, K) block) bit for bit. The sums
// reach Y through the segment's single writer (spmm_segments.h). Store mode
// writes every row of Y (packed: and zeros on the row blocks past r128, the
// matvec's guard row), so Y needs no zeroing; add mode adds onto Y. No
// atomics on Y, no memset, the same bits on every call. The plan's LanePack
// spill is not this kernel's work: the wrapper adds it with the LanePack SpMM
// kernel in add mode. The TPU kernel's two-target slab split
// (rb_a/rb_b/split) and alternating y buffers served a sequential grid and
// are not carried over.
#include <cuda_runtime.h>

#include "block_tile.h"
#include "segments.h"
#include "spmm_segments.h"
#include "spmx_cuda.h"

namespace {

using spmx_spmm::Call;
using spmx_spmm::kGroupCols;
using spmx_spmm::kWarps;

constexpr int kRing = 3;

struct Stage {
  float4 vals[32];  // slots 4t .. 4t+3 at [t]
  char4 lane[32];
};

// a warp's shared memory: its ring of chunks while it walks them, then the
// (128, KG) tile of its row-major Y
union WarpSmem {
  Stage ring[kRing];
  float tile[128 * kGroupCols];
};

template <int KG, bool kPacked>
__global__ void __launch_bounds__(32 * kWarps, KG >= 8 ? 2 : 3)
aligned_spmm_kernel(const SpmxSegPlan p, const float* __restrict__ x, float* __restrict__ y,
                    const Call c) {
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  spmx_spmm::WarpJob job;
  if (!spmx_spmm::warp_job<KG>(p, c, (int64_t)blockIdx.x * kWarps + warp, job))
    return;  // whole warp leaves; only warp syncs below
  const int nq = job.nq;       // this warp's columns ...
  const int64_t col = job.col;  // ... from column col of X and Y
  if constexpr (kPacked) spmx_spmm::zero_guard_blocks<KG>(p, c, y, job, t);
  const spmx::Segment seg = spmx::load_segment(p.segments, job.s);
  const int n = seg.count;
  const int window = t < n ? __ldg(p.col_off + seg.first + t) : 0;
  Stage* st = smem[warp].ring;
  const float4* vals = reinterpret_cast<const float4*>(p.vals);
  const float4* lane = reinterpret_cast<const float4*>(p.lane);
  auto issue = [&](int i) {  // chunk i into stage i % kRing; one group a call
    if (i < n) {
      const int64_t ch = (int64_t)seg.first + i;
      spmx_tile::copy16(&st[i % kRing].vals[t], vals + ch * 32 + t, true);
      if (t < 8) spmx_tile::copy16(&st[i % kRing].lane[4 * t], lane + ch * 8 + t, true);
    }
    spmx_tile::commit();
  };

  for (int i = 0; i < kRing - 1; ++i) issue(i);
  float acc[KG][4];
#pragma unroll
  for (int q = 0; q < KG; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;

  // x of chunk i's four slots a thread, for the warp's columns
  auto gather = [&](int i, float (&xv)[KG][4]) {
    const Stage& st_i = st[i % kRing];
    const int64_t base = (int64_t)__shfl_sync(spmx::kFullMask, window, i) * 128;
    const char4 l = st_i.lane[t];
    const int ln[4] = {l.x, l.y, l.z, l.w};  // lanes are column % 128, in [0, 128)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t j = base + ln[r];
      const bool in = j < p.cols;
      if constexpr (kPacked) {
        const float* xp = x + ((j >> 7) * c.k + col) * 128 + (j & 127);
#pragma unroll
        for (int q = 0; q < KG; ++q) xv[q][r] = in && q < nq ? __ldg(xp + q * 128) : 0.f;
      } else {
        const float* xp = x + j * c.k + col;
        bool done = false;
        if constexpr (KG >= 4) {
          if (c.vec4) {
#pragma unroll
            for (int q = 0; q < KG; q += 4) {
              const float4 v = in && q < nq ? __ldg(reinterpret_cast<const float4*>(xp + q))
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
              xv[q][r] = v.x;
              xv[q + 1][r] = v.y;
              xv[q + 2][r] = v.z;
              xv[q + 3][r] = v.w;
            }
            done = true;
          }
        }
        if (!done) {
#pragma unroll
          for (int q = 0; q < KG; ++q) xv[q][r] = in && q < nq ? __ldg(xp + q) : 0.f;
        }
      }
    }
  };

  // the x of chunk i + 1 is gathered before chunk i's products, so its
  // latency overlaps them
  float xc[KG][4];
  if (n > 0) {
    spmx_tile::wait_pending<kRing - 2>();  // chunk 0 landed
    __syncwarp();
    gather(0, xc);
  }
  for (int i = 0; i < n; ++i) {
    issue(i + kRing - 1);
    spmx_tile::wait_pending<kRing - 2>();  // chunks <= i + 1 landed
    __syncwarp();
    float xn[KG][4];
    if (i + 1 < n) gather(i + 1, xn);
    const float4 v4 = st[i % kRing].vals[t];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int q = 0; q < KG; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[q][r] = __fadd_rn(acc[q][r], __fmul_rn(v[r], xc[q][r]));
    if (i + 1 < n) {
#pragma unroll
      for (int q = 0; q < KG; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) xc[q][r] = xn[q][r];
    }
    __syncwarp();  // stage i % kRing is refilled next iteration
  }
  spmx_spmm::finish<KG, kPacked>(p, c, y, job, seg, t, acc, smem[warp].tile);
}

template <int KG>
cudaError_t launch(const SpmxSegPlan& p, const float* x, float* y, const Call& c, bool packed,
                   cudaStream_t s) {
  const int64_t warps = p.num_segments * c.groups;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  if (packed)
    aligned_spmm_kernel<KG, true><<<blocks, 32 * kWarps, 0, s>>>(p, x, y, c);
  else
    aligned_spmm_kernel<KG, false><<<blocks, 32 * kWarps, 0, s>>>(p, x, y, c);
  return cudaGetLastError();
}

}  // namespace

SPMX_API int spmx_aligned_spmm(const SpmxSegPlan* plan, const float* x, float* y, int k,
                               int q0, int kq, int packed, int64_t y_blocks, int add,
                               void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  Call c;
  int kg = 0;
  err = spmx_spmm::make_call(*plan, x, y, k, q0, kq, packed, y_blocks, add, c, kg);
  if (err != cudaSuccess) return (int)err;
  if (plan->num_segments == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kg) {
    case 1: err = launch<1>(*plan, x, y, c, packed, s); break;
    case 2: err = launch<2>(*plan, x, y, c, packed, s); break;
    case 4: err = launch<4>(*plan, x, y, c, packed, s); break;
    default: err = launch<8>(*plan, x, y, c, packed, s); break;
  }
  return (int)err;
}
