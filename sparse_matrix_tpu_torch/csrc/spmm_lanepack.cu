// LanePack SpMM: Y = A @ X for K columns on a LanePack plan. Per 128-slot
// chunk c of row block rb and column q:
//   p[s]  = vals[c, s] * X[col_off[c]*128 + lane[c, s], q]   (x past cols reads 0)
//   incl  = inclusive prefix sum of p over the chunk
//   Y[rb*128 + l, q] gets incl[ends[c, l]] - (starts[c, l] < 0 ? 0 : incl[starts[c, l]])
// X and Y are either packed, (blocks, K, 128) with X[j, q] at
// x3[j/128, q, j%128] (spmm_lanepack_packed, lanepack_matvec_multi and
// the aligned SpMM's spill), or natural, row-major (cols, K) and (rows, K)
// (spmm_lanepack and the BELL SpMM's spill): one template each.
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_lanepack_spmm_kernel
// (called by _spmm_lanepack_jit).
//
// Bound on the H100: device-memory bandwidth. A slot's value, lane, end and
// start (8 bytes) are read once for all K columns; X and Y move 4*K bytes
// a row each; the window rows of a chunk (kw*128 rows of X) are served by
// L1 and L2.
//
// Design: the segments of the LanePack SpMV kernel (spmv_lanepack.cu,
// segments.h): one warp owns one segment, at most 32 consecutive chunks of
// one row block in plan order, and at most 8 of the launch's columns (a
// launch takes at most 16; the wrapper cuts wider X into launches of 16
// columns). Its chunks stream through a 3-stage ring of 16-byte cp.async
// copies (lanepack_stage.h) once for all its columns; at 16 columns the
// segment's two warps are neighbours in the grid, so the second reads the
// chunks from L2. Per chunk, thread t gathers the x values of its four
// slots for every column first (32 independent loads at 8 columns; 16-byte
// loads of X's rows in the row-major layout), then, four columns at a time
// so that their shuffle chains interleave, multiplies, scans within the
// thread and across the warp with shuffles (the fp32 prefix sum that the
// TPU kernel took from a triangular matmul at HIGHEST precision), and
// takes the run differences of lanes 4t .. 4t+3 from four 512-byte
// prefix buffers in shared memory. The 8 x 4 sums stay in registers, in
// plan order (124 registers, no spills: two blocks of 256 threads an SM).
// On the H100 (PERF.md section 6) four columns at a time beat two, and two
// beat one, on every case; warps of 4 or 2 columns, which read each chunk
// two or four times, lost on randlocal and powerlaw, as did a 2-stage
// ring, and all 8 columns at once with 4 warps a block (more shared
// memory, less L1 for the x windows) lost 16 % on Poisson and 1.8x on
// powerlaw. The sums reach Y through the segment's single writer
// (spmm_segments.h, shared with the aligned SpMM): a row block of several
// segments is added up in segment order by the last warp
// to take its ticket (one ticket a row block and 8-column group), from
// scratch slots 16 columns wide. In the row-major layout the warp's (128,
// 8) tile of Y goes through its shared memory (the ring's, free by then),
// so that the warp stores whole runs of Y's rows. Store mode writes every
// row of Y (packed: every lane of row blocks < r128, and zeros on the row
// blocks past r128 up to y_blocks; row-major: every row < rows), so Y
// needs no zeroing; add mode adds onto Y (a spill). No atomics on Y, the
// same bits on every call.
#include <cuda_runtime.h>

#include "block_tile.h"
#include "lanepack_stage.h"
#include "segments.h"
#include "spmm_segments.h"
#include "spmx_cuda.h"

namespace {

using spmx_spmm::Call;
using spmx_spmm::kGroupCols;
using spmx_spmm::kMaxCols;
using spmx_spmm::kWarps;

constexpr int kRing = 3;

constexpr int kScanCols = 4;  // columns scanned together

// a warp's shared memory: its ring of chunks and the prefix sums of
// kScanCols columns while it walks its chunks, then the (128, KG) tile of
// its row-major Y
union WarpSmem {
  struct {
    spmx::LanePackStage ring[kRing];
    float4 prefix[kScanCols][32];  // thread t's four slots at [t]
  } s;
  float tile[128 * kGroupCols];
};

template <int KG, bool kPacked>
__global__ void __launch_bounds__(32 * kWarps, KG >= 8 ? 2 : 3)
lanepack_spmm_kernel(const SpmxSegPlan p, const float* __restrict__ x, float* __restrict__ y,
                     const Call c) {
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  spmx_spmm::WarpJob job;
  if (!spmx_spmm::warp_job<KG>(p, c, (int64_t)blockIdx.x * kWarps + warp, job))
    return;  // whole warp leaves; only warp syncs below
  const int64_t s = job.s;
  const int nq = job.nq;       // this warp's columns ...
  const int64_t col = job.col;  // ... from column col of X and Y
  if constexpr (kPacked) spmx_spmm::zero_guard_blocks<KG>(p, c, y, job, t);
  const spmx::Segment seg = spmx::load_segment(p.segments, s);
  const int n = seg.count;
  const int window = t < n ? __ldg(p.col_off + seg.first + t) : 0;
  spmx::LanePackStage* st = smem[warp].s.ring;
  const spmx::LanePackCopier copy(p, t);
  auto issue = [&](int i) {  // chunk i into stage i % kRing; one group a call
    if (i < n) copy(st[i % kRing], (int64_t)seg.first + i);
    spmx_tile::commit();
  };

  for (int i = 0; i < kRing - 1; ++i) issue(i);
  float acc[KG][4];
#pragma unroll
  for (int q = 0; q < KG; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;

  for (int i = 0; i < n; ++i) {
    issue(i + kRing - 1);
    spmx_tile::wait_pending<kRing - 2>();  // chunks <= i landed
    __syncwarp();
    const spmx::LanePackStage& cur = st[i % kRing];
    const int64_t base = (int64_t)__shfl_sync(spmx::kFullMask, window, i) * 128;
    int ln[4];
    spmx::stage_lanes(cur, t, ln);
    float xv[KG][4];
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
    const float4 v = cur.vals[t];
    const char4 e = cur.ends[t], b = cur.starts[t];
    constexpr int P = KG < kScanCols ? KG : kScanCols;
#pragma unroll
    for (int q0 = 0; q0 < KG; q0 += P) {
      if (q0 >= nq) break;  // warp-uniform
      float a[P][4], incl[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int q = q0 + u;
        a[u][0] = v.x * xv[q][0];
        a[u][1] = a[u][0] + v.y * xv[q][1];
        a[u][2] = a[u][1] + v.z * xv[q][2];
        a[u][3] = a[u][2] + v.w * xv[q][3];
        incl[u] = a[u][3];
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const float up = __shfl_up_sync(spmx::kFullMask, incl[u], d);
          if (t >= d) incl[u] += up;
        }
      }
      float4 (*buf)[32] = smem[warp].s.prefix;
      if (q0 > 0) __syncwarp();  // the previous columns' reads are done
#pragma unroll
      for (int u = 0; u < P; ++u) {
        float excl = __shfl_up_sync(spmx::kFullMask, incl[u], 1);
        if (t == 0) excl = 0.f;
        buf[u][t] = make_float4(excl + a[u][0], excl + a[u][1], excl + a[u][2], excl + a[u][3]);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int q = q0 + u;
        const float* pre = reinterpret_cast<const float*>(buf[u]);
        acc[q][0] += pre[e.x] - (b.x < 0 ? 0.f : pre[b.x]);
        acc[q][1] += pre[e.y] - (b.y < 0 ? 0.f : pre[b.y]);
        acc[q][2] += pre[e.z] - (b.z < 0 ? 0.f : pre[b.z]);
        acc[q][3] += pre[e.w] - (b.w < 0 ? 0.f : pre[b.w]);
      }
    }
    __syncwarp();  // prefix and stage i % kRing are rewritten next iteration
  }

  spmx_spmm::finish<KG, kPacked>(p, c, y, job, seg, t, acc, smem[warp].tile);
}

template <int KG>
cudaError_t launch(const SpmxSegPlan& p, const float* x, float* y, const Call& c, bool packed,
                   cudaStream_t s) {
  const int64_t warps = p.num_segments * c.groups;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  if (packed)
    lanepack_spmm_kernel<KG, true><<<blocks, 32 * kWarps, 0, s>>>(p, x, y, c);
  else
    lanepack_spmm_kernel<KG, false><<<blocks, 32 * kWarps, 0, s>>>(p, x, y, c);
  return cudaGetLastError();
}

}  // namespace

SPMX_API int spmx_lanepack_spmm_max_cols(void) { return kMaxCols; }

SPMX_API int spmx_lanepack_spmm_group_cols(void) { return kGroupCols; }

SPMX_API int spmx_lanepack_spmm(const SpmxSegPlan* plan, const float* x, float* y, int k,
                                int q0, int kq, int packed, int64_t y_blocks, int add,
                                void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  spmx_spmm::Call c;
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
