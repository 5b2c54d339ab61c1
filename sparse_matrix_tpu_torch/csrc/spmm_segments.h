// The SpMM form of segments.h: what the aligned (spmm_aligned.cu) and
// LanePack (spmm_lanepack.cu) SpMM kernels share once a warp has summed its
// segment for its columns.
//
// One warp owns one segment (at most 32 consecutive chunks of one row
// block) and at most kGroupCols of a launch's columns (a launch takes at
// most kMaxCols; a segment of a launch of kq columns has ceil(kq / KG)
// warps, neighbours in the grid). Thread t holds the sums of rows (lanes)
// 4t .. 4t+3 of the row block for each of its columns, in plan order. The
// sums reach Y through the segment's single writer: a row block of several
// segments is added up in segment order by the last warp to take its ticket
// (one ticket a row block and column group), from scratch slots kMaxCols
// columns wide. X and Y are either packed, (blocks, K, 128) with X[j, q] at
// x3[j/128, q, j%128], or row-major (cols, K) and (rows, K): one template
// each. Store mode writes every row of Y (packed: every lane of row blocks <
// r128, and zeros on the row blocks past r128 up to y_blocks; row-major:
// every row < rows), so Y needs no zeroing; add mode adds onto Y. No
// atomics on Y, the same bits on every call.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.h"
#include "spmx_cuda.h"

namespace spmx_spmm {

constexpr int kWarps = 8;      // warps a thread block
constexpr int kMaxCols = 16;   // columns a launch: the scratch slot holds 16 * 128 floats
constexpr int kGroupCols = 8;  // columns a warp at most

struct Call {
  int64_t y_blocks;  // packed: row blocks of y3 (>= r128)
  int k;             // columns of X and Y
  int q0;            // first column of the launch
  int kq;            // columns of the launch (<= kMaxCols)
  int groups;        // warps a segment
  int vec4;          // row-major with k % 4 == 0 and 16-byte aligned X, Y
  int add;
};

// the warp's place: segment s, column group g, its nq columns from col
struct WarpJob {
  int64_t s;
  int g;
  int nq;
  int64_t col;
};

template <int KG>
__device__ __forceinline__ bool warp_job(const SpmxSegPlan& p, const Call& c, int64_t w,
                                         WarpJob& job) {
  if (w >= p.num_segments * c.groups) return false;
  job.s = w / c.groups;
  job.g = (int)(w - job.s * c.groups);
  job.nq = min(KG, c.kq - job.g * KG);
  job.col = c.q0 + job.g * KG;
  return true;
}

// packed store mode: zeros on y3's row blocks past r128 (a matvec's guard
// rows), spread over the segments
template <int KG>
__device__ __forceinline__ void zero_guard_blocks(const SpmxSegPlan& p, const Call& c,
                                                  float* y, const WarpJob& job, int t) {
  if (c.add) return;
  const int64_t r128 = (p.rows + 127) >> 7;
  for (int64_t gb = r128 + job.s; gb < c.y_blocks; gb += p.num_segments) {
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      if (q >= job.nq) break;
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
      spmx::store_v<4>(y + (gb * c.k + job.col + q) * 128 + 4 * t, z);
    }
  }
}

// Y of thread t's rows (lanes) 4t .. 4t+3 for columns col .. col + nq - 1
// of row block rb. Packed: one float4 a column, a warp's stores of a
// column contiguous. Row-major: the warp's (128, nq) tile goes through its
// shared-memory `tile` (KG * 128 floats, free once the chunks are done),
// so that the warp writes Y's rows in contiguous runs.
template <int KG, bool kPacked>
__device__ __forceinline__ void write_y(const SpmxSegPlan& p, const Call& c, float* y,
                                        int64_t rb, int64_t col, int nq, int t,
                                        float (&acc)[KG][4], float* tile) {
  if constexpr (kPacked) {
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      if (q >= nq) break;
      float* yp = y + (rb * c.k + col + q) * 128 + 4 * t;
      if (c.add) {
        float w[4];
        spmx::load_v<4>(yp, w);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][r] = w[r] + acc[q][r];
      }
      spmx::store_v<4>(yp, acc[q]);
    }
  } else {
    // tile[r * KG + q]: row r of the row block, column q
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < KG; ++q) tile[(4 * t + r) * KG + q] = acc[q][r];
    __syncwarp();
    const int64_t rows = min((int64_t)128, p.rows - rb * 128);
    float* y0 = y + rb * 128 * c.k + col;
    if (c.vec4) {
      const int per_row = nq >> 2;  // float4s a row
      for (int u = t; u < rows * per_row; u += 32) {
        const int r = u / per_row, f = u - r * per_row;
        float v[4];
        spmx::load_v<4>(tile + r * KG + 4 * f, v);
        float* yp = y0 + (int64_t)r * c.k + 4 * f;
        if (c.add) {
          float w[4];
          spmx::load_v<4>(yp, w);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = w[i] + v[i];
        }
        spmx::store_v<4>(yp, v);
      }
    } else {
      for (int u = t; u < rows * nq; u += 32) {
        const int r = u / nq, q = u - r * nq;
        float* yp = y0 + (int64_t)r * c.k + q;
        *yp = c.add ? *yp + tile[r * KG + q] : tile[r * KG + q];
      }
    }
  }
}

// The end of the warp's segment: a segment that shares its row block
// writes its slot and takes the ticket, and the last warp adds the slots in
// segment order; the row block's single writer then writes Y (an empty row
// block adds nothing in add mode). Every lane of the warp calls this.
template <int KG, bool kPacked>
__device__ __forceinline__ void finish(const SpmxSegPlan& p, const Call& c, float* y,
                                       const WarpJob& job, const spmx::Segment& seg, int t,
                                       float (&acc)[KG][4], float* tile) {
  if (seg.slot >= 0) {
    const int first = __ldg(p.rb_seg + seg.rb);
    const int nseg = __ldg(p.rb_seg + seg.rb + 1) - first;
    const int64_t slot0 = seg.slot - (job.s - first);
    const int64_t width = (int64_t)kMaxCols * 128;
    const int64_t off = (int64_t)job.g * KG * 128 + 4 * t;
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      if (q >= job.nq) break;
      spmx::store_v<4>(p.scratch + seg.slot * width + off + q * 128, acc[q]);
    }
    __threadfence();
    const int64_t r128 = (p.rows + 127) >> 7;
    int32_t* ticket = p.tickets + job.g * r128 + seg.rb;
    const int got = spmx::WarpOwner{t}.sync_from0([&] { return atomicAdd(ticket, 1); });
    if (got != nseg - 1) return;
    __threadfence();
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      if (q >= job.nq) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;
      for (int k = 0; k < nseg; ++k)
        spmx::add_cg<4>(acc[q], p.scratch + (slot0 + k) * width + off + q * 128);
    }
    if (t == 0) *ticket = 0;
  } else if (c.add && seg.count == 0) {
    return;  // an empty row block adds nothing
  }
  write_y<KG, kPacked>(p, c, y, seg.rb, job.col, job.nq, t, acc, tile);
}

// Check a launch's columns and pick the warps' column group KG; returns
// cudaSuccess and fills c and kg, or cudaErrorInvalidValue.
__host__ inline cudaError_t make_call(const SpmxSegPlan& p, const float* x, const float* y,
                                      int k, int q0, int kq, int packed, int64_t y_blocks,
                                      int add, Call& c, int& kg) {
  if (k < 1 || q0 < 0 || kq < 1 || kq > kMaxCols || q0 + kq > k) return cudaErrorInvalidValue;
  if (packed && y_blocks < (p.rows + 127) / 128) return cudaErrorInvalidValue;
  kg = min(kq <= 1 ? 1 : kq <= 2 ? 2 : kq <= 4 ? 4 : 8, kGroupCols);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  c = Call{y_blocks, k, q0, kq, (kq + kg - 1) / kg,
           !packed && kg >= 4 && k % 4 == 0 && aligned, add};
  return cudaSuccess;
}

}  // namespace spmx_spmm
