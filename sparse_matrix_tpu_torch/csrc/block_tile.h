// The dense block product shared by the BCSR SpMM (spmm_bcsr.cu) and the
// block SpGEMM (spgemm_block.cu) kernels, over a live-depth stream.
//
// A 128-thread block accumulates one 64 x 64 output tile
//   acc[m, n] = sum_{e in [beg, end)} A[ia(e), a_col0 + m] * B[ib(e), b_col0 + n]
// where (ia, ib) = index(e) names one row of each operand: A k-major (the
// A^T rows of the block SpGEMM's transposed A blocks, or of the BCSR
// blocks), B row-major (B blocks, or rows of X). The stream lists only the
// depth rows that can contribute, so the tile does no work on the zero
// columns and rows of sparse blocks.
//
// * Products on the FP64 tensor cores: mma.sync m16n8k16 .f64, a shape
//   sm_90 adds (on the H100 no slower than m16n8k4 and m16n8k8, and faster
//   on B10's dense blocks). f32 and bf16 operands are widened to f64 as
//   fragments are loaded, so each product is exact (24 x 24 bits fit 53),
//   sums run in f64 and C is rounded to f32 once, in the store: an entry
//   of n products is within 1/(n + 2) of the float32 bound
//   (n + 2) u (|A||B|). No TF32 and no bf16 MMA touches the data
//   (ROADMAP.md C5).
// * Staging: a ring of kStages stages in dynamic shared memory, each the
//   next kChunk stream rows of both operands as stored (f32, or bf16 for
//   half the bytes), filled by 16-byte cp.async copies, one commit group a
//   stage, so the copies of the chunks ahead overlap this chunk's MMAs.
//   Rows past the stream's end and columns past an operand's width are
//   zero-filled (cp.async src-size 0). Each thread fetches the stream
//   indices of the chunk after next while the current chunk computes.
// * 4 warps in 2 x 2, a 32 x 32 warp tile each: 2 x 4 m16n8 accumulators
//   of 4 doubles, 64 registers a thread.
// * Shared-memory rows are padded to kLd elements, so that a warp's
//   fragment reads (4 depth rows x 8 neighbouring elements) hit 32
//   distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace spmx_tile {

constexpr int kTile = 64;         // output tile edge
constexpr int kThreads = 128;     // 4 warps
constexpr int kChunk = 32;        // stream rows per stage
constexpr int kStages = 4;        // cp.async ring depth
constexpr int kLd = kTile + 8;    // shared-memory row pitch, elements
constexpr int kMmaK = 16;         // depth of one m16n8k16 MMA
static_assert(kChunk % kMmaK == 0, "a stage holds whole MMA steps");
constexpr int kKv = kMmaK / 4;    // depth values of a fragment per lane: k = t + 4 v

// [offsets[i], offsets[i + 1]) clamped to [0, len): a bad offset reads nothing
__device__ __forceinline__ int64_t clamp_len(int32_t v, int64_t len) {
  return v < 0 ? 0 : (v > len ? len : (int64_t)v);
}

// dynamic shared memory of the ring: kStages x (A chunk, B chunk)
template <typename T>
constexpr int smem_bytes() {
  return kStages * 2 * kChunk * kLd * (int)sizeof(T);
}

__device__ __forceinline__ double widen(float v) { return (double)v; }
__device__ __forceinline__ double widen(__nv_bfloat16 v) {
  return (double)__bfloat162float(v);
}

// d += a @ b on the FP64 tensor cores (m16n8k16); fragments as in the PTX
// ISA (and CuTe's SM90 F64 traits): lane = 4 g + t; a[v0 + 2 v1] at
// (m = g + 8 v0, k = t + 4 v1), b[v] at (k = t + 4 v, n = g), d[v0 + 2 v1]
// at (m = g + 8 v1, n = 2 t + v0)
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2 * kKv],
                                     const double (&b)[kKv]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// one 16-byte global -> shared copy; zero-fills the destination when !valid
// (src must still be a mapped address)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// what each thread copies of a stage: kPerRow 16-byte pieces make one row's
// 64 elements; thread tid copies piece tid % kPerRow of rows
// tid / kPerRow + kRowStep * j, j < kRows, of both operands
template <typename T>
struct Copies {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kPerRow = kTile / kVec;
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kRows = kChunk / kRowStep;
  static_assert(kThreads % kPerRow == 0 && kChunk % kRowStep == 0, "copy tiling");
};

// acc (zeroed by the caller) += the stream rows [beg, end) of A and B, in
// stream order. A rows have lda elements and contribute columns
// [a_col0, a_col0 + 64) (those at or past a_lim read 0); B likewise. index
// is a functor e -> int2 (A row, B row). smem: smem_bytes<T>() bytes.
template <typename T, typename Index>
__device__ __forceinline__ void block_product(
    const T* __restrict__ A, int64_t lda, int a_col0, int a_lim,
    const T* __restrict__ B, int64_t ldb, int b_col0, int b_lim, int64_t beg,
    int64_t end, const Index& index, T* smem, double (&acc)[2][4][4]) {
  using C = Copies<T>;
  const int tid = threadIdx.x;
  const int piece = tid % C::kPerRow;
  const int row0 = tid / C::kPerRow;
  const int a_col = a_col0 + piece * C::kVec;
  const int b_col = b_col0 + piece * C::kVec;
  const bool a_in = a_col < a_lim;
  const bool b_in = b_col < b_lim;
  const int nchunks = (int)((end - beg + kChunk - 1) / kChunk);

  int2 rows[C::kRows];
  auto fetch = [&](int chunk) {
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) {
      const int64_t e = beg + (int64_t)chunk * kChunk + row0 + C::kRowStep * j;
      rows[j] = e < end ? index(e) : make_int2(-1, -1);
    }
  };
  auto copy_chunk = [&](int chunk) {
    T* sa = smem + (chunk % kStages) * (2 * kChunk * kLd);
    T* sb = sa + kChunk * kLd;
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) {
      const int r = row0 + C::kRowStep * j;
      const bool live = rows[j].x >= 0;
      copy16(sa + r * kLd + piece * C::kVec,
             live && a_in ? A + rows[j].x * lda + a_col : A, live && a_in);
      copy16(sb + r * kLd + piece * C::kVec,
             live && b_in ? B + rows[j].y * ldb + b_col : B, live && b_in);
    }
  };

  fetch(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) copy_chunk(s);
    commit();
    fetch(s + 1);
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  for (int c = 0; c < nchunks; ++c) {
    wait_pending<kStages - 2>();
    __syncthreads();  // chunk c landed for all; stage (c - 1) % kStages free
    if (c + kStages - 1 < nchunks) copy_chunk(c + kStages - 1);
    commit();
    fetch(c + kStages);
    const T* sa = smem + (c % kStages) * (2 * kChunk * kLd);
    const T* sb = sa + kChunk * kLd;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += kMmaK) {
      double a[2][2 * kKv], b[4][kKv];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int v = 0; v < kKv; ++v) {
          const T* p = sa + (kk + t + 4 * v) * kLd + wm + 16 * i + g;
          a[i][2 * v] = widen(p[0]);
          a[i][2 * v + 1] = widen(p[8]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int v = 0; v < kKv; ++v)
          b[j][v] = widen(sb[(kk + t + 4 * v) * kLd + wn + 8 * j + g]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[i], b[j]);
      }
    }
  }
}

// out[m * ldo + n] = (float)acc for m < m_valid and n < n_valid of the tile
// (m_valid, n_valid even), rounded once from f64
__device__ __forceinline__ void store(float* __restrict__ out, int64_t ldo,
                                      int m_valid, int n_valid,
                                      const double (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn + 8 * j + 2 * t;
      if (n >= n_valid) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + 16 * i + g + 8 * h;
        if (m < m_valid)
          *reinterpret_cast<float2*>(out + m * ldo + n) =
              make_float2((float)acc[i][j][2 * h], (float)acc[i][j][2 * h + 1]);
      }
    }
  }
}

}  // namespace spmx_tile
