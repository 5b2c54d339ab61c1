// CSR-row SpMV for rows of any length: y = A x straight from the CSR arrays
// (int64 row offsets, uint32 columns, f32 values), the work balanced by the
// merge path of Merrill and Garland (Merge-based Parallel Sparse
// Matrix-Vector Multiplication, SC'16).
//
// Replaces: no TPU kernel. It was added for the skew class at scale (GAP's
// Kronecker graphs): rows whose lengths span five orders of magnitude, 46 %
// of them empty, and a gathered vector past L2. A thread or a warp a row
// leaves the card idle behind the hubs; a block a row idles on the empty
// and short rows; the port's slab formats pad such rows to many times the
// CSR's bytes (PERF.md §6).
//
// Bound on the H100: device-memory bandwidth. The compulsory bytes are the
// CSR once (12 bytes an entry with values, 8 a row), x once and y once; x
// is gathered by column, and where it lies past L2 each gather costs a
// sector of 32 bytes, which the compulsory count does not see.
//
// Design. The merge path walks the row ends (offsets[1:]) and the entries
// 0 .. nnz-1 as one sorted list of rows + nnz items: an entry is taken
// before the end of its row. The wrapper cuts the path into tiles of kTile
// items at plan time (coords: the path's (rows, entries) point at each tile
// start, a search of the offsets once) so that every block gets kTile items
// whatever the row lengths. A block
//   1. reads its entries' columns and values with coalesced streaming loads
//      (evict-first, so that x keeps L2), gathers x and keeps the products in
//      shared memory, and stages its rows' ends there (relative to the
//      tile's first entry: int32);
//   2. gives each thread kItems consecutive items; a thread finds its start
//      point by a binary search of the staged row ends, then walks: an entry
//      adds its product to the running sum, a row end stores the sum for
//      that row and starts a new one;
//   3. completes the row a thread started in, whose first part the threads
//      before it hold: a segmented inclusive scan (Hillis-Steele, keyed by
//      the row each thread ends in) over the threads' carry-outs in shared
//      memory, added to the row's value by the thread that ends the row;
//   4. writes its rows' values to y (coalesced) and the scan's last value,
//      the part of the row it leaves unfinished, to carry[tile].
// A row cut by a tile boundary is finished by a second, small kernel over
// the plan's split rows (row, first tile, ending tile): a warp a row sums
// the carries of the tiles before the ending one and adds them to the
// row's value. Every y[i] has one writer a kernel; no atomics, no memset,
// and every sum is taken in an order fixed by the plan, so two calls give
// equal bits. ops/spmv_csr.py's _csr_merge_torch repeats the order.
//
// Column stripes. Where x is past a share of L2 (ops/spmv_csr.py's
// stripe_width: at 134 MB, 2.7x the H100's 50 MB, each gather misses and
// fetches a 32-byte sector for 4 bytes), the plan cuts the columns into
// equal stripes, each a CSR of its own with its own merge path, and the
// stripes run in order on the stream: the gathers of a stripe fall in its
// slice of x, which L2 holds, while columns, values, offsets and y stream
// past it with evict-first loads and stores. Stripe 0 holds every row and
// stores y; each later stripe holds only the rows with entries in it
// (row_ids) and adds its part to y[row_ids[r]] (kAdd), its split rows
// after its tiles. A block loads the ids and y of the rows it ends beside
// its columns, before its gathers: loaded after the scan, they left each
// block idle at its end (a kron25 pull on an H100: 13.3 ms against 9.8).
// The order of the stripes is the plan's, so the bits stay fixed.
//
// Entry positions are int64 throughout (scale-27 Kronecker graphs hold
// about 4.2e9 entries); within a tile they are int32.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kSplitWarps = 8;
// the rows of a later stripe's tile a thread prefetches y of: each such row
// holds an entry, so a tile ends at most kTile / 2 of them
constexpr int kAddRows = kTile / 2 / kThreads;

// kAdd: a later stripe, whose rows are y's rows row_ids[r] and whose part
// adds to what the stripes before left there
template <bool kAdd>
__global__ void __launch_bounds__(kThreads)
    csr_tile_kernel(const int64_t* __restrict__ offsets, const uint32_t* __restrict__ cols,
                    const float* __restrict__ vals, const int64_t* __restrict__ coords,
                    const int32_t* __restrict__ row_ids, const float* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ carry) {
  __shared__ float s_prod[kTile];
  __shared__ int32_t s_end[kTile];
  __shared__ float s_row[kTile];
  __shared__ int32_t s_key[kThreads];
  __shared__ float s_scan[2][kThreads];

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t r0 = coords[2 * b], j0 = coords[2 * b + 1];
  const int nr = (int)(coords[2 * b + 2] - r0);
  const int ne = (int)(coords[2 * b + 3] - j0);

  // 1. products of the tile's entries and its rows' ends; with kAdd, y of
  // the rows the tile ends, loaded now so that step 4 does not wait on them
  // (no other block of the launch touches those rows)
  uint32_t c[kItems];
  float v[kItems];
  int32_t rid[kAddRows];
  float yv[kAddRows];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = t + k * kThreads;
    if (e < ne) {
      c[k] = __ldcs(cols + j0 + e);
      v[k] = __ldcs(vals + j0 + e);
    }
  }
  if (kAdd) {
#pragma unroll
    for (int k = 0; k < kAddRows; ++k) {
      if (t + k * kThreads < nr) rid[k] = __ldcs(row_ids + r0 + t + k * kThreads);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = t + k * kThreads;
    if (e < ne) s_prod[e] = v[k] * __ldg(x + c[k]);
  }
  if (kAdd) {
#pragma unroll
    for (int k = 0; k < kAddRows; ++k) {
      if (t + k * kThreads < nr) yv[k] = __ldcs(y + rid[k]);
    }
  }
  for (int k = t; k < nr; k += kThreads) {
    s_end[k] = (int32_t)(__ldcs((const long long*)(offsets + r0 + k + 1)) - j0);
  }
  __syncthreads();

  // 2. the thread's items: its start point on the path, then the walk
  const int items = nr + ne;
  const int d = min(t * kItems, items);
  const int d_end = min(d + kItems, items);
  int lo = max(0, d - ne), hi = min(d, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid < d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i_start = lo;
  int i = lo, j = d - lo;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (d + k < d_end) {
      if (i < nr && s_end[i] <= j) {
        s_row[i] = acc;
        acc = 0.f;
        ++i;
      } else {
        acc += s_prod[j];
        ++j;
      }
    }
  }

  // 3. segmented scan of the carry-outs, keyed by the row each thread ends in
  s_key[t] = i;
  s_scan[0][t] = acc;
  __syncthreads();
  int cur = 0;
#pragma unroll
  for (int s = 1; s < kThreads; s <<= 1) {
    float w = s_scan[cur][t];
    if (t >= s && s_key[t - s] == i) w = s_scan[cur][t - s] + w;
    s_scan[cur ^ 1][t] = w;
    cur ^= 1;
    __syncthreads();
  }
  if (t > 0 && i > i_start) s_row[i_start] = s_scan[cur][t - 1] + s_row[i_start];
  if (t == kThreads - 1) carry[b] = s_scan[cur][t];
  __syncthreads();

  // 4. the rows this tile ends
  if (kAdd) {
#pragma unroll
    for (int k = 0; k < kAddRows; ++k) {
      if (t + k * kThreads < nr) __stcs(y + rid[k], yv[k] + s_row[t + k * kThreads]);
    }
    for (int k = t + kAddRows * kThreads; k < nr; k += kThreads) {  // rows without entries
      const int32_t r = __ldcs(row_ids + r0 + k);
      __stcs(y + r, __ldcs(y + r) + s_row[k]);
    }
  } else {
    for (int k = t; k < nr; k += kThreads) __stcs(y + r0 + k, s_row[k]);
  }
}

// splits (S, 3) int64 rows (row, first tile, ending tile): y[i] = (the sum
// of carry[first .. ending - 1]) + y[i] for i = row (i = row_ids[row] with
// kAdd), a warp a row: each lane sums a stride of 32 tiles in order, then a
// fixed shuffle tree
template <bool kAdd>
__global__ void csr_split_kernel(const int64_t* __restrict__ splits, int64_t num_splits,
                                 const int32_t* __restrict__ row_ids,
                                 const float* __restrict__ carry, float* __restrict__ y) {
  const int64_t w = (int64_t)blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= num_splits) return;
  const int64_t row = splits[3 * w], first = splits[3 * w + 1], last = splits[3 * w + 2];
  float s = 0.f;
  for (int64_t k = first + lane; k < last; k += 32) s += carry[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int64_t i = kAdd ? (int64_t)row_ids[row] : row;
    y[i] = s + y[i];
  }
}

template <bool kAdd>
void launch_stripe(const SpmxCsrStripe* p, const float* x, float* y, cudaStream_t s) {
  csr_tile_kernel<kAdd><<<(unsigned)p->tiles, kThreads, 0, s>>>(
      p->offsets, p->cols, p->vals, p->coords, p->row_ids, x, y, p->carry);
  if (p->num_splits > 0) {
    const int64_t blocks = (p->num_splits + kSplitWarps - 1) / kSplitWarps;
    csr_split_kernel<kAdd><<<(unsigned)blocks, 32 * kSplitWarps, 0, s>>>(
        p->splits, p->num_splits, p->row_ids, p->carry, y);
  }
}

}  // namespace

SPMX_API int spmx_csr_threads(void) { return kThreads; }

SPMX_API int spmx_csr_items(void) { return kItems; }

SPMX_API int spmx_csr(const SpmxCsrPlan* plan, const float* x, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  for (int64_t k = 0; k < plan->num_stripes; ++k) {
    const SpmxCsrStripe* p = plan->stripes + k;
    if (p->tiles <= 0) continue;
    if (k == 0) {
      launch_stripe<false>(p, x, y, s);
    } else {
      launch_stripe<true>(p, x, y, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
