// Multicolour symmetric Gauss-Seidel over DIA band planes: one SymGS step
// toward A x = r, x updated in place, in one launch.
//
// Replaces: no TPU kernel. The JAX package has no Gauss-Seidel smoother;
// this one serves HPCG's multigrid (sparse_matrix_tpu_torch/solvers/
// hpcg.py), where its symmetric Gauss-Seidel does about two thirds of a
// set's compulsory traffic.
//
// The rows are split into colours such that no two rows of one colour are
// coupled (a parity colouring of the 27-point grid has 8). A forward sweep
// visits colours 0 .. C-1, a backward sweep C-1 .. 0; a colour's pass sets
// x[i] = (r[i] - sum_{b != diag} data[b, i] * x[i + off_b]) / data[diag, i]
// for all its rows at once, from the current x: exact Gauss-Seidel in that
// order of the rows.
//
// Bound on the H100: device-memory bandwidth on HPCG's finest level, the
// latency of one pass after another on its coarse levels. A sweep
// direction must read every band slot once (8 bytes in f64, 4 in f32), r
// once, and read and write x once. Layout: colour-blocked rows. The wrapper
// re-lays the planes so that the rows of one colour lie together, in
// natural order within the colour (`data` column k holds the bands of row
// rows[k]), and one thread takes one row. A warp then reads each plane as
// one coalesced line and a sweep direction streams every plane slot exactly
// once. r and x keep the natural order, so their reads are strided by the
// colouring; with x (9 MB at 104^3 in f64) and a pass's share of r in the
// 50 MB L2 they come mostly from there.
//
// One launch a step. A colour pass used to be a launch of its own, so each
// pass paid a kernel's ramp and drain and, in the V-cycle's CUDA graph, the
// gap to the next kernel (3.4 us a pass at 13^3, where the rows take one
// memory latency). Here the 2 C passes (empty colours left out) are cut into
// work items of T rows (T, chunk_rows, is also the block's threads): item
// (pass p, chunk k) covers the columns [start of p's colour + k T, ...).
//   * Tickets. A block takes items from an atomic ticket in pass-major
//     order (all of pass 0's chunks, then pass 1's, ...), one ticket ahead,
//     until they run out, so every item it waits on was taken by a block
//     that is running or done: no deadlock, whatever the card holds at
//     once. The grid is at most the blocks the card holds at once
//     (spmx_symgs_prepare) and the items of the step's widest pass (more
//     blocks would only wait). The block that takes the launch's last
//     ticket resets it for the next launch (the self-resetting tickets of
//     segments.h and trisweep.cu).
//   * Order. After its rows' stores and a barrier, one thread adds 1 to its
//     pass's done count with a release. Before the rows of pass p, one
//     thread acquire-waits until pass p - 1's count shows all of that
//     pass's chunks of this launch (which orders every earlier pass too).
//     The row's index, diagonal and band slots are loaded before the wait,
//     so the planes stream while the block waits. The counts only grow:
//     after launch number m a pass of c chunks reads m c (mod 2^32), and m
//     is an epoch kept beside the ticket (state[1]), so neither needs a
//     memset between launches or graph replays.
//   * Reading x. Other blocks write x between the passes of one launch, so
//     x is never read through the read-only path (__ldg), which is not
//     coherent within a kernel. It is read with ordinary loads after the
//     wait: the acquire at GPU scope invalidates the SM's L1 (ld.acquire.gpu
//     compiles to a strong load and CCTL.IVALL on sm_90a), and every block
//     that reads x in pass p has acquired pass p - 1's count since its own
//     last read of an earlier pass, so a line in L1 was fetched after pass
//     p - 1's stores reached L2. That is the PTX memory model's guarantee
//     for weak loads ordered after an acquire by a barrier. Reading x
//     through L2 (__ldcg) instead costs L1's reuse between neighbouring
//     rows: 0.311 against 0.256 ms a 104^3 step in f64 (H100, 700 W). An
//     x index outside [0, n) reads a zero in device memory, not a select on
//     the loaded value, which would hold back the loads after it.
// The state (ticket, epoch, one count a pass) belongs to the plan, which
// the wrapper allocates with it: a step in flight on one plan is one
// caller's, as x is updated in place anyway.
//
// Chunk size T (chunk_rows_of, once a plan in spmx_symgs_prepare, from the
// rows of the largest colour): 64 up to 8,192 rows a colour, else 128.
// Device ms of one f64 step on an H100 at 700 W, T = 64 / 128: 13^3 (274
// rows a colour) 0.0312 / 0.0318; 26^3 (2,197) 0.0326 / 0.0342; 52^3
// (17,576) 0.0438 / 0.0425; 104^3 (140,608) 0.2598 / 0.2466. In a sweep of
// T = 64, 96, 128, 160, 192, 224, 256 on an earlier form of the kernel no
// other T was more than 3 % faster on any level. Small colours want many
// small blocks (a pass is one memory latency), large ones fewer rows a
// block, whose registers leave room for more of them in flight.
//
// Sums in the band order of the plan, in the working type, each product
// and difference rounded as the compiler contracts them (fused
// multiply-adds); the division is IEEE. Each row is one thread's and the
// colours keep their order, so every call gives the same bits, and the
// bits of one launch a pass (spmx_symgs_by_pass, the yardstick).
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

// A 27-point row (HPCG's stencil, every level of its hierarchy) takes an
// unrolled form: a thread first issues all its loads, the 27 band slots and
// the 27 x values, and only then sums, so their latencies overlap. With the
// band loop rolled, each band waited for the last one's loads: a colour pass
// of a coarse level took one thread's chain of 26 memory latencies (7.7 us
// at 13^3 on the H100) and the finest level half the bandwidth. Any other
// band count takes the rolled loop. Both sum in band order.
constexpr int kStencilBands = 27;
constexpr int kMaxPasses = 2 * SPMX_SYMGS_MAX_COLORS;
constexpr int kMaxThreads = 256;

// What a step reads in place of x outside [0, n).
__device__ const double kZero = 0.0;

// One row's operands other than x: its natural index i and, loaded ahead
// by the one-launch step, column k of the re-laid planes.
template <typename V, int NB>
struct Row {
  int64_t i;
  V d;                   // the diagonal
  V a[NB > 0 ? NB : 1];  // the band slots (NB > 0)
};

template <typename V, int NB>
__device__ __forceinline__ void load_row(Row<V, NB>& w, const V* __restrict__ data,
                                         const int32_t* __restrict__ rows, int diag, int64_t n,
                                         int64_t k) {
  w.i = __ldg(rows + k);
  w.d = __ldg(data + (int64_t)diag * n + k);
#pragma unroll
  for (int b = 0; b < NB; ++b) w.a[b] = __ldg(data + (int64_t)b * n + k);
}

// The band offsets through the read-only path (one launch a pass).
struct GlobalOffsets {
  const int32_t* p;
  __device__ __forceinline__ int operator[](int b) const { return __ldg(p + b); }
};

// x[i] = (r[i] - sum_{b != diag} data[b, k] x[i + off[b]]) / data[diag, k],
// in band order: the row body of both forms of the step. kLoaded: the band
// slots and the diagonal come from load_row and x outside [0, n) is read
// from kZero (the one-launch step); else they are loaded here and x outside
// is selected away (one launch a pass). `store` false: nothing is divided or
// written (a thread past the end of its block's item, which runs the body
// with row 0 rather than branch round it: 0.0312 against 0.0347 ms a 13^3
// step, 0.2466 against 0.2506 at 104^3).
template <typename V, int NB, bool kLoaded, typename Offsets>
__device__ __forceinline__ void update_row(const Row<V, NB>& w, const V* __restrict__ data,
                                           Offsets off, int nb, int diag, int64_t n,
                                           int64_t k, const V* __restrict__ r, V* x,
                                           bool store = true) {
  const int64_t i = w.i;
  V acc = __ldg(r + i);
  if (NB > 0) {
    V a[NB > 0 ? NB : 1], xv[NB > 0 ? NB : 1];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int64_t j = i + off[b];
      const bool in = j >= 0 && j < n;
      if (kLoaded) {
        xv[b] = *(in ? x + j : reinterpret_cast<const V*>(&kZero));
        a[b] = w.a[b];
      } else {
        const V v = x[in ? j : 0];
        xv[b] = in ? v : V(0);
        a[b] = __ldg(data + (int64_t)b * n + k);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b != diag) acc -= a[b] * xv[b];
    }
  } else {
    for (int b = 0; b < nb; ++b) {
      if (b == diag) continue;
      const int64_t j = i + off[b];
      const V v = (j >= 0 && j < n) ? x[j] : V(0);
      acc -= __ldg(data + (int64_t)b * n + k) * v;
    }
  }
  if (store) x[i] = acc / (kLoaded ? w.d : __ldg(data + (int64_t)diag * n + k));
}

// One colour pass, one launch: the yardstick of the one-launch step.
template <typename V, int NB>
__global__ void spmx_symgs_color(const V* __restrict__ data, const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ offsets, int nb, int diag,
                                 int64_t n, int64_t lo, int64_t hi, const V* __restrict__ r,
                                 V* x) {
  const int64_t k = lo + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= hi) return;
  Row<V, NB> w;
  w.i = __ldg(rows + k);
  update_row<V, NB, false>(w, data, GlobalOffsets{offsets}, nb, diag, n, k, r, x);
}

// The arguments of one step's launch: the plan's and its pass table.
template <typename V>
struct Step {
  const V* data;
  const int32_t* rows;
  const int32_t* offsets;
  const V* r;
  V* x;
  uint32_t* state;  // [0] the ticket, [1] the epoch, [2 + p] pass p's chunks done, all launches
  int64_t n;
  int32_t nb, diag, chunk_rows, passes, items;
  int32_t first[kMaxPasses + 1];  // pass p's items are [first[p], first[p + 1])
  int32_t col[kMaxPasses];        // its colour's first column
  int32_t end[kMaxPasses];        // past its colour's last column
};

__device__ __forceinline__ unsigned load_acquire(const uint32_t* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(uint32_t* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

template <typename V, int NB>
__global__ void __launch_bounds__(kMaxThreads)
    spmx_symgs_color_step(const __grid_constant__ Step<V> a) {
  extern __shared__ int off[];  // the band offsets
  __shared__ int s_item[2][3];  // items in turn: pass (-1: none left), first and end column
  const int tid = threadIdx.x;
  uint32_t* const state = a.state;
  const unsigned items = (unsigned)a.items;
  const unsigned last = items + gridDim.x - 1u;  // every block takes one ticket past the items
  unsigned mark = 0u;                            // thread 0: the launch's epoch
  int ready = 0, pass = 0;  // thread 0: passes [0, ready) done; the pass of its tickets
  auto publish = [&](unsigned t, int* item) {  // thread 0: ticket t becomes the block's next item
    if (t == last) {  // every ticket of the launch is taken: reset for the next one
      *reinterpret_cast<volatile uint32_t*>(state) = 0u;
      *reinterpret_cast<volatile uint32_t*>(state + 1) = mark;
    }
    if (t >= items) {
      item[0] = -1;
      return;
    }
    while ((int)t >= a.first[pass + 1]) ++pass;
    const int c = a.col[pass] + ((int)t - a.first[pass]) * a.chunk_rows;
    item[0] = pass;
    item[1] = c;
    item[2] = min(c + a.chunk_rows, a.end[pass]);
  };
  for (int b = tid; b < a.nb; b += blockDim.x) off[b] = __ldg(a.offsets + b);
  if (tid == 0) {
    mark = *reinterpret_cast<volatile uint32_t*>(state + 1) + 1u;
    __threadfence();  // the epoch is read before the first ticket is taken
    publish(atomicAdd(state, 1u), s_item[0]);
  }
  __syncthreads();
  for (int cur = 0;; cur ^= 1) {
    const int p = s_item[cur][0];
    if (p < 0) break;
    const int64_t k = s_item[cur][1] + tid;
    const bool live = k < s_item[cur][2];
    Row<V, NB> w;
    w.i = 0;  // a thread with no row reads row 0's neighbours, the item's first column
    if (live) load_row(w, a.data, a.rows, a.diag, a.n, k);
    if (tid == 0 && p > ready) {  // pass p - 1, and with it every earlier pass, done
      const unsigned want = mark * (unsigned)(a.first[p] - a.first[p - 1]);
      while (load_acquire(state + 2 + (p - 1)) != want) __nanosleep(20);
      ready = p;
    }
    __syncthreads();
    const unsigned t = tid == 0 ? atomicAdd(state, 1u) : 0u;  // the next item, over the rows
    update_row<V, NB, true>(w, a.data, off, a.nb, a.diag, a.n, live ? k : s_item[cur][1], a.r,
                            a.x, live);
    if (tid == 0) publish(t, s_item[cur ^ 1]);
    __syncthreads();
    if (tid == 0) add_release(state + 2 + p, 1u);  // after the block's stores of x
  }
}

// The pass table of a step at the plan's chunk size; false if a count
// overflows int32.
template <typename V>
bool pass_table(const SpmxSymgsPlan* p, Step<V>& s) {
  int64_t items = 0;
  s.passes = 0;
  for (int step = 0; step < 2 * p->colors; ++step) {
    const int c = step < p->colors ? step : 2 * p->colors - 1 - step;
    const int64_t lo = p->color_start[c], hi = p->color_start[c + 1];
    if (hi <= lo) continue;
    s.first[s.passes] = (int32_t)items;
    s.col[s.passes] = (int32_t)lo;
    s.end[s.passes] = (int32_t)hi;
    ++s.passes;
    items += (hi - lo + p->chunk_rows - 1) / p->chunk_rows;
    if (items >= (int64_t)1 << 31) return false;
  }
  s.first[s.passes] = (int32_t)items;
  s.items = (int32_t)items;
  return true;
}

template <typename V, int NB>
int step_nb(const SpmxSymgsPlan* p, const V* r, V* x, cudaStream_t s) {
  Step<V> a;
  if (!pass_table(p, a)) return (int)cudaErrorInvalidValue;
  a.data = (const V*)p->data;
  a.rows = p->rows;
  a.offsets = p->offsets;
  a.r = r;
  a.x = x;
  a.state = p->state;
  a.n = p->n;
  a.nb = p->nb;
  a.diag = p->diag;
  a.chunk_rows = p->chunk_rows;
  spmx_symgs_color_step<V, NB>
      <<<(unsigned)p->grid, p->chunk_rows, p->nb * sizeof(int), s>>>(a);
  return (int)cudaGetLastError();
}

template <typename V>
int step(const SpmxSymgsPlan* p, const V* r, V* x, cudaStream_t s) {
  return p->nb == kStencilBands ? step_nb<V, kStencilBands>(p, r, x, s)
                                : step_nb<V, 0>(p, r, x, s);
}

template <typename V>
int step_by_pass(const SpmxSymgsPlan* p, const V* r, V* x, cudaStream_t s) {
  const int threads = 256;
  for (int step = 0; step < 2 * p->colors; ++step) {
    const int c = step < p->colors ? step : 2 * p->colors - 1 - step;
    const int64_t lo = p->color_start[c], hi = p->color_start[c + 1];
    if (hi <= lo) continue;
    const unsigned blocks = (unsigned)((hi - lo + threads - 1) / threads);
    const V* data = (const V*)p->data;
    if (p->nb == kStencilBands) {
      spmx_symgs_color<V, kStencilBands><<<blocks, threads, 0, s>>>(
          data, p->rows, p->offsets, p->nb, p->diag, p->n, lo, hi, r, x);
    } else {
      spmx_symgs_color<V, 0><<<blocks, threads, 0, s>>>(
          data, p->rows, p->offsets, p->nb, p->diag, p->n, lo, hi, r, x);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// the blocks of the plan's step that one SM holds at once
template <typename V>
cudaError_t resident_per_sm(const SpmxSymgsPlan* p, int* per_sm) {
  const size_t smem = p->nb * sizeof(int);
  return p->nb == kStencilBands
             ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, spmx_symgs_color_step<V, kStencilBands>, p->chunk_rows, smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, spmx_symgs_color_step<V, 0>, p->chunk_rows, smem);
}

bool valid_shape(const SpmxSymgsPlan* p) {
  return p->colors >= 1 && p->colors <= SPMX_SYMGS_MAX_COLORS && p->nb >= 1 &&
         p->nb <= 12 * 1024;
}

bool valid_plan(const SpmxSymgsPlan* p) {
  return valid_shape(p) && p->chunk_rows >= 32 && p->chunk_rows <= kMaxThreads &&
         p->chunk_rows % 32 == 0 && p->grid >= 1 && p->state != nullptr;
}

// T: the rows of a work item and the threads of a block (the note above)
int32_t chunk_rows_of(const SpmxSymgsPlan* p) {
  int64_t widest = 0;
  for (int c = 0; c < p->colors; ++c) {
    const int64_t rows = p->color_start[c + 1] - p->color_start[c];
    if (rows > widest) widest = rows;
  }
  return widest <= 8192 ? 64 : 128;
}

}  // namespace

SPMX_API int spmx_symgs_max_colors(void) { return SPMX_SYMGS_MAX_COLORS; }

SPMX_API int spmx_symgs_prepare(SpmxSymgsPlan* plan) {
  if (!valid_shape(plan)) return (int)cudaErrorInvalidValue;
  plan->chunk_rows = chunk_rows_of(plan);
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, plan->device);
  if (err != cudaSuccess) return (int)err;
  err = plan->values_f64 ? resident_per_sm<double>(plan, &per_sm)
                         : resident_per_sm<float>(plan, &per_sm);
  if (err != cudaSuccess) return (int)err;
  Step<float> table;
  if (!pass_table(plan, table)) return (int)cudaErrorInvalidValue;
  int64_t b = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  int widest = 1;
  for (int q = 0; q < table.passes; ++q) widest = max(widest, table.first[q + 1] - table.first[q]);
  if (widest < b) b = widest;
  plan->grid = (int32_t)b;
  return 0;
}

SPMX_API int spmx_symgs(const SpmxSymgsPlan* plan, const void* r, void* x, void* stream) {
  if (!valid_plan(plan)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan->values_f64) return step<double>(plan, (const double*)r, (double*)x, s);
  return step<float>(plan, (const float*)r, (float*)x, s);
}

SPMX_API int spmx_symgs_by_pass(const SpmxSymgsPlan* plan, const void* r, void* x,
                                void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan->values_f64) return step_by_pass<double>(plan, (const double*)r, (double*)x, s);
  return step_by_pass<float>(plan, (const float*)r, (float*)x, s);
}
