// Multicolour symmetric Gauss-Seidel over DIA band planes: one SymGS step
// toward A x = r, x updated in place.
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
// order of the rows. One launch is one colour pass, so a step is 2 C
// launches, enqueued in order on one stream.
//
// Bound on the H100: device-memory bandwidth. A sweep direction must read
// every band slot once (8 bytes in f64, 4 in f32), r once, and read and
// write x once. Layout: colour-blocked rows. The wrapper re-lays the planes
// so that the rows of one colour lie together, in natural order within the
// colour (`data` column k holds the bands of row rows[k]), and one thread
// takes one row. A warp then reads each plane as one coalesced line and a
// sweep direction streams every plane slot exactly once. The natural-order
// planes with a mask would leave 7 of 8 threads of a warp idle and read
// every plane line in 2 of the 8 passes, twice the traffic. r and x keep
// the natural order, so their reads are strided by the colouring; with x
// (9 MB at 104^3 in f64) and a pass's share of r in the 50 MB L2 they come
// mostly from there.
//
// Sums in the band order of the plan, in the working type, each product
// and difference rounded as the compiler contracts them (fused
// multiply-adds); the division is IEEE. Each row is one thread's, so every
// call gives the same bits.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

// A 27-point row (HPCG's stencil, every level of its hierarchy) takes an
// unrolled form: a thread first issues all its loads, the 27 band slots and
// the 27 x values (an x index outside [0, n) reads a clamped one, then
// counts 0), and only then sums, so their latencies overlap. With the band
// loop rolled, each band waited for the last one's loads: a colour pass of
// a coarse level took one thread's chain of 26 memory latencies (7.7 us at
// 13^3 on the H100) and the finest level half the bandwidth. Any other band
// count takes the rolled loop. Both sum in band order.
constexpr int kStencilBands = 27;

template <typename V, int NB>
__global__ void spmx_symgs_color(const V* __restrict__ data,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ offsets, int nb,
                                 int diag, int64_t n, int64_t lo, int64_t hi,
                                 const V* __restrict__ r, V* x) {
  const int64_t k = lo + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (k >= hi) return;
  const int64_t i = __ldg(rows + k);
  V acc = __ldg(r + i);
  // x is written by this launch (its own colour's rows, never a row read
  // here), so it is read through the ordinary path, not the read-only cache
  if (NB > 0) {
    V a[NB > 0 ? NB : 1], xv[NB > 0 ? NB : 1];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int64_t j = i + __ldg(offsets + b);
      const bool in = j >= 0 && j < n;
      const V v = x[in ? j : 0];
      xv[b] = in ? v : V(0);
      a[b] = __ldg(data + (int64_t)b * n + k);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b != diag) acc -= a[b] * xv[b];
    }
  } else {
    for (int b = 0; b < nb; ++b) {
      if (b == diag) continue;
      const int64_t j = i + __ldg(offsets + b);
      const V v = (j >= 0 && j < n) ? x[j] : V(0);
      acc -= __ldg(data + (int64_t)b * n + k) * v;
    }
  }
  x[i] = acc / __ldg(data + (int64_t)diag * n + k);
}

template <typename V>
int symgs_step(const SpmxSymgsPlan* p, const V* r, V* x, cudaStream_t s) {
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

}  // namespace

SPMX_API int spmx_symgs_max_colors(void) { return SPMX_SYMGS_MAX_COLORS; }

SPMX_API int spmx_symgs(const SpmxSymgsPlan* plan, const void* r, void* x, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan->values_f64) return symgs_step<double>(plan, (const double*)r, (double*)x, s);
  return symgs_step<float>(plan, (const float*)r, (float*)x, s);
}
