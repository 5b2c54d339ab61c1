// The vector work of a CG or PCG iteration (sparse_matrix_tpu_torch/solvers/
// cg.py, _cg_step and _pcg_step on a CUDA vector) in three fused passes:
//
//   krylov_dot  out = u . v
//   cg_update   alpha = num / den; x += alpha p; r -= alpha Ap; rr = r . r
//   p_update    beta = num / den; p = z + beta p       (CG: z is r)
//
// Replaces: no TPU kernel. The JAX package's solvers run the recurrences in
// a lax.while_loop, whose updates and dots XLA fuses by itself; PyTorch
// runs each as its own kernel (about nine a CG iteration, with alpha and
// beta as 0-d tensors broadcast by an unvectorised elementwise kernel).
//
// Bound on the H100: device-memory bandwidth. cg_update reads x, r, p and
// Ap and writes x and r, p_update reads z and p and writes p, a dot reads
// its two vectors: each once. Each thread walks the vectors in 16-byte
// pieces (float4, double2) with a grid-stride loop over a grid that the
// card holds at once (spmx_krylov_blocks), so every load is a full
// coalesced line and the pass ends in one wave. alpha and beta are read
// from 0-d device scalars by every thread: the host never reads them and
// nothing is broadcast. A pointer off 16 bytes takes the same loop one
// element at a time.
//
// Inner products: each block sums its threads' sums in a fixed tree, writes
// its partial to scratch and takes an atomic ticket; the last block sums
// the partials in block order, writes the 0-d result and resets the ticket
// (the pattern of segments.h). No float atomics: for a given n and card the
// grid and every order are fixed, so each call gives the same bits.
//
// Rounding: the products and sums of the updates and of each thread's dot
// are fused multiply-adds, where PyTorch's eager form rounded the product
// and the sum apart; the divisions are IEEE. Working type throughout (f32
// or f64), as the eager form.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the 16-byte piece of a vector of V
template <typename V>
struct Piece;
template <>
struct Piece<float> {
  using type = float4;
  static constexpr int kLanes = 4;
};
template <>
struct Piece<double> {
  using type = double2;
  static constexpr int kLanes = 2;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// element k of a piece held in registers (k a constant after unrolling)
template <typename V, typename P>
__device__ __forceinline__ V& lane(P& piece, int k) {
  return reinterpret_cast<V*>(&piece)[k];
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
  // a butterfly: lanes i and i ^ o add the same two values, so every lane
  // ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of every thread's v in a fixed order, valid in thread 0; every
// thread of the block calls this
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* shared) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  if (ln == 0) shared[warp] = v;
  __syncthreads();
  V t = V(0);
  if (warp == 0) t = warp_sum(ln < kWarps ? shared[ln] : V(0));
  return t;
}

// The grid's sum of every thread's v into *out: each block's partial goes
// to partials[blockIdx.x], and the last block to take the ticket adds the
// partials in block order, writes *out and resets the ticket to 0 for the
// next launch. Every thread of every block calls this once.
template <typename V>
__device__ __forceinline__ void grid_sum(V v, V* partials, int32_t* ticket, V* out) {
  __shared__ V shared[kWarps];
  __shared__ bool last;
  const V s = block_sum(v, shared);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  V t = V(0);
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) t += __ldcg(partials + i);
  // warp 0 read `shared` before the barrier above, so it may be rewritten
  const V total = block_sum(t, shared);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    krylov_dot_kernel(const V* __restrict__ u, const V* __restrict__ v, int64_t n, int vec,
                      V* partials, int32_t* ticket, V* out) {
  using P = typename Piece<V>::type;
  constexpr int L = Piece<V>::kLanes;
  const int64_t t0 = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  V acc = V(0);
  int64_t done = 0;
  if (vec) {
    const P* u4 = reinterpret_cast<const P*>(u);
    const P* v4 = reinterpret_cast<const P*>(v);
    const int64_t pieces = n / L;
    for (int64_t i = t0; i < pieces; i += stride) {
      P a = __ldg(u4 + i), b = __ldg(v4 + i);
#pragma unroll
      for (int k = 0; k < L; ++k) acc = fma_rn(lane<V>(a, k), lane<V>(b, k), acc);
    }
    done = pieces * L;
  }
  for (int64_t i = done + t0; i < n; i += stride) acc = fma_rn(__ldg(u + i), __ldg(v + i), acc);
  grid_sum(acc, partials, ticket, out);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(V* __restrict__ x, V* __restrict__ r, const V* __restrict__ p,
                     const V* __restrict__ ap, int64_t n, int vec, const V* num, const V* den,
                     V* partials, int32_t* ticket, V* rr) {
  using P = typename Piece<V>::type;
  constexpr int L = Piece<V>::kLanes;
  const V alpha = *num / *den;
  const int64_t t0 = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  V acc = V(0);
  int64_t done = 0;
  if (vec) {
    P* x4 = reinterpret_cast<P*>(x);
    P* r4 = reinterpret_cast<P*>(r);
    const P* p4 = reinterpret_cast<const P*>(p);
    const P* a4 = reinterpret_cast<const P*>(ap);
    const int64_t pieces = n / L;
    for (int64_t i = t0; i < pieces; i += stride) {
      P xv = x4[i], rv = r4[i];
      P pv = __ldg(p4 + i), av = __ldg(a4 + i);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        lane<V>(xv, k) = fma_rn(alpha, lane<V>(pv, k), lane<V>(xv, k));
        lane<V>(rv, k) = fma_rn(-alpha, lane<V>(av, k), lane<V>(rv, k));
        acc = fma_rn(lane<V>(rv, k), lane<V>(rv, k), acc);
      }
      x4[i] = xv;
      r4[i] = rv;
    }
    done = pieces * L;
  }
  for (int64_t i = done + t0; i < n; i += stride) {
    x[i] = fma_rn(alpha, __ldg(p + i), x[i]);
    const V ri = fma_rn(-alpha, __ldg(ap + i), r[i]);
    r[i] = ri;
    acc = fma_rn(ri, ri, acc);
  }
  grid_sum(acc, partials, ticket, rr);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    p_update_kernel(V* __restrict__ p, const V* __restrict__ z, int64_t n, int vec,
                    const V* num, const V* den) {
  using P = typename Piece<V>::type;
  constexpr int L = Piece<V>::kLanes;
  const V beta = *num / *den;
  const int64_t t0 = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t done = 0;
  if (vec) {
    P* p4 = reinterpret_cast<P*>(p);
    const P* z4 = reinterpret_cast<const P*>(z);
    const int64_t pieces = n / L;
    for (int64_t i = t0; i < pieces; i += stride) {
      P pv = p4[i], zv = __ldg(z4 + i);
#pragma unroll
      for (int k = 0; k < L; ++k) lane<V>(pv, k) = fma_rn(beta, lane<V>(pv, k), lane<V>(zv, k));
      p4[i] = pv;
    }
    done = pieces * L;
  }
  for (int64_t i = done + t0; i < n; i += stride) p[i] = fma_rn(beta, p[i], __ldg(z + i));
}

// the blocks of each kernel that one SM holds at once, the least of the three
template <typename V>
int resident_blocks(int* blocks) {
  int a = 0, b = 0, c = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, krylov_dot_kernel<V>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, cg_update_kernel<V>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c, p_update_kernel<V>, kThreads, 0);
  *blocks = a < b ? (a < c ? a : c) : (b < c ? b : c);
  return (int)err;
}

template <typename V>
int dot(const SpmxKrylovPlan* k, const void* u, const void* v, int vec, void* out,
        cudaStream_t s) {
  krylov_dot_kernel<V><<<k->blocks, kThreads, 0, s>>>(
      (const V*)u, (const V*)v, k->n, vec, (V*)k->partials, k->ticket, (V*)out);
  return (int)cudaGetLastError();
}

template <typename V>
int cg_update(const SpmxKrylovPlan* k, void* x, void* r, const void* p, const void* ap,
              int vec, const void* num, const void* den, void* rr, cudaStream_t s) {
  cg_update_kernel<V><<<k->blocks, kThreads, 0, s>>>(
      (V*)x, (V*)r, (const V*)p, (const V*)ap, k->n, vec, (const V*)num, (const V*)den,
      (V*)k->partials, k->ticket, (V*)rr);
  return (int)cudaGetLastError();
}

template <typename V>
int p_update(const SpmxKrylovPlan* k, void* p, const void* z, int vec, const void* num,
             const void* den, cudaStream_t s) {
  p_update_kernel<V><<<k->blocks, kThreads, 0, s>>>((V*)p, (const V*)z, k->n, vec,
                                                     (const V*)num, (const V*)den);
  return (int)cudaGetLastError();
}

}  // namespace

SPMX_API int spmx_krylov_blocks(int device, int values_f64, int64_t n, int32_t* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int code = values_f64 ? resident_blocks<double>(&per_sm) : resident_blocks<float>(&per_sm);
  if (code != 0) return code;
  const int64_t piece = (int64_t)kThreads * (values_f64 ? 2 : 4);
  const int64_t want = (n + piece - 1) / piece;
  int64_t b = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (want < b) b = want;
  *blocks = (int32_t)(b > 0 ? b : 1);
  return 0;
}

SPMX_API int spmx_krylov_dot(const SpmxKrylovPlan* plan, const void* u, const void* v, int vec,
                             void* out, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan->values_f64) return dot<double>(plan, u, v, vec, out, s);
  return dot<float>(plan, u, v, vec, out, s);
}

SPMX_API int spmx_cg_update(const SpmxKrylovPlan* plan, void* x, void* r, const void* p,
                            const void* ap, int vec, const void* num, const void* den, void* rr,
                            void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan->values_f64) return cg_update<double>(plan, x, r, p, ap, vec, num, den, rr, s);
  return cg_update<float>(plan, x, r, p, ap, vec, num, den, rr, s);
}

SPMX_API int spmx_p_update(const SpmxKrylovPlan* plan, void* p, const void* z, int vec,
                           const void* num, const void* den, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan->values_f64) return p_update<double>(plan, p, z, vec, num, den, s);
  return p_update<float>(plan, p, z, vec, num, den, s);
}
