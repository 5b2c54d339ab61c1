// Fused banded triangular Jacobi sweeps. With T = D + N, N strictly
// triangular in DIA form (data (nb, rows), offsets all of one sign) and
// dinv = 1 / diag(T):
//   x_0 = dinv * b,  x_{k+1} = dinv * (b - N x_k)  for k < sweeps,
// y = x_sweeps, every sweep in one ordinary launch.
//
// Replaces: sparse_matrix_tpu/ops/trisweep.py, _make_trisweep_kernel (called
// by _trisweep_call).
//
// Bound on the H100: device-memory bandwidth. The compulsory traffic is the
// band planes, b and dinv read once and y written once ((nb + 3) * rows * 4
// bytes: 84 MB for Poisson 2048^2's IC(0) L, nb = 2, 4.19M rows); a sweep
// does 2 * nb + 2 flops a row, far below the f32 peak.
//
// Design. N's offsets all have one sign, so row i of level k + 1 needs level
// k only at rows at most w = max|offset| before it (negative offsets: L) or
// after it (positive: L^T, U). The rows are cut into chunks of T rows (a
// power of two); one thread block owns one chunk for every level:
//   * Tickets. A block takes the next chunk in dependency order from an
//     atomic ticket (ascending chunks for negative offsets, descending for
//     positive ones), so every chunk it waits on was taken by a block that
//     is running or done: no deadlock, no co-residency cap, no grid-wide
//     barrier. The last block to take a ticket resets it for the next
//     launch (the self-resetting tickets of segments.h).
//   * Data read once. The block copies its chunk's b and dinv, then its
//     band planes, into shared memory with 4-byte cp.async copies, all in
//     flight at once (x_0 = dinv * b is computed while the planes land),
//     and reads them from there in every sweep: device memory sees each
//     byte once per solve. Levels x_k and x_{k+1} of the chunk live in
//     shared memory too: each thread computes its rows' new values from
//     x_k into x_{k+1}, the block synchronises, and the two swap. x is never
//     updated in place within a level: that would be Gauss-Seidel-like
//     chaotic relaxation, not Jacobi, and would break the polynomial
//     identity that makes IC's M^-1 = S^T S symmetric.
//   * Hand-off. After each level k < sweeps a chunk that has a consumer
//     publishes the min(w, T) rows of that level its neighbours read (its
//     last rows for L, its first for U) into its (chunk, level) slot of the
//     plan's scratch; after a barrier one thread release-stores the
//     launch's mark into the slot's flag. Before the rows of level k + 1
//     that read a neighbour, one thread acquire-waits on the flags of the
//     ceil(w / T) chunks it reads, and the block stages their w rows into
//     shared memory with __ldcg (from L2), four loads in flight a thread
//     (a reach past 8192 rows is read from the slots in place instead).
//     The rows that read no neighbour are computed first, and when the
//     published rows are among them (T >= 2w) they are published before
//     the wait, so the hand-off's latency overlaps them. The mark is a
//     per-launch epoch kept beside the ticket (state[1]), so the flags
//     need no memset: the flags and scratch belong to the plan, sized for
//     the largest sweep count it was called with.
//   * Summation order. Bands are summed in plan order with __fmul_rn /
//     __fadd_rn, then __fsub_rn and __fmul_rn: no contraction into FMA, so
//     the result equals the plain version (ops/trisweep.py::_trisweep_torch)
//     bit for bit, whatever T and whatever order the chunks finish in. Up to
//     12 bands the band loop is unrolled, its offsets in registers and its
//     x reads issued before the sums.
// Chunk size (ops/trisweep.py::trisweep_chunk_rows): the largest power of
// two whose shared memory (the offsets; a row the planes, b, dinv and two
// levels; the w staged rows) fits 113 KB, so that two blocks of 512
// threads share an SM: Poisson 2048^2 (nb = 2, w = 2048) T = 4096, 104 KB,
// a 2048-row slot a level (the slots add sweeps * w * rows / T * 4 bytes
// of L2 traffic each way); femlike_262k's ILU(0) L and U (nb = 10, w =
// 515) T = 1024, 58 KB. On the H100 (PERF.md section 6) T = 4096 beat 2048
// and 1024 on Poisson 2048^2 and matched 8192.
// The TPU kernel kept x in VMEM through all sweeps of a one-step grid; at
// Poisson 2048^2 x alone is 16.8 MB, more than the shared memory of the card.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ unsigned load_acquire(const uint32_t* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The chunk's view of level k: its own rows (local index 0 .. n - 1) from
// shared memory and, outside them, its neighbours' published rows, staged
// in shared memory (`hb`, the reach's rows next to the chunk, zeros outside
// [0, rows)) or, where they would not fit (kStaged false), read from their
// slots in L2.
template <bool kStaged>
struct Level {
  const SpmxTrisweepPlan& p;
  const float* cur;  // x_k of the chunk's rows
  const float* hb;   // staged neighbour rows: lower [c0 - reach, c0), upper [c0 + n, ...)
  int64_t c0;
  int n;
  int k;

  __device__ __forceinline__ float slot_row(int64_t j) const {  // row j of level k, from L2
    if (j < 0 || j >= p.rows) return 0.0f;
    const int64_t cc = j >> p.chunk_shift;
    const int64_t pos = p.upper ? j - cc * p.chunk_rows
                                : j - (cc * p.chunk_rows + p.chunk_rows - p.tail);
    return __ldcg(p.scratch + (cc * p.levels + k) * p.tail + pos);
  }

  template <bool kInterior>
  __device__ __forceinline__ float operator()(int jl) const {
    if (kInterior || (unsigned)jl < (unsigned)n) return cur[jl];
    if constexpr (kStaged) return hb[p.upper ? jl - n : jl + p.reach];
    return slot_row(c0 + jl);
  }
};

// x_{k+1} of local row r: the bands in plan order, each product and sum
// rounded on its own, then the difference and the scaling. kNb > 0: that
// many bands, their offsets in registers; 0: p.nb bands, offsets in shared
// memory.
template <int kNb, bool kInterior, bool kStaged>
__device__ __forceinline__ float sweep_row(const Level<kStaged>& lv, const int* off,
                                           const int (&reg_off)[kNb > 0 ? kNb : 1],
                                           const float* planes, const float* bv,
                                           const float* dv, int T, int nb, int r) {
  float acc = 0.0f;
  if constexpr (kNb > 0) {
    float xv[kNb];
#pragma unroll
    for (int bnd = 0; bnd < kNb; ++bnd) xv[bnd] = lv.template operator()<kInterior>(r + reg_off[bnd]);
#pragma unroll
    for (int bnd = 0; bnd < kNb; ++bnd)
      acc = __fadd_rn(acc, __fmul_rn(planes[bnd * T + r], xv[bnd]));
  } else {
    for (int bnd = 0; bnd < nb; ++bnd)
      acc = __fadd_rn(acc, __fmul_rn(planes[bnd * T + r],
                                     lv.template operator()<kInterior>(r + off[bnd])));
  }
  return __fmul_rn(dv[r], __fsub_rn(bv[r], acc));
}

template <int kNb, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
trisweep_kernel(const SpmxTrisweepPlan p, const float* __restrict__ b,
                const float* __restrict__ dinv, int sweeps, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned s_ticket, s_mark;
  const int T = p.chunk_rows, nb = kNb > 0 ? kNb : p.nb;
  int* off = reinterpret_cast<int*>(smem4);                          // (nb,), padded to 4
  float* planes = reinterpret_cast<float*>(off + ((nb + 3) & ~3));  // (nb, T)
  float* bv = planes + (int64_t)nb * T;
  float* dv = bv + T;
  float* cur = dv + T;   // x_k
  float* nxt = cur + T;  // x_{k+1}
  float* hb = nxt + T;   // kStaged: the neighbours' rows of level k, p.reach of them
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t* state = p.state;
  if (tid == 0) {
    const unsigned e = *reinterpret_cast<volatile uint32_t*>(state + 1);
    __threadfence();  // the epoch is read before the ticket is taken
    const unsigned t = atomicAdd(state, 1u);
    const unsigned mark = e + 1u == 0u ? 1u : e + 1u;
    if (t == gridDim.x - 1) {  // every block has read the epoch: reset for the next launch
      *reinterpret_cast<volatile uint32_t*>(state) = 0u;
      *reinterpret_cast<volatile uint32_t*>(state + 1) = mark;
    }
    s_ticket = t;
    s_mark = mark;
  }
  const int64_t rows = p.rows;
  for (int bnd = tid; bnd < nb; bnd += nt) off[bnd] = __ldg(p.offsets + bnd);
  __syncthreads();
  int reg_off[kNb > 0 ? kNb : 1];
#pragma unroll
  for (int bnd = 0; bnd < (kNb > 0 ? kNb : 1); ++bnd) reg_off[bnd] = kNb > 0 ? off[bnd] : 0;
  const int64_t c = p.upper ? p.chunks - 1 - (int64_t)s_ticket : (int64_t)s_ticket;
  const unsigned mark = s_mark;
  const int64_t c0 = c * T;
  const int n = (int)min((int64_t)T, rows - c0);

  // b and dinv first (one commit group), then the planes: x_0 needs only
  // the first
  for (int r = tid; r < n; r += nt) {
    copy4(bv + r, b + c0 + r);
    copy4(dv + r, dinv + c0 + r);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int bnd = 0; bnd < nb; ++bnd) {
    const float* src = p.data + (int64_t)bnd * rows + c0;
    for (int r = tid; r < n; r += nt) copy4(planes + bnd * T + r, src + r);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // The rows this chunk publishes, local [pub_lo, pub_hi), and the rows
  // that read a neighbour's (lower: [0, w), upper: [n - w, n)); the others
  // are computed first, and the published rows, where all of them are
  // among those, are published before the block waits for its neighbours.
  const int tail = p.tail;
  const int reach = (int)p.reach;
  const int w = min(n, reach);
  const bool publish = tail > 0 && (p.upper ? c > 0 : c < p.chunks - 1);
  const int pub_lo = p.upper ? 0 : T - tail;
  const int pub_hi = p.upper ? min(tail, n) : T;
  const int in_lo = p.upper ? 0 : w, in_hi = p.upper ? n - w : n;  // rows of no neighbour
  const int ha_lo = p.upper ? n - w : 0, ha_hi = p.upper ? n : w;  // rows that read one
  const bool early = pub_lo >= in_lo && pub_hi <= in_hi;
  int64_t first = c + 1, last = c;  // the chunks whose slots it reads
  if (tail > 0) {
    if (p.upper) {
      last = min(p.chunks - 1, (c0 + n - 1 + p.reach) >> p.chunk_shift);
    } else {
      first = c0 > p.reach ? (c0 - p.reach) >> p.chunk_shift : 0;
      last = c - 1;
    }
  }
  const int64_t levels = p.levels;
  float* const own_slot = p.scratch + c * levels * tail - pub_lo;  // + k * tail + r
  auto flag = [&](int k) {  // after a barrier: this chunk's rows of level k are in its slot
    if (tid == 0) store_release(p.flags + c * levels + k, mark);
  };

  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  for (int r = tid; r < n; r += nt) {
    const float x0 = __fmul_rn(dv[r], bv[r]);
    cur[r] = x0;
    if (publish && sweeps > 0 && r >= pub_lo && r < pub_hi) __stcg(own_slot + r, x0);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (publish && sweeps > 0) flag(0);

  for (int k = 0; k < sweeps; ++k) {
    const bool pub = publish && k + 1 < sweeps;
    float* slot = own_slot + (k + 1) * tail;
    const Level<kStaged> lv{p, cur, hb, c0, n, k};
    for (int r = in_lo + tid; r < in_hi; r += nt) {
      const float xn = sweep_row<kNb, true>(lv, off, reg_off, planes, bv, dv, T, nb, r);
      nxt[r] = xn;
      if (pub && r >= pub_lo && r < pub_hi) __stcg(slot + r, xn);
    }
    if (first <= last || (pub && early)) {
      __syncthreads();
      if (pub && early) flag(k + 1);
      if (tid == 0) {
        for (int64_t cc = first; cc <= last; ++cc) {
          const uint32_t* f = p.flags + cc * levels + k;
          while (load_acquire(f) != mark) __nanosleep(32);
        }
      }
      __syncthreads();
    }
    if constexpr (kStaged) {
      // the neighbours' rows of level k into hb, four loads in flight a thread
      const int64_t h0 = p.upper ? c0 + n : c0 - reach;
      for (int i0 = tid; i0 < reach; i0 += 4 * nt) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * nt;
          v[u] = i < reach ? lv.slot_row(h0 + i) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * nt < reach) hb[i0 + u * nt] = v[u];
      }
      __syncthreads();
    }
    for (int r = ha_lo + tid; r < ha_hi; r += nt) {
      const float xn = sweep_row<kNb, false>(lv, off, reg_off, planes, bv, dv, T, nb, r);
      nxt[r] = xn;
      if (pub && r >= pub_lo && r < pub_hi) __stcg(slot + r, xn);
    }
    __syncthreads();
    if (pub && !early) flag(k + 1);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int r = tid; r < n; r += nt) y[c0 + r] = cur[r];
}

template <int kNb, bool kStaged>
cudaError_t launch(const SpmxTrisweepPlan& plan, const float* b, const float* dinv, int sweeps,
                   float* y, size_t smem, cudaStream_t stream) {
  static size_t smem_set[kMaxDevices];
  if (smem > 48 * 1024 && smem > smem_set[plan.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        trisweep_kernel<kNb, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[plan.device] = smem;
  }
  const int threads = plan.chunk_rows < kThreads ? plan.chunk_rows : kThreads;
  trisweep_kernel<kNb, kStaged><<<(unsigned)plan.chunks, threads, smem, stream>>>(
      plan, b, dinv, sweeps, y);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t launch_nb(const SpmxTrisweepPlan& plan, const float* b, const float* dinv,
                      int sweeps, float* y, size_t smem, cudaStream_t s) {
  switch (plan.nb) {
#define SPMX_TRISWEEP_NB(N) \
  case N:                   \
    return launch<N, kStaged>(plan, b, dinv, sweeps, y, smem, s);
    SPMX_TRISWEEP_NB(1)
    SPMX_TRISWEEP_NB(2)
    SPMX_TRISWEEP_NB(3)
    SPMX_TRISWEEP_NB(4)
    SPMX_TRISWEEP_NB(5)
    SPMX_TRISWEEP_NB(6)
    SPMX_TRISWEEP_NB(7)
    SPMX_TRISWEEP_NB(8)
    SPMX_TRISWEEP_NB(9)
    SPMX_TRISWEEP_NB(10)
    SPMX_TRISWEEP_NB(11)
    SPMX_TRISWEEP_NB(12)
#undef SPMX_TRISWEEP_NB
    default:
      return launch<0, kStaged>(plan, b, dinv, sweeps, y, smem, s);
  }
}

}  // namespace

SPMX_API int spmx_trisweep_threads(void) { return kThreads; }

SPMX_API int spmx_trisweep(const SpmxTrisweepPlan* plan, const float* b, const float* dinv,
                           int sweeps, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  const int T = plan->chunk_rows;
  if (sweeps < 0 || T < 32 || (T & (T - 1)) != 0 || (1 << plan->chunk_shift) != T ||
      plan->chunks != (plan->rows + T - 1) / T ||
      (plan->tail > 0 && plan->chunks > 1 && sweeps > plan->levels) ||
      (plan->halo != 0 && plan->halo != plan->reach))
    return (int)cudaErrorInvalidValue;
  if (plan->device < 0 || plan->device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (plan->rows == 0) return 0;
  const size_t smem = (size_t)(plan->nb + 4) * T * sizeof(float) +
                      (size_t)((plan->nb + 3) & ~3) * sizeof(int) +
                      (size_t)plan->halo * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(plan->halo ? launch_nb<true>(*plan, b, dinv, sweeps, y, smem, s)
                          : launch_nb<false>(*plan, b, dinv, sweeps, y, smem, s));
}
