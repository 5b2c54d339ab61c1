// Stripe SpMV: multi-level destinations. A slab is 8 chunks of one stripe
// (L row blocks); per chunk c of slab s:
//   p[t]  = vals[c, t] * x[col_off[c]*128 + lane[c, t]]   (x past cols reads 0)
//   scan:   g[l, d] = incl[ends[s, l, c%8, d]]
//                     - (starts[s, l, c%8, d] < 0 ? 0 : incl[starts[s, l, c%8, d]])
//   select: g[l, d] = p[ends[s, l, c%8, d]]                (slot 0 is a zero)
//   y[(stripe_rb[s] + l)*128 + d] = sum over the stripe's chunks of g[l, d]
// with rows of masked row blocks (rb_mask) 0.
//
// Replaces: sparse_matrix_tpu/ops/spmv.py, _make_stripe_kernel (called by
// _spmv_stripe_jit).
//
// Bound on the H100: device-memory bandwidth. A slot streams 4 bytes of
// value and 1 or 2 of lane; each (slot, level) 1 byte of ends and, in scan
// mode, 1 of starts; the x windows (kw_g*128 floats a chunk) come mostly
// from L1 and L2.
//
// Design: the host cuts each stripe's slabs into segments of at most G
// consecutive slabs (ops/spmv.py::stripe_segments); one thread block of
// eight warps owns a segment (segments.h) and up to eight of its levels
// (blockIdx.y takes the next eight where L > 8). Each slab's values,
// lanes, ends, starts, window bases and chunk stripes reach shared memory
// through a ring of kRing stages of 16-byte cp.async copies, so the next
// slab loads while this one is scanned. Warp w multiplies chunk w (thread
// t slots 4t .. 4t+3) and, in scan mode, replaces the products by their
// inclusive prefix sum (a scan inside the thread, then a warp-shuffle scan
// of the thread totals), in fp32 on the CUDA cores: the TPU kernel's
// triangular HIGHEST-precision matmul has no counterpart, so no TF32
// rounding can enter. After a block barrier thread i owns the V
// consecutive (level, lane) pairs from i*V on (V = 1, 2 or 4 by L), reads
// their ends and starts as one V-byte load a chunk and adds the 8 chunks'
// gathers to V f32 sums in registers, which stay there across the
// segment's slabs. The sums reach y through the segment's single writer:
// no atomics on y, no zeroing of y, the same bits on every call. That
// replaces the TPU kernel's stacked (L, 128) tile added into a
// VMEM-resident y, whose sequential grid carried the sums. On the H100 it
// stays well short of the device-memory rate: its x gathers add to the
// slab copies instead of hiding under them, and deeper rings, one barrier
// a slab, a warp a chunk column and other pair widths ran no faster
// (PERF.md §6).
//
// Non-finite x: every pair of every chunk adds its gather, a run or not
// (incl[0] - incl[0], or p[0]), as the plain version and the JAX package
// do, so the NaN and inf rows are theirs. A slab's padding chunks (the
// tail of a stripe's last slab, chunk_stripe 0) add nothing to the slab's
// stripe; the plain version scatters their 0 * x[0] into stripe 0, which
// the writer of stripe 0 adds once when the plan has such chunks
// (foreign_pad).
#include <cuda_runtime.h>

#include "block_tile.h"
#include "segments.h"
#include "spmx_cuda.h"

namespace {

constexpr int kChunks = 8;  // chunks a slab, one warp each
constexpr int kThreads = 32 * kChunks;
constexpr int kGroupLevels = 8;  // levels a thread block owns
constexpr int kRing = 2;         // slab stages in flight

// byte offsets of one slab's stage: vals (8, 128) f32 at 0, lanes (8, 128),
// ends (lg, 8, 128), starts (lg, 8, 128) in scan mode, col_off (8,),
// chunk_stripe (8,); lg = min(L, kGroupLevels)
struct Layout {
  int lane, ends, starts, col_off, chunk_stripe, bytes;
};

__host__ __device__ inline Layout layout(int lane_bytes, int lg, bool scan) {
  Layout s;
  s.lane = 4096;
  s.ends = s.lane + 1024 * lane_bytes;
  s.starts = s.ends + 1024 * lg;
  s.col_off = s.starts + (scan ? 1024 * lg : 0);
  s.chunk_stripe = s.col_off + 32;
  s.bytes = s.chunk_stripe + 32;
  return s;
}

// slots 4t .. 4t+3 of a staged chunk's lanes
__device__ __forceinline__ int4 lanes4(const int8_t* l, int t) {
  const char4 v = reinterpret_cast<const char4*>(l)[t];
  return make_int4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ int4 lanes4(const int16_t* l, int t) {
  const short4 v = reinterpret_cast<const short4*>(l)[t];
  return make_int4(v.x, v.y, v.z, v.w);
}

// V consecutive int8 values
template <int V>
__device__ __forceinline__ void bytes_v(const int8_t* p, int (&v)[V]) {
  if constexpr (V == 4) {
    const char4 w = *reinterpret_cast<const char4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (V == 2) {
    const char2 w = *reinterpret_cast<const char2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ float xat(const float* __restrict__ x, int64_t j, int64_t cols) {
  return j < cols ? __ldg(x + j) : 0.f;
}

template <typename LaneT, bool kScan, int V>
__global__ void __launch_bounds__(kThreads)
stripe_kernel(const SpmxStripePlan p, const float* __restrict__ x, float* __restrict__ y,
              int add) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float prefix[kChunks][128];
  __shared__ int ticket_cell;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int t = tid & 31;
  const int64_t sidx = blockIdx.x;
  const int gy = blockIdx.y;
  const spmx::Segment seg = spmx::load_segment(p.segments, sidx);
  const int stripe = seg.rb;
  const int n = seg.count;
  const int lvls = p.levels;
  const int lg = min(lvls - gy * kGroupLevels, kGroupLevels);  // this block's levels
  const Layout lay = layout((int)sizeof(LaneT), min(lvls, kGroupLevels), kScan);
  // pairs q0 .. q0 + V - 1 of this block's levels: level lvl, lanes d0 ..
  const int q0 = tid * V;
  const bool active = q0 < lg * 128;
  const int lvl = q0 >> 7;
  const int d0 = q0 & 127;

  const char* vals = reinterpret_cast<const char*>(p.vals);
  const char* lanes = reinterpret_cast<const char*>(p.lane);
  const char* ends = reinterpret_cast<const char*>(p.ends);
  const char* starts = reinterpret_cast<const char*>(p.starts);
  constexpr int kLanePieces = 64 * (int)sizeof(LaneT);  // 16-byte pieces of a slab's lanes
  const int lvl_pieces = 64 * lg;                       // of its ends (or starts) here

  auto issue = [&](int i) {  // slab i of the segment into stage i % kRing; one group a call
    if (i < n) {
      const int64_t s = (int64_t)seg.first + i;
      unsigned char* d = ring + (i % kRing) * lay.bytes;
      spmx_tile::copy16(d + 16 * tid, vals + s * 4096 + 16 * tid, true);
      for (int k = tid; k < kLanePieces; k += kThreads)
        spmx_tile::copy16(d + lay.lane + 16 * k, lanes + s * (16 * kLanePieces) + 16 * k, true);
      const int64_t lo = (s * lvls + gy * kGroupLevels) * 1024;
      for (int k = tid; k < lvl_pieces; k += kThreads) {
        spmx_tile::copy16(d + lay.ends + 16 * k, ends + lo + 16 * k, true);
        if (kScan) spmx_tile::copy16(d + lay.starts + 16 * k, starts + lo + 16 * k, true);
      }
      if (tid < 2)
        spmx_tile::copy16(d + lay.col_off + 16 * tid, p.col_off + s * 8 + 4 * tid, true);
      else if (tid < 4)
        spmx_tile::copy16(d + lay.chunk_stripe + 16 * (tid - 2),
                          p.chunk_stripe + s * 8 + 4 * (tid - 2), true);
    }
    spmx_tile::commit();
  };

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int i = 0; i < kRing - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    spmx_tile::wait_pending<kRing - 2>();  // this thread's copies of slab i landed
    __syncthreads();  // everyone's; and slab i - 1's stage and the prefix are free
    issue(i + kRing - 1);
    const unsigned char* st = ring + (i % kRing) * lay.bytes;
    {  // warp w: the products (prefix sums in scan mode) of chunk w, all zero
       // for a padding chunk of another stripe
      const float4 v = reinterpret_cast<const float4*>(st)[warp * 32 + t];
      const int4 l = lanes4(reinterpret_cast<const LaneT*>(st + lay.lane) + warp * 128, t);
      const int64_t w = (int64_t)reinterpret_cast<const int*>(st + lay.col_off)[warp] * 128;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      if (reinterpret_cast<const int*>(st + lay.chunk_stripe)[warp] == stripe) {
        a0 = v.x * xat(x, w + l.x, p.cols);
        a1 = v.y * xat(x, w + l.y, p.cols);
        a2 = v.z * xat(x, w + l.z, p.cols);
        a3 = v.w * xat(x, w + l.w, p.cols);
      }
      if (kScan) {
        a1 = a0 + a1;
        a2 = a1 + a2;
        a3 = a2 + a3;
        float incl = a3;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float up = __shfl_up_sync(spmx::kFullMask, incl, d);
          if (t >= d) incl += up;
        }
        float excl = __shfl_up_sync(spmx::kFullMask, incl, 1);
        if (t == 0) excl = 0.f;
        a0 += excl;
        a1 += excl;
        a2 += excl;
        a3 += excl;
      }
      reinterpret_cast<float4*>(prefix[warp])[t] = make_float4(a0, a1, a2, a3);
    }
    __syncthreads();
    if (active) {  // this thread's pairs: the 8 chunks' gathers, in chunk order
      const int8_t* e8 = reinterpret_cast<const int8_t*>(st + lay.ends) + lvl * 1024 + d0;
      const int8_t* s8 = reinterpret_cast<const int8_t*>(st + lay.starts) + lvl * 1024 + d0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        int e[V];
        bytes_v<V>(e8 + c * 128, e);
        if (kScan) {
          int b[V];
          bytes_v<V>(s8 + c * 128, b);
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[k] += prefix[c][e[k]] - (b[k] < 0 ? 0.f : prefix[c][b[k]]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += prefix[c][e[k]];
        }
      }
    }
  }

  const bool x0_term = p.foreign_pad && stripe == 0;
  if (seg.slot >= 0) {
    const int first = __ldg(p.stripe_seg + stripe);
    const int nseg = __ldg(p.stripe_seg + stripe + 1) - first;
    if (!spmx::last_of_segments<V>(spmx::BlockOwner{&ticket_cell}, p.scratch,
                                   (int64_t)lvls * 128, seg.slot, seg.slot - (sidx - first),
                                   nseg, (int64_t)gy * kGroupLevels * 128 + q0, active, acc,
                                   p.tickets + (int64_t)stripe * gridDim.y + gy))
      return;
  } else if (add && n == 0 && !x0_term) {
    return;
  }
  if (!active) return;
  const int64_t rb = (int64_t)stripe * lvls + gy * kGroupLevels + lvl;
  if (x0_term) {
    const float z = 0.f * (p.cols > 0 ? __ldg(x) : 0.f);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += z;
  }
  if (!(__ldg(p.rb_mask + rb) > 0.f)) {
    if (add) return;
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
  }
  spmx::write_rows<V>(y, p.rows, rb * 128 + d0, acc, add);
}

template <typename LaneT, bool kScan, int V>
cudaError_t launch(const SpmxStripePlan& p, const float* x, float* y, int add,
                   cudaStream_t stream) {
  const int lg = p.levels < kGroupLevels ? p.levels : kGroupLevels;
  const int smem = kRing * layout((int)sizeof(LaneT), lg, kScan).bytes;
  auto kernel = stripe_kernel<LaneT, kScan, V>;
  static int opted[64] = {0};  // dynamic shared memory allowed so far, per device
  if (p.device < 0 || p.device >= 64) return cudaErrorInvalidDevice;
  if (smem > opted[p.device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[p.device] = smem;
  }
  const dim3 grid((unsigned)p.num_segments,
                  (unsigned)((p.levels + kGroupLevels - 1) / kGroupLevels));
  kernel<<<grid, kThreads, smem, stream>>>(p, x, y, add);
  return cudaGetLastError();
}

template <typename LaneT, bool kScan>
cudaError_t launch_v(const SpmxStripePlan& p, const float* x, float* y, int add,
                     cudaStream_t s) {
  // V pairs a thread: the fewest that let 256 threads cover min(L, 8) levels
  if (p.levels <= 2) return launch<LaneT, kScan, 1>(p, x, y, add, s);
  if (p.levels <= 4) return launch<LaneT, kScan, 2>(p, x, y, add, s);
  return launch<LaneT, kScan, 4>(p, x, y, add, s);
}

}  // namespace

SPMX_API int spmx_stripe_group_levels(void) { return kGroupLevels; }

SPMX_API int spmx_stripe(const SpmxStripePlan* plan, const float* x, float* y, int add,
                         void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->num_segments == 0) return 0;
  if (plan->levels < 1 || (plan->lane_bytes != 1 && plan->lane_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool scan = plan->starts != nullptr;
  if (plan->lane_bytes == 1)
    err = scan ? launch_v<int8_t, true>(*plan, x, y, add, s)
               : launch_v<int8_t, false>(*plan, x, y, add, s);
  else
    err = scan ? launch_v<int16_t, true>(*plan, x, y, add, s)
               : launch_v<int16_t, false>(*plan, x, y, add, s);
  return (int)err;
}
