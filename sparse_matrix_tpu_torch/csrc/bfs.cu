// Direction-optimizing breadth-first search (Beamer, Asanovic, Patterson,
// SC'12; GAP's bfs.cc, DOBFS) over an undirected graph's CSR pattern
// (int64 row offsets, uint32 columns sorted within each row): the steps of
// graph/bfs.py, which runs GAP's heuristic on the host between them.
//
// Replaces: no TPU kernel. The JAX package's breadth_first_order is host
// code over its native traversal; these kernels put the search on the card.
//
// Bound on the H100. A search reads a few percent of the graph: the rows of
// the top-down frontiers, and the first entries of the unvisited rows in
// the bottom-up steps. The top-down steps over small frontiers are bound by
// latency (a launch, a handful of dependent loads); the large steps by
// device-memory bandwidth: the frontier's columns streamed, one 32-byte
// sector for each row a step starts to read, and lookups in the bitmaps,
// which L2 holds (4 MB a bitmap at 2^25 vertices, of the 50 MB L2).
//
// State (the plan's, graph/bfs.py): `unvisited`, a bitmap of the vertices
// not yet reached that have an edge; two frontier bitmaps `bits`, the
// current frontier and the next, in turn, in the bottom-up steps; two
// queues, the frontier of a top-down step and its next; `prefix`, the
// degrees of the queue's vertices, which the caller scans into their
// inclusive sums before a top-down step (torch.cumsum); `counts`, the two
// numbers a step hands to the host. Within a search, `parents` holds kNone for each
// unvisited vertex with an edge (-1 for the others), so a top-down step
// claims on it directly; spmx_bfs_td_end writes -1 where a vertex is left
// unvisited.
//
// Top-down step (spmx_bfs_td_expand, spmx_bfs_td_finish). The work is the
// frontier's entries, E = prefix[q - 1] of them, cut into tiles of kTile
// entries whatever the rows' lengths (a hub of 640,793 entries spans 626
// tiles, a thousand short rows share one): a persistent grid walks the
// tiles; a block finds the frontier slots of its tile by two binary
// searches of the inclusive sums, stages their sums, vertices and row
// starts in shared memory, and each thread maps its entries to their slots
// by a binary search there (the load-balanced search of the merge path, on
// the path of the frontier's entries alone). An entry (u, v) with v
// unvisited claims v by an integer atomicMin of u on parents[v]; the claim
// that finds kNone queues v, in the block's shared queue first, which one
// atomic on counts[0] a tile places in the next queue. The finishing
// kernel clears each queued v's unvisited bit, writes deg(v) to prefix and
// adds it to counts[1]. So v's parent is the smallest frontier vertex next
// to it, whatever the order of the claims: the queue's order differs from
// call to call, the parents do not. Parents found from the new vertices' rows
// instead (the bottom-up rule below) cost a read of each row up to its
// first frontier neighbour, which for the neighbours of a lone hub is most
// of the next level's entries: 5-15 ms a step at scale 25 on an H100,
// against about 1 ms for the claims.
//
// Bottom-up step (spmx_bfs_bu_step). A warp takes a 32-bit word of the
// unvisited bitmap, a lane a vertex (first_in_front). Each lane reads the
// first kSerial entries of its row in column order, stopping at the first
// neighbour whose frontier bit is set; the rows longer than that which
// found none are then read by the whole warp in turn, 32 entries at a time,
// the first hit by a ballot. So a long row does not leave the rest of its
// warp idle, and the parent is the first frontier neighbour in column
// order: the smallest, as in the top-down step, so the two directions give
// the same parents. The warp owns its words: it writes the next frontier's
// word (zero where it found nothing, so the bitmap needs no clearing) and
// the unvisited word with plain stores, and adds its count to counts[0]
// once a block.
//
// Conversions: spmx_bfs_bu_enter lays the queue into a cleared frontier
// bitmap (atomicOr), spmx_bfs_bu_leave compacts a bitmap into the queue
// with the vertices' degrees (a thread a word, its place from a scan of
// the block's counts and one atomic a block).
//
// Every count is an integer sum, so two calls give the same counts and the
// same parents. No float atomics.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// frontier entries a thread takes in a top-down tile
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
// entries of its row a lane reads alone before its warp takes the row
constexpr int kSerial = 4;
constexpr int32_t kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool has_bit(const uint32_t* __restrict__ bits, uint32_t v) {
  return (__ldg(bits + (v >> 5)) >> (v & 31)) & 1u;
}

// the block's sum of each thread's `x`, added to *out by one thread
__device__ __forceinline__ void block_add(int64_t x, int64_t* out) {
  __shared__ int64_t s_part[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_part[w];
    if (s) atomicAdd((unsigned long long*)out, (unsigned long long)s);
  }
}

// For the lanes with `mine`, whose rows are cols[beg .. end): the first
// column in the row whose bit is set in `front`, or -1. Called by the
// whole warp.
__device__ __forceinline__ int32_t first_in_front(const uint32_t* __restrict__ cols,
                                                  const uint32_t* __restrict__ front, bool mine,
                                                  int64_t beg, int64_t end) {
  const int lane = threadIdx.x & 31;
  int32_t par = -1;
  if (mine) {
    const int64_t stop = end < beg + kSerial ? end : beg + kSerial;
    for (int64_t j = beg; j < stop; ++j) {
      const uint32_t c = __ldg(cols + j);
      if (has_bit(front, c)) {
        par = (int32_t)c;
        break;
      }
    }
  }
  // the rest of the long rows without a hit, the warp together
  unsigned rest = __ballot_sync(kFull, mine && par < 0 && end - beg > kSerial);
  while (rest) {
    const int src = __ffs(rest) - 1;
    rest &= rest - 1;
    const int64_t b = __shfl_sync(kFull, beg, src) + kSerial;
    const int64_t e = __shfl_sync(kFull, end, src);
    int32_t hit = -1;
    for (int64_t at = b; at < e; at += 32) {
      const int64_t j = at + lane;
      uint32_t c = 0;
      bool f = false;
      if (j < e) {
        c = __ldg(cols + j);
        f = has_bit(front, c);
      }
      const unsigned m = __ballot_sync(kFull, f);
      if (m) {
        hit = (int32_t)__shfl_sync(kFull, c, __ffs(m) - 1);
        break;
      }
    }
    if (lane == src) par = hit;
  }
  return par;
}

// parents: the source itself, kNone for the other vertices with an edge,
// -1 for the rest; unvisited = has_edges less the source; queue0 the
// source alone, its degree in prefix[0]
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_td_start(SpmxBfsPlan p, int32_t* __restrict__ parents, int64_t source) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = first; i < p.n; i += stride) {
    parents[i] = i == source ? (int32_t)source : has_bit(p.has_edges, (uint32_t)i) ? kNone : -1;
  }
  for (int64_t w = first; w < p.words; w += stride) {
    const uint32_t mask = w == (source >> 5) ? 1u << (source & 31) : 0u;
    p.unvisited[w] = p.has_edges[w] & ~mask;
  }
  if (first == 0) {
    p.queue0[0] = (int32_t)source;
    p.prefix[0] = p.offsets[source + 1] - p.offsets[source];
  }
}

// claims on parents of the frontier queue[0 .. q) (prefix: the inclusive
// sums of their degrees), new vertices queued in next with counts[0]
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_td_expand(SpmxBfsPlan p, int32_t* __restrict__ parents,
                       const int32_t* __restrict__ queue, int64_t q, int32_t* __restrict__ next) {
  __shared__ int64_t s_end[kTile];
  __shared__ int64_t s_base[kTile];
  __shared__ int32_t s_u[kTile];
  __shared__ int32_t s_push[kTile];
  __shared__ int64_t s_range[2];
  __shared__ int s_n;
  __shared__ unsigned long long s_at;
  const int lane = threadIdx.x & 31;
  const int64_t total = q > 0 ? p.prefix[q - 1] : 0;
  const int64_t tiles = (total + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t e0 = t * kTile;
    const int64_t e1 = e0 + kTile < total ? e0 + kTile : total;
    if (threadIdx.x == 0) s_n = 0;
    if (threadIdx.x < 2) {
      // the slot holding entry e0 (thread 0) and entry e1 - 1 (thread 1):
      // the first whose inclusive sum passes it
      const int64_t key = threadIdx.x == 0 ? e0 : e1 - 1;
      int64_t lo = 0, hi = q - 1;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (p.prefix[mid] > key) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      s_range[threadIdx.x] = lo;
    }
    __syncthreads();
    const int64_t s0 = s_range[0];
    // every slot of the range holds an entry of the tile (a queue holds no
    // vertex of degree 0 but a lone source), so at most kTile
    const int ns = (int)(s_range[1] - s0 + 1);
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      const int64_t s = s0 + k;
      const int32_t u = queue[s];
      const int64_t before = s > 0 ? p.prefix[s - 1] : 0;
      s_end[k] = p.prefix[s];
      s_u[k] = u;
      s_base[k] = p.offsets[u] - before;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t e = e0 + k * kThreads + threadIdx.x;
      bool push = false;
      uint32_t v = 0;
      if (e < e1) {
        int lo = 0, hi = ns - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_end[mid] > e) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        const int32_t u = s_u[lo];
        v = __ldcs(p.cols + s_base[lo] + e);
        // an unvisited vertex's parent only falls within the step; it is
        // read through L2 (__ldcg), so a stale value only costs an atomic
        if (has_bit(p.unvisited, v) && __ldcg(parents + v) > u) {
          push = atomicMin(parents + v, u) == kNone;
        }
      }
      const unsigned m = __ballot_sync(kFull, push);
      if (m) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_n, __popc(m));
        base = __shfl_sync(kFull, base, 0);
        if (push) s_push[base + __popc(m & ((1u << lane) - 1u))] = (int32_t)v;
      }
    }
    __syncthreads();
    const int pushed = s_n;
    if (threadIdx.x == 0 && pushed) {
      s_at = atomicAdd((unsigned long long*)p.counts, (unsigned long long)pushed);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < pushed; k += kThreads) next[s_at + k] = s_push[k];
    __syncthreads();
  }
}

// the counts[0] vertices queued in next: unvisited bits cleared, degrees
// in prefix and summed into counts[1]
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_td_finish(SpmxBfsPlan p, const int32_t* __restrict__ next) {
  const int64_t count = p.counts[0];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t sum = 0;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count; i += stride) {
    const int32_t v = next[i];
    atomicAnd(p.unvisited + (v >> 5), ~(1u << (v & 31)));
    const int64_t d = p.offsets[v + 1] - p.offsets[v];
    p.prefix[i] = d;
    sum += d;
  }
  block_add(sum, p.counts + 1);
}

// parents = -1 where the search left a vertex with an edge unvisited
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_td_end(SpmxBfsPlan p, int32_t* __restrict__ parents) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x; w < p.words; w += stride) {
    for (uint32_t m = p.unvisited[w]; m; m &= m - 1) parents[(w << 5) + __ffs(m) - 1] = -1;
  }
}

// cleared bits (by the caller) |= the queue's vertices
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_bu_enter(const int32_t* __restrict__ queue, int64_t q, uint32_t* __restrict__ bits) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < q; i += stride) {
    const int32_t v = queue[i];
    atomicOr(bits + (v >> 5), 1u << (v & 31));
  }
}

// one bottom-up step from the frontier `front` into `next`, the vertices
// found counted in counts[0]
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_bu_step(SpmxBfsPlan p, int32_t* __restrict__ parents,
                     const uint32_t* __restrict__ front, uint32_t* __restrict__ next) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * kThreads) >> 5;
  int64_t awake = 0;
  for (int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5; w < p.words;
       w += warps) {
    const uint32_t live = p.unvisited[w];
    uint32_t found = 0;
    if (live) {
      const int64_t v = (w << 5) + lane;
      const bool mine = (live >> lane) & 1u;
      int64_t beg = 0, end = 0;
      if (mine) {
        beg = p.offsets[v];
        end = p.offsets[v + 1];
      }
      const int32_t par = first_in_front(p.cols, front, mine, beg, end);
      if (par >= 0) parents[v] = par;
      found = __ballot_sync(kFull, par >= 0);
      if (lane == 0 && found) p.unvisited[w] = live & ~found;
    }
    if (lane == 0) {
      next[w] = found;
      awake += __popc(found);
    }
  }
  block_add(awake, p.counts);
}

// the vertices of bits into queue (counts[0] as its tail), their degrees in
// prefix: a thread a word, its place from the block's scan of the words'
// counts and one atomic a block
__global__ void __launch_bounds__(kThreads)
    spmx_bfs_bu_leave(SpmxBfsPlan p, const uint32_t* __restrict__ bits,
                      int32_t* __restrict__ queue) {
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t w0 = (int64_t)blockIdx.x * kThreads; w0 < p.words; w0 += stride) {
    const int64_t w = w0 + threadIdx.x;
    const uint32_t m = w < p.words ? bits[w] : 0u;
    const int mine = __popc(m);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int t = s_warp[k];
        s_warp[k] = run;
        run += t;
      }
      if (run) s_at = atomicAdd((unsigned long long*)p.counts, (unsigned long long)run);
    }
    __syncthreads();
    int64_t r = (int64_t)s_at + s_warp[warp] + incl - mine;
    for (uint32_t b = m; b; b &= b - 1, ++r) {
      const int64_t v = (w << 5) + __ffs(b) - 1;
      queue[r] = (int32_t)v;
      p.prefix[r] = p.offsets[v + 1] - p.offsets[v];
    }
    __syncthreads();
  }
}

int32_t* queue_of(const SpmxBfsPlan* p, int which) { return which ? p->queue1 : p->queue0; }

uint32_t* bits_of(const SpmxBfsPlan* p, int which) { return which ? p->bits1 : p->bits0; }

int zero_counts(const SpmxBfsPlan* p, cudaStream_t s) {
  return (int)cudaMemsetAsync(p->counts, 0, 2 * sizeof(int64_t), s);
}

}  // namespace

SPMX_API int spmx_bfs_prepare(SpmxBfsPlan* plan) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, a = 0, b = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, plan->device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, spmx_bfs_td_expand, kThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, spmx_bfs_bu_step, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int per_sm = a < b ? a : b;
  plan->grid = sms * (per_sm > 1 ? per_sm : 1);
  return (int)cudaSuccess;
}

SPMX_API int spmx_bfs_start(const SpmxBfsPlan* plan, int32_t* parents, int64_t source,
                            void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  spmx_bfs_td_start<<<plan->grid, kThreads, 0, (cudaStream_t)stream>>>(*plan, parents, source);
  return (int)cudaGetLastError();
}

SPMX_API int spmx_bfs_top_down(const SpmxBfsPlan* plan, int32_t* parents, int cur, int64_t q,
                               void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = zero_counts(plan, s);
  if (rc) return rc;
  int32_t* next = queue_of(plan, cur ^ 1);
  spmx_bfs_td_expand<<<plan->grid, kThreads, 0, s>>>(*plan, parents, queue_of(plan, cur), q,
                                                     next);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  spmx_bfs_td_finish<<<plan->grid, kThreads, 0, s>>>(*plan, next);
  return (int)cudaGetLastError();
}

SPMX_API int spmx_bfs_end(const SpmxBfsPlan* plan, int32_t* parents, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (plan->words + kThreads - 1) / kThreads;
  const int64_t blocks = need < plan->grid ? need : plan->grid;
  spmx_bfs_td_end<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*plan, parents);
  return (int)cudaGetLastError();
}

SPMX_API int spmx_bfs_enter_bitmap(const SpmxBfsPlan* plan, int cur, int64_t q, int flip,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* bits = bits_of(plan, flip);
  err = cudaMemsetAsync(bits, 0, plan->words * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (q + kThreads - 1) / kThreads;
  const int64_t blocks = need < plan->grid ? need : plan->grid;
  if (blocks > 0) {
    spmx_bfs_bu_enter<<<(unsigned)blocks, kThreads, 0, s>>>(queue_of(plan, cur), q, bits);
  }
  return (int)cudaGetLastError();
}

SPMX_API int spmx_bfs_bottom_up(const SpmxBfsPlan* plan, int32_t* parents, int flip,
                                void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = zero_counts(plan, s);
  if (rc) return rc;
  spmx_bfs_bu_step<<<plan->grid, kThreads, 0, s>>>(*plan, parents, bits_of(plan, flip),
                                                   bits_of(plan, flip ^ 1));
  return (int)cudaGetLastError();
}

SPMX_API int spmx_bfs_leave_bitmap(const SpmxBfsPlan* plan, int flip, int cur, void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = zero_counts(plan, s);
  if (rc) return rc;
  spmx_bfs_bu_leave<<<plan->grid, kThreads, 0, s>>>(*plan, bits_of(plan, flip),
                                                    queue_of(plan, cur));
  return (int)cudaGetLastError();
}
