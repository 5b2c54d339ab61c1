// Host runtime of the port: the sequential and irregular host work of
// solvers/ilu.py and solvers/amg.py, and the hash SpGEMM engine under
// ops/spgemm_host.py.
//
// Copied from sparse_matrix_tpu/native/src/spmx_native.cpp (the
// reference's native runtime), so the port runs its setup at native speed
// without importing the JAX package:
//   * the linear-probe hash tables, FLOP-balanced row partitioning and the
//     threaded two-phase (symbolic/numeric) Gustavson hash SpGEMM with its
//     SPA variants and probe-length histograms (the reference crate's
//     mul_hash, spam_csr/src/mul_hash.rs);
//   * the greedy aggregation passes, the strength/diagonal sweeps, row
//     scaling, the Jacobi smoother values and the colmap products of the
//     AMG setup;
//   * ILU(0), ILUT and the exact triangular solve.
// The copies are verbatim, so the results equal the reference's bit for
// bit (hash-table order of unsorted rows included). Built by
// sparse_matrix_tpu_torch/native/host.py with g++ into
// _build/libspmx_torch_host.so and bound with ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

typedef int64_t i64;
typedef uint32_t u32;

#define SPMX_HOST_API extern "C" __attribute__((visibility("default")))

static const u32 kEmpty = 0xFFFFFFFFu;
static const i64 kMinCap = 16;

static inline u32 hash_u32(u32 k) { return k * 107u; }

static inline i64 next_pow2(i64 n) {
  i64 p = 1;
  while (p < n) p <<= 1;
  return p;
}

static inline i64 table_capacity(i64 n) {
  // next_pow2(n) * 2, min 16 => load factor <= 1/2
  i64 c = next_pow2(n < 1 ? 1 : n) * 2;
  return c < kMinCap ? kMinCap : c;
}

// ---------------------------------------------------------------------------
// Debug instrumentation: probe-length histograms (the reference's `debug`
// cargo feature, linprobe/src/map.rs:17-18 + spam_csr/src/mul_hash.rs:18-25,
// 98-99, 188-189 — per-phase probe histograms recorded by the engine that
// actually runs). Runtime flag instead of a compile-time feature: when off,
// the hot loops pay one predictable branch. Bin i counts lookups that took
// i extra probe steps (0 = direct hit), capped at kProbeBins-1.
// ---------------------------------------------------------------------------

static const int kProbeBins = 64;
static bool g_debug_probes = false;
static std::atomic<long long> g_probe_hist_symbolic[kProbeBins];
static std::atomic<long long> g_probe_hist_numeric[kProbeBins];

extern "C" void spmx_debug_set(int on) { g_debug_probes = on != 0; }

extern "C" void spmx_debug_clear() {
  for (int i = 0; i < kProbeBins; ++i) {
    g_probe_hist_symbolic[i].store(0, std::memory_order_relaxed);
    g_probe_hist_numeric[i].store(0, std::memory_order_relaxed);
  }
}

// out_symbolic/out_numeric: caller-allocated i64[64] each.
extern "C" void spmx_debug_probe_hist(i64* out_symbolic, i64* out_numeric) {
  for (int i = 0; i < kProbeBins; ++i) {
    out_symbolic[i] = (i64)g_probe_hist_symbolic[i].load(std::memory_order_relaxed);
    out_numeric[i] = (i64)g_probe_hist_numeric[i].load(std::memory_order_relaxed);
  }
}

namespace {

// Per-thread histogram buffer; flushed to the global atomics once per chunk
// so the instrumented hot loop stays atomic-free.
struct ProbeHist {
  long long bins[kProbeBins] = {};
  inline void record(int steps) {
    ++bins[steps < kProbeBins ? steps : kProbeBins - 1];
  }
  void flush(std::atomic<long long>* global) {
    for (int i = 0; i < kProbeBins; ++i) {
      if (bins[i]) {
        global[i].fetch_add(bins[i], std::memory_order_relaxed);
        bins[i] = 0;
      }
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// FLOP counting + row partitioning (the rows_to_threads analog)
// ---------------------------------------------------------------------------

extern "C" void spmx_flops_per_row(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                        const i64* rhs_offsets, i64* out_flops) {
  for (i64 i = 0; i < rows; ++i) {
    i64 acc = 0;
    for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
      u32 k = lhs_indices[p];
      acc += rhs_offsets[k + 1] - rhs_offsets[k];
    }
    out_flops[i] = acc;
  }
}

// rows_offset has num_parts+1 slots; chunks get ~equal FLOPs.
extern "C" void spmx_partition_rows(i64 rows, const i64* flops, i64 num_parts, i64* rows_offset) {
  std::vector<i64> ps(rows + 1);
  ps[0] = 0;
  for (i64 i = 0; i < rows; ++i) ps[i + 1] = ps[i] + flops[i];
  i64 total = ps[rows];
  i64 avg = num_parts > 0 ? (total + num_parts - 1) / num_parts : total;
  rows_offset[0] = 0;
  for (i64 t = 1; t < num_parts; ++t) {
    // first index with ps > avg*t, minus 1
    const i64* ub = std::upper_bound(ps.data(), ps.data() + rows + 1, avg * t);
    rows_offset[t] = (ub - ps.data()) - 1;
  }
  rows_offset[num_parts] = rows;
}

// ---------------------------------------------------------------------------
// Symbolic phase: exact per-row output nnz via a per-thread probe set
// ---------------------------------------------------------------------------

namespace {

struct ProbeSet {
  std::vector<u32> slots;
  i64 window = 0;

  void reserve_window(i64 n) {
    i64 cap = table_capacity(n);
    if ((i64)slots.size() < cap) slots.assign(cap, kEmpty);
    else std::fill(slots.begin(), slots.begin() + cap, kEmpty);
    window = cap;
  }

  // returns 1 if new
  inline int insert(u32 key) {
    i64 mask = window - 1;
    i64 idx = hash_u32(key) & mask;
    for (int steps = 0;; ++steps) {
      u32 cur = slots[idx];
      if (cur == kEmpty) {
        slots[idx] = key;
        if (g_debug_probes) hist.record(steps);
        return 1;
      }
      if (cur == key) {
        if (g_debug_probes) hist.record(steps);
        return 0;
      }
      idx = (idx + 1) & mask;
    }
  }

  ProbeHist hist;
};

template <typename V>
struct ProbeMap {
  std::vector<u32> keys;
  std::vector<V> vals;
  i64 window = 0;

  void reserve_window(i64 n) {
    i64 cap = table_capacity(n);
    if ((i64)keys.size() < cap) {
      keys.assign(cap, kEmpty);
      vals.assign(cap, V());
    } else {
      std::fill(keys.begin(), keys.begin() + cap, kEmpty);
    }
    window = cap;
  }

  inline void upsert(u32 key, V v) {
    i64 mask = window - 1;
    i64 idx = hash_u32(key) & mask;
    for (int steps = 0;; ++steps) {
      u32 cur = keys[idx];
      if (cur == kEmpty) {
        keys[idx] = key;
        vals[idx] = v;
        if (g_debug_probes) hist.record(steps);
        return;
      }
      if (cur == key) {
        vals[idx] += v;
        if (g_debug_probes) hist.record(steps);
        return;
      }
      idx = (idx + 1) & mask;
    }
  }

  ProbeHist hist;
};

void run_chunked(i64 num_parts, const i64* rows_offset, int num_threads,
                 const std::function<void(i64, i64, i64)>& body) {
  // body(chunk_id, row_lo, row_hi)
  std::vector<std::thread> threads;
  std::atomic<i64> next(0);
  int tcount = num_threads > 0 ? num_threads : (int)std::thread::hardware_concurrency();
  if (tcount < 1) tcount = 1;
  auto worker = [&]() {
    for (;;) {
      i64 c = next.fetch_add(1);
      if (c >= num_parts) break;
      body(c, rows_offset[c], rows_offset[c + 1]);
    }
  };
  for (int t = 1; t < tcount; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

// row_nz in: FLOP upper bounds; out: exact output nnz per row.
extern "C" void spmx_spgemm_symbolic(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                          const i64* rhs_offsets, const u32* rhs_indices,
                          const i64* rows_offset, i64 num_parts, int num_threads,
                          i64* row_nz) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    ProbeSet hs;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      hs.reserve_window(row_nz[i]);
      i64 count = 0;
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          count += hs.insert(rhs_indices[q]);
        }
      }
      row_nz[i] = count;
    }
    if (g_debug_probes) hs.hist.flush(g_probe_hist_symbolic);
  });
}

// Numeric phase, templated over the value type.
template <typename V>
static void spgemm_numeric_impl(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                                const V* lhs_vals, const i64* rhs_offsets,
                                const u32* rhs_indices, const V* rhs_vals,
                                const i64* out_offsets, const i64* row_nz,
                                const i64* rows_offset, i64 num_parts, int num_threads,
                                int output_sorted, u32* out_indices, V* out_vals) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    ProbeMap<V> hm;
    std::vector<std::pair<u32, V>> row_buf;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      hm.reserve_window(row_nz[i]);
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        V t = lhs_vals[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          hm.upsert(rhs_indices[q], t * rhs_vals[q]);
        }
      }
      i64 base = out_offsets[i];
      if (output_sorted) {
        row_buf.clear();
        for (i64 s = 0; s < hm.window; ++s) {
          if (hm.keys[s] != kEmpty) row_buf.emplace_back(hm.keys[s], hm.vals[s]);
        }
        std::sort(row_buf.begin(), row_buf.end(),
                  [](const auto& a, const auto& b) { return a.first < b.first; });
        for (i64 s = 0; s < (i64)row_buf.size(); ++s) {
          out_indices[base + s] = row_buf[s].first;
          out_vals[base + s] = row_buf[s].second;
        }
      } else {
        i64 w = 0;
        for (i64 s = 0; s < hm.window; ++s) {
          if (hm.keys[s] != kEmpty) {
            out_indices[base + w] = hm.keys[s];
            out_vals[base + w] = hm.vals[s];
            ++w;
          }
        }
      }
    }
    if (g_debug_probes) hm.hist.flush(g_probe_hist_numeric);
  });
}

extern "C" void spmx_spgemm_numeric_f64(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                             const double* lhs_vals, const i64* rhs_offsets,
                             const u32* rhs_indices, const double* rhs_vals,
                             const i64* out_offsets, const i64* row_nz,
                             const i64* rows_offset, i64 num_parts, int num_threads,
                             int output_sorted, u32* out_indices, double* out_vals) {
  spgemm_numeric_impl<double>(rows, lhs_offsets, lhs_indices, lhs_vals, rhs_offsets,
                              rhs_indices, rhs_vals, out_offsets, row_nz, rows_offset,
                              num_parts, num_threads, output_sorted, out_indices, out_vals);
}

extern "C" void spmx_spgemm_numeric_f32(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                             const float* lhs_vals, const i64* rhs_offsets,
                             const u32* rhs_indices, const float* rhs_vals,
                             const i64* out_offsets, const i64* row_nz,
                             const i64* rows_offset, i64 num_parts, int num_threads,
                             int output_sorted, u32* out_indices, float* out_vals) {
  spgemm_numeric_impl<float>(rows, lhs_offsets, lhs_indices, lhs_vals, rhs_offsets,
                             rhs_indices, rhs_vals, out_offsets, row_nz, rows_offset,
                             num_parts, num_threads, output_sorted, out_indices, out_vals);
}

extern "C" void spmx_spgemm_numeric_i64(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                             const i64* lhs_vals, const i64* rhs_offsets,
                             const u32* rhs_indices, const i64* rhs_vals,
                             const i64* out_offsets, const i64* row_nz,
                             const i64* rows_offset, i64 num_parts, int num_threads,
                             int output_sorted, u32* out_indices, i64* out_vals) {
  spgemm_numeric_impl<i64>(rows, lhs_offsets, lhs_indices, lhs_vals, rhs_offsets,
                           rhs_indices, rhs_vals, out_offsets, row_nz, rows_offset,
                           num_parts, num_threads, output_sorted, out_indices, out_vals);
}

// Gustavson SPA (sparse accumulator) variants of the two phases: an
// epoch-marked dense array over the output column space replaces the hash
// probes — one array access per product instead of a probe chain. Wins
// when cols fits in per-chunk memory and products have locality (AMG
// Galerkin / smoothing chains, stencil squarings); the Python wrapper
// gates on cols and total FLOPs. Same chunking, allocation, and output
// contract as the hash phases (kept zeros, optional sorted rows).
extern "C" void spmx_spgemm_symbolic_spa(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const i64* rhs_offsets, const u32* rhs_indices, const i64* rows_offset,
    i64 num_parts, int num_threads, i64* row_nz) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    std::vector<u32> mark((size_t)cols, 0);
    u32 epoch = 0;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      if (++epoch == 0) { std::fill(mark.begin(), mark.end(), 0); epoch = 1; }
      i64 count = 0;
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          u32 c = rhs_indices[q];
          if (mark[c] != epoch) { mark[c] = epoch; ++count; }
        }
      }
      row_nz[i] = count;
    }
  });
}

template <typename V>
static void spgemm_numeric_spa_impl(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const V* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const V* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, V* out_vals) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    std::vector<V> acc((size_t)cols);
    std::vector<u32> mark((size_t)cols, 0);
    std::vector<u32> touched;
    u32 epoch = 0;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      if (++epoch == 0) { std::fill(mark.begin(), mark.end(), 0); epoch = 1; }
      touched.clear();
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        V t = lhs_vals[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          u32 c = rhs_indices[q];
          V pv = t * rhs_vals[q];
          if (mark[c] != epoch) {
            mark[c] = epoch;
            acc[c] = pv;
            touched.push_back(c);
          } else {
            acc[c] += pv;
          }
        }
      }
      if (output_sorted) std::sort(touched.begin(), touched.end());
      i64 base = out_offsets[i];
      for (i64 s = 0; s < (i64)touched.size(); ++s) {
        out_indices[base + s] = touched[(size_t)s];
        out_vals[base + s] = acc[touched[(size_t)s]];
      }
    }
  });
}

extern "C" void spmx_spgemm_numeric_spa_f64(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const double* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const double* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, double* out_vals) {
  spgemm_numeric_spa_impl<double>(rows, cols, lhs_offsets, lhs_indices, lhs_vals,
                                  rhs_offsets, rhs_indices, rhs_vals, out_offsets,
                                  row_nz, rows_offset, num_parts, num_threads,
                                  output_sorted, out_indices, out_vals);
}
extern "C" void spmx_spgemm_numeric_spa_f32(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const float* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const float* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, float* out_vals) {
  spgemm_numeric_spa_impl<float>(rows, cols, lhs_offsets, lhs_indices, lhs_vals,
                                 rhs_offsets, rhs_indices, rhs_vals, out_offsets,
                                 row_nz, rows_offset, num_parts, num_threads,
                                 output_sorted, out_indices, out_vals);
}
extern "C" void spmx_spgemm_numeric_spa_i64(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const i64* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const i64* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, i64* out_vals) {
  spgemm_numeric_spa_impl<i64>(rows, cols, lhs_offsets, lhs_indices, lhs_vals,
                               rhs_offsets, rhs_indices, rhs_vals, out_offsets,
                               row_nz, rows_offset, num_parts, num_threads,
                               output_sorted, out_indices, out_vals);
}

extern "C" int spmx_hardware_threads() { return (int)std::thread::hardware_concurrency(); }

// ---------------------------------------------------------------------------
// Greedy smoothed-aggregation clustering, passes 1 and 3 (solvers/amg.py).
// The natural-order greedy is a lexicographically-first MIS of the
// neighborhood-overlap conflict graph — inherently sequential (P-complete),
// so it belongs in the native runtime rather than a Python node loop
// (measured ~2.3 us/node in numpy vs ~5 ns/edge here).
// agg[] is -1 for unassigned on entry; returns the updated aggregate count.
// ---------------------------------------------------------------------------

extern "C" i64 spmx_aggregate_pass1(i64 n, const i64* so, const i64* si, i64* agg) {
  i64 na = 0;
  for (i64 i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    i64 b = so[i], e = so[i + 1];
    bool blocked = false;
    for (i64 k = b; k < e; ++k)
      if (agg[si[k]] >= 0) { blocked = true; break; }
    if (blocked) continue;
    for (i64 k = b; k < e; ++k) agg[si[k]] = na;
    agg[i] = na;
    ++na;
  }
  return na;
}

// Pass 2: attach each leftover node to the SMALLEST adjacent pass-1
// aggregate id. All decisions must read the PASS-1 state (the numpy
// vectorized form this replaces evaluated `agg >= 0` once, up front), so
// in-loop attachments are stored encoded as `-2 - id` — still negative,
// hence invisible to later nodes' `agg[j] >= 0` scans — and decoded in a
// second sweep. Returns the number of nodes attached.
extern "C" i64 spmx_aggregate_pass2(i64 n, const i64* so, const i64* si, i64* agg) {
  i64 attached = 0;
  for (i64 i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    i64 m = -1;
    for (i64 k = so[i]; k < so[i + 1]; ++k) {
      i64 aj = agg[si[k]];
      if (aj >= 0 && (m < 0 || aj < m)) m = aj;
    }
    if (m >= 0) { agg[i] = -2 - m; ++attached; }
  }
  if (attached)
    for (i64 i = 0; i < n; ++i)
      if (agg[i] < -1) agg[i] = -2 - agg[i];
  return attached;
}

extern "C" i64 spmx_aggregate_pass3(i64 n, const i64* so, const i64* si, i64 na, i64* agg) {
  for (i64 i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    agg[i] = na;
    for (i64 k = so[i]; k < so[i + 1]; ++k) {
      i64 j = si[k];
      if (agg[j] < 0) agg[j] = na;
    }
    ++na;
  }
  return na;
}

// ---------------------------------------------------------------------------
// Incomplete factorizations and the exact triangular solve (solvers/ilu.py).
// All three are sequential along the row-dependency chain and require
// sorted column indices.
// ---------------------------------------------------------------------------

// ILU(0): IKJ row variant on the fixed CSR pattern (no fill). For each row
// i, fold in every finished row k < i present in row i. Returns -1 on
// success or the first row with a zero pivot.
template <typename V>
static i64 ilu0_impl(i64 rows, const i64* offsets, const u32* indices, V* vals,
                     const i64* diag_pos, i64* w /* size cols, init -1 */) {
  for (i64 i = 0; i < rows; ++i) {
    i64 b = offsets[i], e = offsets[i + 1];
    for (i64 t = b; t < e; ++t) w[indices[t]] = t;
    for (i64 t = b; t < e && (i64)indices[t] < i; ++t) {
      i64 k = (i64)indices[t];
      i64 dk = diag_pos[k];
      if (dk < 0 || vals[dk] == (V)0) { return k; }
      V f = vals[t] / vals[dk];
      vals[t] = f;
      for (i64 s = dk + 1; s < offsets[k + 1]; ++s) {
        i64 p = w[indices[s]];
        if (p >= 0) vals[p] -= f * vals[s];
      }
    }
    if (diag_pos[i] < 0 || vals[diag_pos[i]] == (V)0) return i;
    for (i64 t = b; t < e; ++t) w[indices[t]] = -1;
  }
  return -1;
}

SPMX_HOST_API i64 spmx_ilu0_f64(i64 rows, i64 cols, const i64* offsets,
                                const u32* indices, double* vals, const i64* diag_pos) {
  std::vector<i64> w((size_t)cols, -1);
  return ilu0_impl<double>(rows, offsets, indices, vals, diag_pos, w.data());
}

SPMX_HOST_API i64 spmx_ilu0_f32(i64 rows, i64 cols, const i64* offsets,
                                const u32* indices, float* vals, const i64* diag_pos) {
  std::vector<i64> w((size_t)cols, -1);
  return ilu0_impl<float>(rows, offsets, indices, vals, diag_pos, w.data());
}

// Exact triangular solve on CSR (x overwrites b). lower=1: forward sweep,
// rows ascending; lower=0: backward. unit=1 skips the diagonal divide
// (unit-diagonal factor). Returns -1 or the first zero-pivot row.
template <typename V>
static i64 trisolve_impl(i64 rows, const i64* offsets, const u32* indices,
                         const V* vals, const i64* diag_pos, V* x, int lower, int unit) {
  for (i64 step = 0; step < rows; ++step) {
    i64 i = lower ? step : rows - 1 - step;
    i64 b = offsets[i], e = offsets[i + 1];
    V acc = x[i];
    if (lower) {
      for (i64 t = b; t < e && (i64)indices[t] < i; ++t) acc -= vals[t] * x[indices[t]];
    } else {
      i64 d = diag_pos[i];
      for (i64 t = (d >= 0 ? d + 1 : b); t < e; ++t) acc -= vals[t] * x[indices[t]];
    }
    if (!unit) {
      i64 d = diag_pos[i];
      if (d < 0 || vals[d] == (V)0) return i;
      acc /= vals[d];
    }
    x[i] = acc;
  }
  return -1;
}

SPMX_HOST_API i64 spmx_trisolve_f64(i64 rows, const i64* offsets, const u32* indices,
                                    const double* vals, const i64* diag_pos,
                                    double* x, int lower, int unit) {
  return trisolve_impl<double>(rows, offsets, indices, vals, diag_pos, x, lower, unit);
}

SPMX_HOST_API i64 spmx_trisolve_f32(i64 rows, const i64* offsets, const u32* indices,
                                    const float* vals, const i64* diag_pos,
                                    float* x, int lower, int unit) {
  return trisolve_impl<float>(rows, offsets, indices, vals, diag_pos, x, lower, unit);
}

// ILUT(p, tau): threshold incomplete LU with a per-row fill cap. Saad's IKJ
// row variant with a lazy min-heap driving the ascending-k elimination
// order (fill can create new L-part entries mid-row). Dual dropping:
// entries below tau * ||row||_2 vanish during elimination; then only the p
// largest-|.| survive per part (the diagonal always stays). Outputs
// fixed-cap row arrays (L cap p, U cap p+1 with the diagonal first);
// columns within a row are unsorted. Returns the first zero-pivot row or -1.
template <typename V>
static i64 ilut_impl(i64 rows, const i64* offsets, const u32* indices, const V* vals,
                     double tau, i64 p,
                     i64* l_cnt, u32* l_idx, V* l_val,
                     i64* u_cnt, u32* u_idx, V* u_val,
                     i64 cols) {
  std::vector<double> w((size_t)cols, 0.0);
  std::vector<char> inw((size_t)cols, 0);
  std::vector<u32> touched;
  std::priority_queue<i64, std::vector<i64>, std::greater<i64>> heap;

  for (i64 i = 0; i < rows; ++i) {
    touched.clear();
    double norm2 = 0.0;
    for (i64 t = offsets[i]; t < offsets[i + 1]; ++t) {
      u32 j = indices[t];
      double v = (double)vals[t];
      if (!inw[j]) { inw[j] = 1; touched.push_back(j); w[j] = v; }
      else w[j] += v;
      norm2 += v * v;
      if ((i64)j < i) heap.push((i64)j);
    }
    double taui = tau * std::sqrt(norm2);

    i64 last = -1;
    while (!heap.empty()) {
      i64 k = heap.top(); heap.pop();
      if (k == last) continue;  // lazy dedup
      last = k;
      if (!inw[k]) continue;
      double wk = w[k];
      if (std::fabs(wk) < taui) { w[k] = 0.0; continue; }  // drop, stays touched
      // divide by U_kk (the first stored entry of U row k). The pivot was
      // nonzero in the double workspace when row k was committed, but can
      // underflow to 0 when stored as V=float: report zero-pivot row k
      // instead of poisoning the factors with inf/NaN.
      double piv = (double)u_val[k * (p + 1)];
      if (piv == 0.0) {
        for (u32 j : touched) { inw[j] = 0; w[j] = 0.0; }
        return k;
      }
      wk /= piv;
      w[k] = wk;
      for (i64 s = 1; s < u_cnt[k]; ++s) {
        u32 j = u_idx[k * (p + 1) + s];
        double upd = wk * (double)u_val[k * (p + 1) + s];
        if (!inw[j]) {
          if (std::fabs(upd) < taui) continue;  // don't create tiny fill
          inw[j] = 1; touched.push_back(j); w[j] = -upd;
          if ((i64)j < i) heap.push((i64)j);
        } else {
          w[j] -= upd;
        }
      }
    }

    // partition touched into L (k < i) and U (j > i), diagonal apart
    static thread_local std::vector<std::pair<double, u32>> lpart, upart;
    lpart.clear(); upart.clear();
    double diag = 0.0;
    for (u32 j : touched) {
      double v = w[j];
      if ((i64)j == i) diag = v;
      else if (std::fabs(v) >= taui && v != 0.0) {
        if ((i64)j < i) lpart.push_back({std::fabs(v), j});
        else upart.push_back({std::fabs(v), j});
      }
    }
    // check at storage precision: a double diagonal that underflows to 0
    // when stored as V would poison later rows' divisions with inf/NaN
    if ((V)diag == (V)0) {
      for (u32 j : touched) { inw[j] = 0; w[j] = 0.0; }
      return i;
    }
    auto keep_top = [](std::vector<std::pair<double, u32>>& part, i64 cap) {
      if ((i64)part.size() > cap) {
        std::nth_element(part.begin(), part.begin() + cap, part.end(),
                         [](const std::pair<double, u32>& a, const std::pair<double, u32>& b) {
                           return a.first > b.first;
                         });
        part.resize((size_t)cap);
      }
    };
    keep_top(lpart, p);
    keep_top(upart, p);
    i64 lc = 0;
    for (auto& pr : lpart) {
      l_idx[i * p + lc] = pr.second;
      l_val[i * p + lc] = (V)w[pr.second];
      ++lc;
    }
    l_cnt[i] = lc;
    // U row: diagonal first (the elimination above relies on this layout)
    u_idx[i * (p + 1)] = (u32)i;
    u_val[i * (p + 1)] = (V)diag;
    i64 uc = 1;
    for (auto& pr : upart) {
      u_idx[i * (p + 1) + uc] = pr.second;
      u_val[i * (p + 1) + uc] = (V)w[pr.second];
      ++uc;
    }
    u_cnt[i] = uc;

    for (u32 j : touched) { inw[j] = 0; w[j] = 0.0; }
  }
  return -1;
}

SPMX_HOST_API i64 spmx_ilut_f64(i64 rows, i64 cols, const i64* offsets, const u32* indices,
                                const double* vals, double tau, i64 p,
                                i64* l_cnt, u32* l_idx, double* l_val,
                                i64* u_cnt, u32* u_idx, double* u_val) {
  return ilut_impl<double>(rows, offsets, indices, vals, tau, p,
                           l_cnt, l_idx, l_val, u_cnt, u_idx, u_val, cols);
}

SPMX_HOST_API i64 spmx_ilut_f32(i64 rows, i64 cols, const i64* offsets, const u32* indices,
                                const float* vals, double tau, i64 p,
                                i64* l_cnt, u32* l_idx, float* l_val,
                                i64* u_cnt, u32* u_idx, float* u_val) {
  return ilut_impl<float>(rows, offsets, indices, vals, tau, p,
                          l_cnt, l_idx, l_val, u_cnt, u_idx, u_val, cols);
}

// ---------------------------------------------------------------------------
// AMG setup analysis (solvers/amg.py). The coarsening loop's per-level host
// passes (strength graph, diagonal extraction, Gershgorin row sums, row
// scaling) are single sweeps over nnz that numpy pays multiple temporaries
// for — at 4096^2 Poisson (84M nnz) they were ~100 s of the 600 s setup
// profile. Native runtime work, same stance as the reference's host-side
// irregular kernels (spam_csr/src/mul_hash.rs).
//
// Strength test (strength_graph, amg.py): edge (i, j), i != j, is strong
// when |a_ij| >= theta * sqrt(diag_i * diag_j) — compared in squares to
// skip the per-edge sqrt. diag[] must already have the zero/missing-row
// fallback applied (host does that from the rowmax output of the first
// pass; n-sized, cheap).
// ---------------------------------------------------------------------------

template <typename V>
static void amg_diag_abssum_impl(i64 n, const i64* offsets, const u32* indices,
                                 const V* vals, double* diag, double* abssum,
                                 double* rowmax) {
  for (i64 i = 0; i < n; ++i) {
    double d = 0.0, s = 0.0, mx = 0.0;
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      double a = (double)vals[k];
      double aa = a < 0 ? -a : a;
      s += aa;
      if (aa > mx) mx = aa;
      if ((i64)indices[k] == i) d = a;
    }
    diag[i] = d;
    abssum[i] = s;
    rowmax[i] = mx;
  }
}

extern "C" void spmx_amg_diag_abssum_f64(i64 n, const i64* offsets, const u32* indices,
                                         const double* vals, double* diag,
                                         double* abssum, double* rowmax) {
  amg_diag_abssum_impl<double>(n, offsets, indices, vals, diag, abssum, rowmax);
}

extern "C" void spmx_amg_diag_abssum_f32(i64 n, const i64* offsets, const u32* indices,
                                         const float* vals, double* diag,
                                         double* abssum, double* rowmax) {
  amg_diag_abssum_impl<float>(n, offsets, indices, vals, diag, abssum, rowmax);
}

template <typename V>
static void strength_count_impl(i64 n, const i64* offsets, const u32* indices,
                                const V* vals, double theta2, const double* diag,
                                i64* counts) {
  for (i64 i = 0; i < n; ++i) {
    i64 c = 0;
    double ti = theta2 * diag[i];
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      i64 j = (i64)indices[k];
      if (j == i) continue;
      double a = (double)vals[k];
      if (a * a >= ti * diag[j]) ++c;
    }
    counts[i] = c;
  }
}

template <typename V>
static void strength_fill_impl(i64 n, const i64* offsets, const u32* indices,
                               const V* vals, double theta2, const double* diag,
                               const i64* s_offsets, i64* s_indices) {
  for (i64 i = 0; i < n; ++i) {
    i64 c = s_offsets[i];
    double ti = theta2 * diag[i];
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      i64 j = (i64)indices[k];
      if (j == i) continue;
      double a = (double)vals[k];
      if (a * a >= ti * diag[j]) s_indices[c++] = j;
    }
  }
}

extern "C" void spmx_strength_count_f64(i64 n, const i64* offsets, const u32* indices,
                                        const double* vals, double theta2,
                                        const double* diag, i64* counts) {
  strength_count_impl<double>(n, offsets, indices, vals, theta2, diag, counts);
}

extern "C" void spmx_strength_count_f32(i64 n, const i64* offsets, const u32* indices,
                                        const float* vals, double theta2,
                                        const double* diag, i64* counts) {
  strength_count_impl<float>(n, offsets, indices, vals, theta2, diag, counts);
}

extern "C" void spmx_strength_fill_f64(i64 n, const i64* offsets, const u32* indices,
                                       const double* vals, double theta2,
                                       const double* diag, const i64* s_offsets,
                                       i64* s_indices) {
  strength_fill_impl<double>(n, offsets, indices, vals, theta2, diag, s_offsets, s_indices);
}

extern "C" void spmx_strength_fill_f32(i64 n, const i64* offsets, const u32* indices,
                                       const float* vals, double theta2,
                                       const double* diag, const i64* s_offsets,
                                       i64* s_indices) {
  strength_fill_impl<float>(n, offsets, indices, vals, theta2, diag, s_offsets, s_indices);
}

// Row-scaled copy out[k] = vals[k] * s[row(k)]  (amg.py _scale_rows: the
// prolongator-smoothing product's diag(s) @ A operand, one sweep, no
// dtype-conversion temporaries).
template <typename V>
static void scale_rows_impl(i64 n, const i64* offsets, const V* vals,
                            const double* s, V* out) {
  for (i64 i = 0; i < n; ++i) {
    double si = s[i];
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k)
      out[k] = (V)((double)vals[k] * si);
  }
}

extern "C" void spmx_scale_rows_f64(i64 n, const i64* offsets, const double* vals,
                                    const double* s, double* out) {
  scale_rows_impl<double>(n, offsets, vals, s, out);
}

extern "C" void spmx_scale_rows_f32(i64 n, const i64* offsets, const float* vals,
                                    const double* s, float* out) {
  scale_rows_impl<float>(n, offsets, vals, s, out);
}

// Jacobi smoother values out[k] = -vals[k] * ws[row(k)] + (1 at the
// diagonal) in one sweep (amg.py _jacobi_smoother_matrix: S = I -
// diag(ws) A sharing A's pattern). Returns the number of rows holding an
// explicit diagonal entry — the caller requires it to equal n.
template <typename V>
static i64 jacobi_smoother_impl(i64 n, const i64* offsets, const u32* indices,
                                const V* vals, const double* ws, V* out) {
  i64 ndiag = 0;
  for (i64 i = 0; i < n; ++i) {
    double wi = ws[i];
    bool seen = false;
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      double v = -(double)vals[k] * wi;
      if ((i64)indices[k] == i) {
        v += 1.0;
        if (!seen) { seen = true; ++ndiag; }
      }
      out[k] = (V)v;
    }
  }
  return ndiag;
}

extern "C" i64 spmx_jacobi_smoother_f64(i64 n, const i64* offsets, const u32* indices,
                                        const double* vals, const double* ws, double* out) {
  return jacobi_smoother_impl<double>(n, offsets, indices, vals, ws, out);
}

extern "C" i64 spmx_jacobi_smoother_f32(i64 n, const i64* offsets, const u32* indices,
                                        const float* vals, const double* ws, float* out) {
  return jacobi_smoother_impl<float>(n, offsets, indices, vals, ws, out);
}

// Colmap SpGEMM: C = A @ T where T has AT MOST ONE entry per row — the
// degenerate mul_hash case (spam_csr/src/mul_hash.rs) that
// needs no hash table at all: C[i, tmap[j]] += A[i,j] * tval[j], i.e. a
// column relabel + per-row duplicate merge. This is exactly the AMG
// prolongator-smoothing product (S @ T with T the tentative prolongator),
// which on a 2048^2 Poisson setup was the single largest hash-SpGEMM call.
// tmap[j] = 0xFFFFFFFF marks an empty T row (entry dropped). Rows of A must
// be short enough that an insertion-grade std::sort is cheap (always true
// for the mesh/aggregation matrices this serves). Computed zeros are KEPT,
// matching the hash engine's semantics. out_* are sized nnz(A) (upper
// bound); returns the exact output nnz, fills out_offsets[0..rows].
template <typename V>
static i64 colmap_spgemm_impl(i64 rows, const i64* offsets, const u32* indices,
                              const V* vals, const u32* tmap, const V* tval,
                              i64* out_offsets, u32* out_indices, V* out_vals) {
  std::vector<std::pair<u32, V>> buf;
  i64 w = 0;
  out_offsets[0] = 0;
  for (i64 r = 0; r < rows; ++r) {
    buf.clear();
    bool sorted = true;
    for (i64 p = offsets[r]; p < offsets[r + 1]; ++p) {
      u32 j = indices[p];
      u32 c = tmap[j];
      if (c == 0xFFFFFFFFu) continue;
      if (!buf.empty() && c < buf.back().first) sorted = false;
      buf.push_back({c, vals[p] * tval[j]});
    }
    // rows are short (mesh/aggregation matrices) and usually already
    // sorted after the relabel (aggregate ids grow with fine index):
    // insertion sort beats a std::sort call per row ~2x at 21M nnz
    if (!sorted) {
      for (size_t k = 1; k < buf.size(); ++k) {
        std::pair<u32, V> key = buf[k];
        size_t j2 = k;
        for (; j2 > 0 && buf[j2 - 1].first > key.first; --j2) buf[j2] = buf[j2 - 1];
        buf[j2] = key;
      }
    }
    for (size_t k = 0; k < buf.size();) {
      u32 c = buf[k].first;
      V acc = buf[k].second;
      for (++k; k < buf.size() && buf[k].first == c; ++k) acc += buf[k].second;
      out_indices[w] = c;
      out_vals[w] = acc;
      ++w;
    }
    out_offsets[r + 1] = w;
  }
  return w;
}

// Fused prolongator smoothing: P = (I - diag(ws) A) @ T in ONE pass over
// A, where T (tentative) has at most one entry per row (tmap/tval form,
// 0xFFFFFFFF = empty). Per A entry (r, j, a): term value
// (V)((r==j) - a*ws[r]) * tval[j] — identical per-term rounding to the
// materialize-S-then-colmap pipeline it replaces (S's write+read of
// nnz(A) values and the smoother sweep were ~1.3 s of the 2048^2 AMG
// setup). Rows of A lacking an explicit diagonal get the identity's
// T-row injected as an extra term (the unfused path could not reuse A's
// pattern there at all and fell back to a union-merge subtraction).
template <typename V>
static i64 colmap_smoothed_impl(i64 rows, const i64* offsets,
                                const u32* indices, const V* vals,
                                const double* ws, const u32* tmap,
                                const V* tval, i64* out_offsets,
                                u32* out_indices, V* out_vals) {
  std::vector<std::pair<u32, V>> buf;
  i64 w = 0;
  out_offsets[0] = 0;
  for (i64 r = 0; r < rows; ++r) {
    buf.clear();
    bool sorted = true, saw_diag = false;
    double wr = ws[r];
    for (i64 p = offsets[r]; p < offsets[r + 1]; ++p) {
      u32 j = indices[p];
      u32 c = tmap[j];
      double base = -(double)vals[p] * wr;
      if ((i64)j == r) { base += 1.0; saw_diag = true; }
      if (c == 0xFFFFFFFFu) continue;
      if (!buf.empty() && c < buf.back().first) sorted = false;
      buf.push_back({c, (V)base * tval[j]});
    }
    if (!saw_diag) {  // identity column r (caller guarantees square A)
      u32 c = tmap[r];
      if (c != 0xFFFFFFFFu) {
        if (!buf.empty() && c < buf.back().first) sorted = false;
        buf.push_back({c, tval[r]});
      }
    }
    if (!sorted) {
      for (size_t k = 1; k < buf.size(); ++k) {
        std::pair<u32, V> key = buf[k];
        size_t j2 = k;
        for (; j2 > 0 && buf[j2 - 1].first > key.first; --j2) buf[j2] = buf[j2 - 1];
        buf[j2] = key;
      }
    }
    for (size_t k = 0; k < buf.size();) {
      u32 c = buf[k].first;
      V acc = buf[k].second;
      for (++k; k < buf.size() && buf[k].first == c; ++k) acc += buf[k].second;
      out_indices[w] = c;
      out_vals[w] = acc;
      ++w;
    }
    out_offsets[r + 1] = w;
  }
  return w;
}

extern "C" i64 spmx_colmap_smoothed_f32(i64 rows, const i64* offsets,
                                        const u32* indices, const float* vals,
                                        const double* ws, const u32* tmap,
                                        const float* tval, i64* out_offsets,
                                        u32* out_indices, float* out_vals) {
  return colmap_smoothed_impl<float>(rows, offsets, indices, vals, ws, tmap,
                                     tval, out_offsets, out_indices, out_vals);
}
extern "C" i64 spmx_colmap_smoothed_f64(i64 rows, const i64* offsets,
                                        const u32* indices, const double* vals,
                                        const double* ws, const u32* tmap,
                                        const double* tval, i64* out_offsets,
                                        u32* out_indices, double* out_vals) {
  return colmap_smoothed_impl<double>(rows, offsets, indices, vals, ws, tmap,
                                      tval, out_offsets, out_indices, out_vals);
}

extern "C" i64 spmx_colmap_spgemm_f32(i64 rows, const i64* offsets,
                                      const u32* indices, const float* vals,
                                      const u32* tmap, const float* tval,
                                      i64* out_offsets, u32* out_indices,
                                      float* out_vals) {
  return colmap_spgemm_impl<float>(rows, offsets, indices, vals, tmap, tval,
                                   out_offsets, out_indices, out_vals);
}
extern "C" i64 spmx_colmap_spgemm_f64(i64 rows, const i64* offsets,
                                      const u32* indices, const double* vals,
                                      const u32* tmap, const double* tval,
                                      i64* out_offsets, u32* out_indices,
                                      double* out_vals) {
  return colmap_spgemm_impl<double>(rows, offsets, indices, vals, tmap, tval,
                                    out_offsets, out_indices, out_vals);
}
