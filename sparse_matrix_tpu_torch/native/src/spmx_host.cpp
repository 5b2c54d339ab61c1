// Host runtime of the port: the incomplete factorizations and the exact
// triangular solve of solvers/ilu.py.
//
// A copy of ilu0_impl, trisolve_impl and ilut_impl with their f32 and f64
// entry points from sparse_matrix_tpu/native/src/spmx_native.cpp (the
// reference's native runtime), so the port factors a 4M-row matrix in
// seconds without importing the JAX package. Built by
// sparse_matrix_tpu_torch/native/host.py with g++ into
// _build/libspmx_torch_host.so and bound with ctypes.
//
// All three are sequential along the row-dependency chain: irregular host
// work, as in the reference. Every routine requires sorted column indices.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

typedef int64_t i64;
typedef uint32_t u32;

#define SPMX_HOST_API extern "C" __attribute__((visibility("default")))

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
