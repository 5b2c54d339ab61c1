// Run sums of the ESC sort reduction: with the key order planned once
// (`order`: for each position of the stably sorted product keys, the plan
// slot whose product goes there; `run_off`: the first sorted position of
// each run of equal keys, and the end),
//   val[r] = ((0 + p[order[i0]]) + p[order[i0 + 1]]) + ...   over the run's
// positions in sorted order, for r < num_summed, and val[r] = 0 for
// num_summed <= r < cap (the padding slots' sentinel run, whose products are
// all 0, and the capacity past the runs).
//
// Replaces no TPU kernel: the reference sorts the keys with the products on
// every multiply and sums each run with an XLA segment sum
// (sparse_matrix_tpu/ops/device_sorted.py, _packed_run_reduce). Here the
// key order is plan data, so a multiply is the expansion kernel and this
// one pass.
//
// Bound on the H100: device-memory bandwidth (order, p gathered through it,
// run_off, val). Each run is summed by one thread, in sorted order, each add
// rounded on its own: the same bits on every call and the same as the CPU's
// sequential index_add_ (atomics would add in no fixed order). Runs are
// short (1.7 products on femlike_262k squared), so a thread waits on three
// dependent loads (run_off, order, p) a run; a thread takes kRuns runs,
// kThreads apart, and interleaves their loads. The design search (device
// ms, femlike_262k / randlocal_262k squared; PERF.md §6): one run a thread
// 0.1288 / 0.5279, two 0.1018 / 0.4968, four 0.1024 / 0.5022, eight 0.1178
// / 0.5081; a block staging its runs' products in shared memory 0.1293 /
// 0.5892.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = 2;  // runs a thread, kThreads apart

__global__ void __launch_bounds__(kThreads)
    esc_run_sum_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ run_off,
                       const float* __restrict__ p, int num_summed, int cap,
                       float* __restrict__ val) {
  const int r0 = blockIdx.x * kThreads * kRuns + threadIdx.x;
  int i[kRuns], end[kRuns];
  float acc[kRuns];
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int r = r0 + k * kThreads;
    const bool summed = r < num_summed;
    i[k] = summed ? __ldg(run_off + r) : 0;
    end[k] = summed ? __ldg(run_off + r + 1) : 0;
    acc[k] = 0.0f;
  }
  bool more = true;
  while (more) {
    int o[kRuns];
    float v[kRuns];
#pragma unroll
    for (int k = 0; k < kRuns; ++k) o[k] = i[k] < end[k] ? __ldg(order + i[k]) : -1;
#pragma unroll
    for (int k = 0; k < kRuns; ++k) v[k] = o[k] >= 0 ? __ldg(p + o[k]) : 0.0f;
    more = false;
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      if (o[k] >= 0) {
        acc[k] = __fadd_rn(acc[k], v[k]);
        more |= ++i[k] < end[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int r = r0 + k * kThreads;
    if (r < cap) val[r] = acc[k];
  }
}

}  // namespace

SPMX_API int spmx_esc_run_sum(const SpmxRunSumPlan* plan, const float* p, float* val,
                              void* stream) {
  cudaError_t err = cudaSetDevice(plan->device);
  if (err != cudaSuccess) return (int)err;
  if (plan->cap > (1LL << 30) || plan->num_summed < 0 || plan->num_summed > plan->cap)
    return (int)cudaErrorInvalidValue;
  if (plan->cap == 0) return 0;
  const int64_t per_block = (int64_t)kThreads * kRuns;
  const int64_t blocks = (plan->cap + per_block - 1) / per_block;
  esc_run_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      plan->order, plan->run_off, p, (int)plan->num_summed, (int)plan->cap, val);
  return (int)cudaGetLastError();
}
