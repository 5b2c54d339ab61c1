// ESC SpGEMM k-major expansion: for every product slot s of chunk c = s >> 7,
//   p[s] = lv[lv_off[c]*128 + lv_lane[s]] * rv[rv_off[c]*128 + rv_lane[s]]
// for s < num_products (an operand position past the end of its array
// reads 0), and p[s] = 0 on the padding slots past num_products.
//
// Replaces: sparse_matrix_tpu/ops/esc_expand.py, _make_expand_kernel (called
// by _expand_jit).
//
// Bound on the H100: device-memory bandwidth. Each slot reads two int16
// lanes and writes one f32 product (8 bytes), each chunk two int32 window
// rows; the operand values are gathered from short windows that L2 serves
// to the neighbouring slots of a chunk.
//
// First version: one thread per slot. The TPU kernel sliced a (kw, 128)
// window of each operand per chunk into VMEM and gathered lanes from it
// (a loop of kw masked gathers); here a thread reads its two operands
// directly at window row + lane, bounds-checked, so the operands need no
// window padding and no window width limit but the int16 lane range. A warp
// covers 32 consecutive slots of one chunk: its lane, offset and product
// accesses are coalesced. Every product is one IEEE f32 multiply (no
// contraction), equal bit for bit to the plain version's.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

__global__ void esc_expand_kernel(const float* __restrict__ lv, int64_t n_lv,
                                  const float* __restrict__ rv, int64_t n_rv,
                                  const int16_t* __restrict__ lv_lane,
                                  const int16_t* __restrict__ rv_lane,
                                  const int32_t* __restrict__ lv_off,
                                  const int32_t* __restrict__ rv_off,
                                  int64_t num_products, int64_t num_slots,
                                  float* __restrict__ p) {
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s >= num_slots) return;
  if (s >= num_products) {
    p[s] = 0.0f;
    return;
  }
  const int64_t c = s >> 7;
  const int64_t i = (int64_t)__ldg(lv_off + c) * 128 + lv_lane[s];
  const int64_t j = (int64_t)__ldg(rv_off + c) * 128 + rv_lane[s];
  const float a = i < n_lv ? __ldg(lv + i) : 0.0f;
  const float b = j < n_rv ? __ldg(rv + j) : 0.0f;
  p[s] = __fmul_rn(a, b);
}

}  // namespace

SPMX_API int spmx_esc_expand(int device, const float* lv, int64_t n_lv,
                             const float* rv, int64_t n_rv,
                             const int16_t* lv_lane, const int16_t* rv_lane,
                             const int32_t* lv_off, const int32_t* rv_off,
                             int64_t num_products, int64_t num_slots, float* p,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_slots == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (num_slots + threads - 1) / threads;
  esc_expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      lv, n_lv, rv, n_rv, lv_lane, rv_lane, lv_off, rv_off, num_products,
      num_slots, p);
  return (int)cudaGetLastError();
}
