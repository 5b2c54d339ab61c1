// Aligned SpMM in the packed multi-RHS layout: x3 (c128 + 1, K, 128) holds
// x[j, k] at x3[j/128, k, j%128]; y3 (>= r128, K, 128) the same for y. Slot
// lane == destination row % 128, so each product is a per-row contribution:
//   y3[chunk_rb[c], k, l] += vals[c, l] * x3[col_off[c], k, lane[c, l]]
// (x past cols reads 0).
//
// Replaces: sparse_matrix_tpu/ops/spmm.py, _make_aligned_spmm_kernel
// (called by _spmm_aligned_jit).
//
// Bound on the H100: device-memory bandwidth. A slot's value and lane (5
// bytes) and its chunk's metadata are read once for all K columns; x3 and
// y3 move 4*K bytes per row; the (K, 128) x window of a chunk is served by
// L2 to the chunk's 128 slots.
//
// First version: one thread per slot, as in spmv_aligned.cu, looping over
// the K columns: K atomicAdds a slot, each warp's 32 atomics on 32
// neighbouring words of one (row block, k) plane. The TPU kernel's
// two-target slab split (rb_a/rb_b/split) and alternating y buffers
// serialised a sequential grid; here only chunk_rb is read. The LanePack
// spill of a plan is not this kernel's work (the wrapper runs the SpMV
// kernel on it column by column). The caller zeroes y3; padding slots add
// exact zeros; atomics make a row's sum vary in its last bits.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

__global__ void aligned_spmm_kernel(const float* __restrict__ vals,
                                    const int8_t* __restrict__ lane,
                                    const int32_t* __restrict__ col_off,
                                    const int32_t* __restrict__ chunk_rb,
                                    int64_t num_slots, int64_t cols, int k,
                                    const float* __restrict__ x3,
                                    float* __restrict__ y3) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= num_slots) return;
  const int64_t c = t >> 7;
  const int l = (int)(t & 127);
  const int64_t w = __ldg(col_off + c);
  const int ln = lane[t];
  const float v = vals[t];
  const bool inside = w * 128 + ln < cols;
  const float* xp = x3 + (w * k) * 128 + ln;
  float* yp = y3 + ((int64_t)__ldg(chunk_rb + c) * k) * 128 + l;
  for (int q = 0; q < k; ++q) {
    const float xv = inside ? __ldg(xp + q * 128) : 0.0f;
    atomicAdd(yp + q * 128, v * xv);
  }
}

}  // namespace

SPMX_API int spmx_aligned_spmm(int device, const float* vals,
                               const int8_t* lane, const int32_t* col_off,
                               const int32_t* chunk_rb, int64_t num_chunks,
                               int64_t cols, int k, const float* x3, float* y3,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_chunks == 0 || k == 0) return 0;
  const int threads = 256;
  const int64_t slots = num_chunks * 128;
  const int64_t blocks = (slots + threads - 1) / threads;
  aligned_spmm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      vals, lane, col_off, chunk_rb, slots, cols, k, x3, y3);
  return (int)cudaGetLastError();
}
