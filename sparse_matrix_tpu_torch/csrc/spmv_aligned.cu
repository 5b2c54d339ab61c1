// Aligned SpMV: slot lane == destination row % 128, so every product is
// already a per-row contribution:
//   y[chunk_rb[c]*128 + l] += vals[c, l] * x[col_off[c]*128 + lane[c, l]].
//
// Replaces: sparse_matrix_tpu/ops/spmv.py, _make_aligned_kernel (called by
// _spmv_aligned_jit).
//
// Bound on the H100: device-memory bandwidth, about 5 bytes per slot (f32
// value + int8 lane) plus 8 bytes of chunk metadata per 128 slots; the x
// window of a chunk is one 512-byte line that L2 serves to its neighbours.
//
// First version: one thread per slot and one atomicAdd per slot. A warp
// covers 32 consecutive lanes of one chunk, so its loads are coalesced and
// its 32 atomics hit 32 distinct y words. The TPU kernel's two-target slab
// split (rb_a/rb_b/split) and its alternating y buffers serialised the
// accumulation of a sequential grid; with atomics the chunks of a slab need
// no ordering, so the plan's chunk_rb is the only target array read.
// Padding slots hold zero values and add exact zeros. The caller zeroes y.
// Atomics make the rounding of a row's sum vary from run to run.
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

__global__ void aligned_kernel(const float* __restrict__ vals,
                               const int8_t* __restrict__ lane,
                               const int32_t* __restrict__ col_off,
                               const int32_t* __restrict__ chunk_rb,
                               int64_t num_slots, int64_t cols,
                               const float* __restrict__ x,
                               float* __restrict__ y) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= num_slots) return;
  const int64_t c = t >> 7;
  const int l = (int)(t & 127);
  // lanes of an aligned plan are column % 128, in [0, 128)
  const int64_t j = (int64_t)__ldg(col_off + c) * 128 + lane[t];
  const float xv = j < cols ? __ldg(x + j) : 0.0f;
  atomicAdd(y + (int64_t)__ldg(chunk_rb + c) * 128 + l, vals[t] * xv);
}

}  // namespace

SPMX_API int spmx_aligned(int device, const float* vals, const int8_t* lane,
                          const int32_t* col_off, const int32_t* chunk_rb,
                          int64_t num_chunks, int64_t cols, const float* x,
                          float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_chunks == 0) return 0;
  const int threads = 256;
  const int64_t slots = num_chunks * 128;
  const int64_t blocks = (slots + threads - 1) / threads;
  aligned_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      vals, lane, col_off, chunk_rb, slots, cols, x, y);
  return (int)cudaGetLastError();
}
