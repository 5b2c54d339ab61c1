// Streaming DIA SpMV: y[i] = sum_b data[b, i] * x[i + off_b].
//
// Replaces: sparse_matrix_tpu/ops/spmv_dia.py, _make_dia_kernel (called by
// _spmv_dia_pallas).
//
// Bound on the H100: device-memory bandwidth. Each band slot is read once
// (4 bytes per nnz in f32 planes, 2 in bf16) and there are no indices; x and
// y add 8 bytes per row, and x's neighbouring bands hit L2.
//
// First version: one thread per row walks the bands in plan order, so every
// band plane is read by a warp as one coalesced 128-byte (f32) line and the
// sum is taken in the reference's order, in f32. The TPU kernel's (8, 128)
// blocking, two-view lane shifts and guard rows existed to keep x slices
// static in VMEM; here an x index outside [0, cols) simply reads 0, which
// matches the zero-padded x of _spmv_dia_jit. Rectangular operators and
// bf16 planes (widened before the multiply) take the same path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void dia_kernel(const T* __restrict__ data,
                           const int32_t* __restrict__ offsets, int nb,
                           int64_t rows, int64_t cols,
                           const float* __restrict__ x, float* __restrict__ y) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float acc = 0.0f;
  for (int b = 0; b < nb; ++b) {
    const int64_t j = i + __ldg(offsets + b);
    const float xv = (j >= 0 && j < cols) ? __ldg(x + j) : 0.0f;
    acc += widen(data[(int64_t)b * rows + i]) * xv;
  }
  y[i] = acc;
}

}  // namespace

SPMX_API const char* spmx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

SPMX_API int spmx_dia(int device, const void* data, int values_bf16,
                      const int32_t* offsets, int nb, int64_t rows,
                      int64_t cols, const float* x, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (rows + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    dia_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)data, offsets, nb, rows, cols, x, y);
  } else {
    dia_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)data, offsets, nb, rows, cols, x, y);
  }
  return (int)cudaGetLastError();
}
