// Fused banded triangular Jacobi sweeps. With T = D + N, N strictly
// triangular in DIA form (data (nb, rows), offsets) and dinv = 1 / diag(T):
//   x_0 = dinv * b,  x_{k+1} = dinv * (b - N x_k)  for k < sweeps,
// y = x_sweeps, every sweep in one cooperative launch.
//
// Replaces: sparse_matrix_tpu/ops/trisweep.py, _make_trisweep_kernel (called
// by _trisweep_call).
//
// Bound on the H100: device-memory bandwidth. The compulsory traffic is the
// band planes, b and dinv read once and y written once ((nb + 3) * rows * 4
// bytes); a sweep does 2 * nb + 2 flops per row, far below the f32 peak.
//
// First version. The TPU kernel kept x in VMEM through all sweeps of a
// one-step grid; at Poisson 2048^2 x alone is 16.8 MB, more than the shared
// memory of the whole card. Here x ping-pongs between two device buffers
// (the output and a scratch vector, which the 50 MB L2 mostly holds), and a
// grid-wide barrier (cooperative_groups::this_grid().sync()) separates the
// sweeps. The grid is as large as can be co-resident (occupancy x SMs) and
// threads walk the rows in grid-stride loops, so one warp reads each band
// plane as coalesced lines. Each sweep re-reads the planes, b and dinv
// ((nb + 2) * rows * 4 bytes a sweep): the design trades those re-reads for
// one launch per solve in place of 1 + 3 * sweeps.
//
// x is never updated in place: that would be Gauss-Seidel-like chaotic
// relaxation, not Jacobi, and would break the polynomial identity that
// makes IC's M^-1 = S^T S symmetric. The iterate written during the kernel
// is read with __ldcg (from L2, not through the incoherent L1 or read-only
// path). Bands are summed in plan order with __fmul_rn / __fadd_rn, then
// __fsub_rn and __fmul_rn: no contraction into FMA, so the result equals
// the plain version (ops/trisweep.py::_trisweep_torch) bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "spmx_cuda.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void trisweep_kernel(const float* __restrict__ data,
                                const int32_t* __restrict__ offsets, int nb,
                                int64_t rows, const float* __restrict__ b,
                                const float* __restrict__ dinv, int sweeps,
                                float* scratch, float* y) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // x_k lives in y when sweeps - k is even, so x_sweeps lands in y
  float* cur = (sweeps % 2 == 0) ? y : scratch;
  for (int64_t i = start; i < rows; i += stride) {
    cur[i] = __fmul_rn(__ldg(dinv + i), __ldg(b + i));
  }
  for (int k = 0; k < sweeps; ++k) {
    grid.sync();
    float* nxt = (cur == y) ? scratch : y;
    for (int64_t i = start; i < rows; i += stride) {
      float acc = 0.0f;
      for (int bnd = 0; bnd < nb; ++bnd) {
        const int64_t j = i + __ldg(offsets + bnd);
        const float xv = (j >= 0 && j < rows) ? __ldcg(cur + j) : 0.0f;
        acc = __fadd_rn(acc, __fmul_rn(__ldg(data + (int64_t)bnd * rows + i), xv));
      }
      nxt[i] = __fmul_rn(__ldg(dinv + i), __fsub_rn(__ldg(b + i), acc));
    }
    cur = nxt;
  }
}

}  // namespace

SPMX_API int spmx_trisweep(int device, const float* data,
                           const int32_t* offsets, int nb, int64_t rows,
                           const float* b, const float* dinv, int sweeps,
                           float* scratch, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trisweep_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (rows + kThreads - 1) / kThreads;
  const int64_t resident = (int64_t)per_sm * sms;
  const int64_t grid = need < resident ? need : resident;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&data, (void*)&offsets, (void*)&nb,      (void*)&rows,
                  (void*)&b,    (void*)&dinv,    (void*)&sweeps,  (void*)&scratch,
                  (void*)&y};
  err = cudaLaunchCooperativeKernel((const void*)trisweep_kernel, dim3((unsigned)grid),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
