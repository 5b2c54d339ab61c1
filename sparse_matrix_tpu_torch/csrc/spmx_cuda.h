// Plain C interface of the port's CUDA kernels (bound with ctypes by
// sparse_matrix_tpu_torch/native/kernels.py).
//
// Every entry point selects `device`, enqueues one kernel on `stream` (a
// cudaStream_t passed as void*), never synchronises and allocates nothing:
// the Python wrapper owns every buffer. The return value is
// cudaGetLastError() after the launch (0 = launched). Outputs that the
// kernel accumulates into with atomics (aligned, LanePack, stripe, aligned
// SpMM, LanePack SpMM) must be zeroed by the caller.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
#define SPMX_API extern "C" __attribute__((visibility("default")))
#else
#define SPMX_API __attribute__((visibility("default")))
#endif

// cudaGetErrorString of a code returned below
SPMX_API const char* spmx_cuda_error_string(int err);

// y[i] = sum_b data[b, i] * x[i + offsets[b]]  (x outside [0, cols) reads 0)
// data: (nb, rows), f32 (values_bf16 = 0) or bf16 bits (values_bf16 = 1)
SPMX_API int spmx_dia(int device, const void* data, int values_bf16,
                      const int32_t* offsets, int nb, int64_t rows,
                      int64_t cols, const float* x, float* y, void* stream);

// y[chunk_rb[c]*128 + l] += vals[c, l] * x[col_off[c]*128 + lane[c, l]]
SPMX_API int spmx_aligned(int device, const float* vals, const int8_t* lane,
                          const int32_t* col_off, const int32_t* chunk_rb,
                          int64_t num_chunks, int64_t cols, const float* x,
                          float* y, void* stream);

// per chunk: p = vals * x[col_off*128 + lane]; incl = inclusive scan of p;
// y[chunk_rb*128 + l] += incl[ends[l]] - (starts[l] < 0 ? 0 : incl[starts[l]])
SPMX_API int spmx_lanepack(int device, const float* vals, const int16_t* lane,
                           const int8_t* ends, const int8_t* starts,
                           const int32_t* col_off, const int32_t* chunk_rb,
                           int64_t num_chunks, int64_t cols, const float* x,
                           float* y, void* stream);

// y[rb*128 + l] = sum_layer vals[layer, rb, l] * x[(rb + ds[layer] + (pos >> 7))*128
//                                                  + (pos & 127)],
// pos = lane[layer, rb, l] + bias; lanes int8 (lane_bytes = 1) or int16 (2);
// values f32 (values_bf16 = 0) or bf16 bits (1)
SPMX_API int spmx_bell(int device, const void* vals, int values_bf16,
                       const void* lane, int lane_bytes, int bias,
                       const int32_t* ds, int num_layers, int64_t r128,
                       int64_t rows, int64_t cols, const float* x, float* y,
                       void* stream);

// per slab s of 8 chunks and level l < levels, lane d:
// y[(stripe_rb[s] + l)*128 + d] += sum_chunks g, with p = vals * x[col_off*128
// + lane] and g = incl[ends] - (starts < 0 ? 0 : incl[starts]) (scan mode,
// starts != NULL) or g = p[ends] (select mode, starts == NULL); ends/starts
// (S, levels, 8, 128) int8; lanes int8 (lane_bytes = 1) or int16 (2)
SPMX_API int spmx_stripe(int device, const float* vals, const void* lane,
                         int lane_bytes, const int8_t* ends,
                         const int8_t* starts, const int32_t* stripe_rb,
                         const int32_t* col_off, int64_t num_slabs, int levels,
                         int64_t cols, const float* x, float* y, void* stream);

// packed K-column DIA SpMM (1 <= k <= 16): x3 (.., k, 128) with x[j, :] at row
// x_lo + j/128; y3 (y_rows_total, k, 128) with y[i, :] at row y_lo + i/128,
// every other element of y3 written 0
SPMX_API int spmx_dia_spmm(int device, const void* data, int values_bf16,
                           const int32_t* offsets, int nb, int64_t rows,
                           int64_t cols, int k, const float* x3, int64_t x_lo,
                           float* y3, int64_t y_lo, int64_t y_rows_total,
                           void* stream);

// packed K-column aligned SpMM:
// y3[chunk_rb[c], q, l] += vals[c, l] * x3[col_off[c], q, lane[c, l]]
SPMX_API int spmx_aligned_spmm(int device, const float* vals,
                               const int8_t* lane, const int32_t* col_off,
                               const int32_t* chunk_rb, int64_t num_chunks,
                               int64_t cols, int k, const float* x3, float* y3,
                               void* stream);

// packed K-column LanePack SpMM (k >= 1): per chunk c and column q,
// p = vals * x3[col_off + (lane >> 7), q, lane & 127] (x past cols reads 0);
// incl = inclusive scan of p over the chunk;
// y3[chunk_rb[c], q, l] += incl[ends[l]] - (starts[l] < 0 ? 0 : incl[starts[l]])
SPMX_API int spmx_lanepack_spmm(int device, const float* vals,
                                const int16_t* lane, const int8_t* ends,
                                const int8_t* starts, const int32_t* col_off,
                                const int32_t* chunk_rb, int64_t num_chunks,
                                int64_t cols, int k, const float* x3, float* y3,
                                void* stream);

// packed K-column BELL SpMM (1 <= k <= 16): with pos = lane[layer, rb, l] + bias
// and j = (rb + ds[layer] + (pos >> 7))*128 + (pos & 127),
// y3[rb, q, l] = sum_layer vals[layer, rb, l] * x3[j/128, q, j%128]
// (j outside [0, cols) reads 0); every element of y3 (r128, k, 128) is written
SPMX_API int spmx_bell_spmm(int device, const void* vals, int values_bf16,
                            const void* lane, int lane_bytes, int bias,
                            const int32_t* ds, int num_layers, int64_t r128,
                            int64_t cols, int k, const float* x3, float* y3,
                            void* stream);

// BCSR SpMM: y[br*bs + i, n] = sum_{p in block row br} sum_j
// blocks[p, i, j] * x[block_cols[p]*bs + j, n]; x (bcols*bs, f), y (brows*bs, f)
// row-major, f a multiple of 128, bs a multiple of 16 in [16, 128]; every
// element of y is written (block rows with no block get 0)
SPMX_API int spmx_bcsr_spmm(int device, const float* blocks,
                            const int32_t* block_cols,
                            const int32_t* block_offsets, int64_t brows, int bs,
                            int64_t f, const float* x, float* y, void* stream);

// block SpGEMM numeric phase: c[q] = sum_{p in [seg[q], seg[q+1])}
// a_blocks[pair_a[p]] @ b_blocks[pair_b[p]] (bs x bs each, f32 or bf16 bits
// for blocks_bf16 = 1; c f32), summed in pair order in FP32; every element of
// c (num_c, bs, bs) is written
SPMX_API int spmx_block_spgemm(int device, const void* a_blocks,
                               const void* b_blocks, int blocks_bf16,
                               const int32_t* pair_a, const int32_t* pair_b,
                               const int32_t* seg, int64_t num_c, int bs,
                               float* c, void* stream);

// ESC k-major expansion, per slot s of chunk c = s >> 7:
// p[s] = lv[lv_off[c]*128 + lv_lane[s]] * rv[rv_off[c]*128 + rv_lane[s]] for
// s < num_products (positions past n_lv / n_rv read 0), p[s] = 0 for
// num_products <= s < num_slots; every element of p (num_slots,) is written
SPMX_API int spmx_esc_expand(int device, const float* lv, int64_t n_lv,
                             const float* rv, int64_t n_rv,
                             const int16_t* lv_lane, const int16_t* rv_lane,
                             const int32_t* lv_off, const int32_t* rv_off,
                             int64_t num_products, int64_t num_slots, float* p,
                             void* stream);
