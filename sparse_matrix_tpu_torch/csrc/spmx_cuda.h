// Plain C interface of the port's CUDA kernels (bound with ctypes by
// sparse_matrix_tpu_torch/native/kernels.py).
//
// Every entry point selects `device`, enqueues one kernel on `stream` (a
// cudaStream_t passed as void*), never synchronises and allocates nothing:
// the Python wrapper owns every buffer. The return value is
// cudaGetLastError() after the launch (0 = launched).
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

// the same in float64: data (nb, rows), x and y f64, summed in f64
SPMX_API int spmx_dia_f64(int device, const double* data, const int32_t* offsets,
                          int nb, int64_t rows, int64_t cols, const double* x,
                          double* y, void* stream);

// A plan of the aligned or LanePack SpMV kernel with its segments
// (segments.h), packed once by the wrapper: `segments` (num_segments, 4)
// int32 rows (row block, first chunk, chunk count, scratch slot or -1),
// sorted by row block, every row block holding at least one; `rb_seg`
// (r128 + 1) int32 offsets of each row block's segments; `scratch` (slots,
// 128) f32 and `tickets` (r128,) int32 (zero between launches) for row
// blocks of several segments. `ends`/`starts` are NULL for the aligned
// kernel. vals 16-byte, lane 4-byte (int8) or 8-byte (int16) aligned. The
// aligned and LanePack SpMM plans have their own `scratch` (slots, 16 *
// 128) and `tickets` (2 * r128).
typedef struct {
  const float* vals;
  const void* lane;
  const int8_t* ends;
  const int8_t* starts;
  const int32_t* col_off;
  const int32_t* segments;
  const int32_t* rb_seg;
  float* scratch;
  int32_t* tickets;
  int64_t num_segments;
  int64_t cols;
  int64_t rows;
  int32_t device;
} SpmxSegPlan;

// per row block rb: r[l] = sum over its segments' chunks c, in plan order, of
// vals[c, l] * x[col_off[c]*128 + lane[c, l]] (lane int8; x past cols reads
// 0); y[rb*128 + l] = r[l] (add = 0) or y[rb*128 + l] += r[l] (add = 1) for
// every row < rows; add = 0 writes every row of y[:rows]. y 16-byte aligned
SPMX_API int spmx_aligned(const SpmxSegPlan* plan, const float* x, float* y,
                          int add, void* stream);

// the LanePack form of spmx_aligned: per chunk, p = vals * x[col_off*128 +
// lane] (lane int16), incl = inclusive scan of p over the chunk, and lane l
// of the chunk's row block gets incl[ends[l]] - (starts[l] < 0 ? 0 :
// incl[starts[l]])
SPMX_API int spmx_lanepack(const SpmxSegPlan* plan, const float* x, float* y,
                           int add, void* stream);

// A BELL plan, packed once by the wrapper: `vals` (num_layers, r128, 128)
// f32 (values_bf16 = 0) or bf16 bits (1); `lane` the same
// shape, int8 (lane_bytes = 1) or int16 (2); `ds` (num_layers,) int32
// bucket bases
typedef struct {
  const void* vals;
  const void* lane;
  const int32_t* ds;
  int64_t r128;
  int64_t rows;
  int64_t cols;
  int32_t num_layers;
  int32_t bias;
  int32_t lane_bytes;
  int32_t values_bf16;
  int32_t device;
} SpmxBellPlan;

// with pos = lane[layer, rb, l] + bias:
// r = sum_layer vals[layer, rb, l] * x[(rb + ds[layer] + (pos >> 7))*128 + (pos & 127)]
// (x outside [0, cols) reads 0), summed in layer order; y[rb*128 + l] = r for
// every row < rows. add must be 0 (cudaErrorNotSupported otherwise): a
// BELL plan only writes y
SPMX_API int spmx_bell(const SpmxBellPlan* plan, const float* x, float* y, int add,
                       void* stream);

// A stripe plan with its segments (segments.h), packed once by the wrapper:
// slabs of 8 chunks, `vals` (S*8, 128) f32, `lane` (S*8, 128) int8
// (lane_bytes = 1) or int16 (2), `ends` and, in scan mode, `starts` (NULL
// in select mode) (S, levels, 8, 128) int8, `col_off` and `chunk_stripe`
// (S*8,) int32, `rb_mask` (>= stripes*levels,) f32; `segments`
// (num_segments, 4) int32 rows (stripe, first slab, slab count, scratch
// slot or -1), sorted by stripe, every stripe of the rows holding at least
// one; `stripe_seg` (stripes + 1) int32 offsets of each stripe's segments;
// `scratch` (slots, levels*128) f32 and `tickets` (stripes *
// ceil(levels / spmx_stripe_group_levels())) int32 (zero between
// launches) for stripes of several segments. `foreign_pad`: some slab of a
// stripe other than 0 holds padding chunks (chunk_stripe 0). Slab arrays,
// col_off, chunk_stripe, segments and scratch 16-byte aligned.
typedef struct {
  const float* vals;
  const void* lane;
  const int8_t* ends;
  const int8_t* starts;
  const int32_t* col_off;
  const int32_t* chunk_stripe;
  const float* rb_mask;
  const int32_t* segments;
  const int32_t* stripe_seg;
  float* scratch;
  int32_t* tickets;
  int64_t num_segments;
  int64_t cols;
  int64_t rows;
  int32_t levels;
  int32_t lane_bytes;
  int32_t foreign_pad;
  int32_t device;
} SpmxStripePlan;

// the levels one thread block of the stripe kernel owns (8); a plan of more
// levels launches ceil(levels / 8) blocks a segment, with a ticket each
SPMX_API int spmx_stripe_group_levels(void);

// per stripe (levels row blocks from stripe*levels) and chunk c of its
// slabs (slab s = c / 8), with p = vals * x[col_off*128 + lane] (x past cols
// reads 0): g[l, d] = incl[ends[s, l, c%8, d]] - (starts < 0 ? 0 :
// incl[starts]) (scan mode, incl the chunk's inclusive prefix sum of p) or
// g = p[ends] (select mode), zero for a chunk whose chunk_stripe is not the
// slab's; r = sum over the stripe's chunks, in segment then plan order, of
// g, plus 0 * x[0] on stripe 0 when foreign_pad; y[row] = r (add = 0) or
// y[row] += r (add = 1) for every row < rows of an unmasked row block, y =
// 0 (add = 0) or untouched (add = 1) on masked ones; y 16-byte aligned
SPMX_API int spmx_stripe(const SpmxStripePlan* plan, const float* x, float* y, int add,
                         void* stream);

// packed K-column DIA SpMM (1 <= k <= 16): x3 (.., k, 128) with x[j, :] at row
// x_lo + j/128; y3 (y_rows_total, k, 128) with y[i, :] at row y_lo + i/128,
// every other element of y3 written 0
SPMX_API int spmx_dia_spmm(int device, const void* data, int values_bf16,
                           const int32_t* offsets, int nb, int64_t rows,
                           int64_t cols, int k, const float* x3, int64_t x_lo,
                           float* y3, int64_t y_lo, int64_t y_rows_total,
                           void* stream);

// aligned SpMM on an aligned plan with its segments (the plan of
// spmx_aligned, with the SpMM's own scratch (slots, 16 * 128) and tickets
// (2 * r128)), columns q0 .. q0 + kq - 1 of k (1 <= kq <= 16): per chunk c
// and column q, row rb*128 + l of the chunk's row block gets vals[c, l] *
// X[col_off*128 + lane[c, l], q] (X past cols reads 0), summed in plan
// order within a segment and in segment order within a row block, each
// product and sum rounded on its own. Layouts, store and add mode as
// spmx_lanepack_spmm
SPMX_API int spmx_aligned_spmm(const SpmxSegPlan* plan, const float* x, float* y, int k,
                               int q0, int kq, int packed, int64_t y_blocks, int add,
                               void* stream);

// the most columns one launch of spmx_lanepack_spmm takes (16), and one
// warp of it (8): a plan's SpMM tickets are (16 / 8) * r128
SPMX_API int spmx_lanepack_spmm_max_cols(void);
SPMX_API int spmx_lanepack_spmm_group_cols(void);

// LanePack SpMM on a LanePack plan with its segments (the plan of
// spmx_lanepack, with the SpMM's own scratch and tickets), columns q0 ..
// q0 + kq - 1 of k (1 <= kq <= 16): per chunk c and column q, p = vals *
// X[col_off*128 + lane, q] (X past cols reads 0), incl = inclusive scan of
// p over the chunk, and row rb*128 + l of the chunk's row block gets
// incl[ends[l]] - (starts[l] < 0 ? 0 : incl[starts[l]]), summed in segment
// order. packed = 1: X (>= c128, k, 128) and Y (y_blocks, k, 128) with
// X[j, q] at x[(j/128*k + q)*128 + j%128]; store mode writes every lane of
// row blocks < r128 and zeros on row blocks r128 .. y_blocks - 1 (y_blocks
// >= r128). packed = 0: X (cols, k) and Y (rows, k) row-major; store mode
// writes every row < rows. add = 1 adds onto Y instead (the guard row
// blocks untouched). Y 16-byte aligned
SPMX_API int spmx_lanepack_spmm(const SpmxSegPlan* plan, const float* x, float* y, int k,
                                int q0, int kq, int packed, int64_t y_blocks, int add,
                                void* stream);

// BELL SpMM (1 <= k <= 16) on a BELL plan: with pos = lane[layer, rb, l] +
// bias and j = (rb + ds[layer] + (pos >> 7))*128 + (pos & 127), Y[i, q] =
// sum_layer vals[layer, rb, l] * X[j, q] for row i = rb*128 + l < rows
// (j outside [0, cols) adds nothing), in layer order, each product and
// sum rounded on its own; X (cols, k) and Y (rows, k) row-major, every row
// of Y written
SPMX_API int spmx_bell_spmm(const SpmxBellPlan* plan, const float* x, float* y, int k,
                            void* stream);

// the output tile edge of the two block kernels (64): their live-depth
// streams hold one segment per output tile
SPMX_API int spmx_block_tile(void);

// BCSR SpMM: y[br*bs + i, n] = sum_{p in block row br} sum_k
// blocks_t[p, k, i] * x[block_cols[p]*bs + k, n] (blocks_t the transposed
// blocks, (nnzb, bs, bs) f32, 16-byte aligned like x); x (bcols*bs, f),
// y (brows*bs, f) row-major (y 8-byte aligned), f a multiple of 128, bs a
// multiple of 16 in [16, 128]. When the device float *x_sum (the sum of
// x's elements) is finite, x holds no inf or NaN and only the live-depth
// stream is walked: for rows
// [64 t, 64 t + 64) of block row br, rows [stream_offsets[s],
// stream_offsets[s+1]) of stream (stream_len, 2) int32 pairs (blocks_t row,
// x row), s = br * ceil(bs / 64) + t; else every column of every block.
// Summed in f64 on the FP64 tensor cores, rounded to f32 once; every
// element of y is written (block rows with no block get 0)
SPMX_API int spmx_bcsr_spmm(int device, const float* blocks_t,
                            const int32_t* block_cols,
                            const int32_t* block_offsets, const int32_t* stream,
                            int64_t stream_len, const int32_t* stream_offsets,
                            const float* x_sum, int64_t brows, int bs,
                            int64_t f, const float* x, float* y, void* stream_handle);

// block SpGEMM numeric phase over the live-depth stream: 64 x 64 tile
// (tm, tn) of c[q] = sum_{e in [offsets[s], offsets[s+1])} outer(a_blocks_t
// row ia(e), b_blocks row ib(e)) on that tile, s = (q * tiles + tm) * tiles
// + tn, tiles = ceil(bs / 64); stream (stream_len, 2) int32 pairs (ia, ib) of rows of
// the transposed A blocks and of the B blocks (bs x bs each, f32 or bf16
// bits for blocks_bf16 = 1, 16-byte aligned; c 8-byte aligned); summed in f64 on the FP64 tensor cores and
// rounded to f32 once; every element of c (num_c, bs, bs) is written
SPMX_API int spmx_block_spgemm(int device, const void* a_blocks_t,
                               const void* b_blocks, int blocks_bf16,
                               const int32_t* stream, int64_t stream_len,
                               const int32_t* offsets, int64_t num_c, int bs,
                               float* c, void* stream_handle);

// A k-major expansion plan driven by its segments (esc_expand.cu), packed
// once by the wrapper: `segments` (num_segments + 1, 4) int32 rows (first
// slot, lk, la, ra) of every contraction index k with lk * rk > 0, in k
// order, and a sentinel row (num_products, 1, 0, 0); `tiles` (num_tiles, 8)
// int32 rows (first segment, a_lo, a_hi, e_lo, e_hi, last segment, 0, 0) of
// every tile of spmx_esc_expand_tile() slots: the segments holding its first
// and last real slot (the sentinel for a tile of padding) and the lhs and
// rhs positions its real slots read, [a_lo, a_hi) and [e_lo, e_hi); `perm`
// (n_lv,) int32, the lhs CSC -> CSR value permutation. segments, tiles and
// p 16-byte aligned; num_slots <= 2^30, a multiple of 8
typedef struct {
  const int32_t* segments;
  const int32_t* tiles;
  const int32_t* perm;
  int64_t num_segments;
  int64_t num_tiles;
  int64_t num_products;
  int64_t num_slots;
  int32_t device;
} SpmxEscPlan;

// the slots one block of spmx_esc_expand takes (2048), the most values of
// each operand window it stages in shared memory (2048) and the most
// segment starts (1024); a tile past either is read from device memory
SPMX_API int spmx_esc_expand_tile(void);
SPMX_API int spmx_esc_expand_stage(void);
SPMX_API int spmx_esc_expand_seg_stage(void);

// slot start + r*lk + l of segment (start, lk, la, ra), l < lk, gets p =
// lv[la + l] * rv[ra + r] (csr_order = 0: lv in CSC order) or
// lv[perm[la + l]] * rv[ra + r] (csr_order = 1: lv in CSR order), one f32
// multiply; p = 0 for num_products <= s < num_slots; every element of p
// (num_slots,) is written
SPMX_API int spmx_esc_expand(const SpmxEscPlan* plan, const float* lv, const float* rv,
                             int csr_order, float* p, void* stream);

// A sort reduction planned once (esc_run_sum.cu): `order` (cap,) int32, the
// plan slot of each position of the stably sorted keys; `run_off`
// (runs + 1,) int32, each run's first sorted position and the end;
// num_summed <= runs: the runs summed (the rest of val is written 0);
// cap <= 2^30
typedef struct {
  const int32_t* order;
  const int32_t* run_off;
  int64_t num_summed;
  int64_t cap;
  int32_t device;
} SpmxRunSumPlan;

// val[r] = p[order[run_off[r]]] + ... + p[order[run_off[r+1] - 1]], added in
// that order from +0, each add rounded on its own, for r < num_summed;
// val[r] = 0 for num_summed <= r < cap
SPMX_API int spmx_esc_run_sum(const SpmxRunSumPlan* plan, const float* p, float* val,
                              void* stream);

// A plan of the fused triangular sweeps (trisweep.cu), packed once by the
// wrapper: N = DIA(data (nb, rows) f32, offsets (nb,) int32, all negative
// or, with upper = 1, all positive; nb may be 0), reach = max |offset|;
// chunks of chunk_rows = 2^chunk_shift rows (32 .. 65536), chunks =
// ceil(rows / chunk_rows); tail = min(reach, chunk_rows); `scratch`
// (chunks, levels, tail) f32 and `flags` (chunks, levels) uint32 (zero
// when made) hold the rows each chunk publishes for levels < levels;
// `state` (2,) uint32 (zero when made) the self-resetting ticket and the
// launch epoch; halo = reach stages a chunk's neighbour rows of each level
// in shared memory, halo = 0 reads them from L2. One launch at a time per
// plan.
typedef struct {
  const float* data;
  const int32_t* offsets;
  float* scratch;
  uint32_t* flags;
  uint32_t* state;
  int64_t rows;
  int64_t chunks;
  int64_t reach;
  int32_t nb;
  int32_t chunk_rows;
  int32_t chunk_shift;
  int32_t tail;
  int32_t levels;
  int32_t upper;
  int32_t halo;
  int32_t device;
} SpmxTrisweepPlan;

// the threads of one block of the trisweep kernel (512; fewer for chunks
// of fewer rows)
SPMX_API int spmx_trisweep_threads(void);

// fused banded triangular Jacobi sweeps, one ordinary launch of one thread
// block a chunk: x_0 = dinv * b, x_{k+1} = dinv * (b - N x_k) for k <
// sweeps, y = x_sweeps, with N x = sum_b data[b, i] * x[i + offsets[b]] (x
// outside [0, rows) reads 0), summed in band order, each product, sum,
// difference and scaling rounded on its own; 0 <= sweeps <= levels (any
// sweeps when no chunk publishes: one chunk, or reach 0); y must not
// alias b or dinv
SPMX_API int spmx_trisweep(const SpmxTrisweepPlan* plan, const float* b, const float* dinv,
                           int sweeps, float* y, void* stream);

// the most colours a SymGS plan may have
#define SPMX_SYMGS_MAX_COLORS 64

// A multicolour SymGS plan over a square DIA operator (symgs_dia.cu), packed
// once by the wrapper: `data` (nb, n) band planes re-laid by colour, f64
// (values_f64 = 1) or f32 (0), column k holding the bands of row rows[k];
// `rows` (n,) int32, the rows of colour c at positions [color_start[c],
// color_start[c + 1]), ascending; `offsets` (nb,) int32 band offsets, band
// `diag` the main diagonal (offset 0, nonzero on every row); no two rows
// of one colour coupled by a nonzero slot. `state` (2 + 2 * colors,)
// uint32, zeros before the first step: the step's ticket, its epoch and
// each pass's done count, which the kernel keeps for the next launch;
// `chunk_rows` the rows of a work item and the threads of a block, and
// `grid` the blocks of a launch, both set by spmx_symgs_prepare. A step in
// flight on one plan is one caller's: its state, like x, is updated in
// place.
typedef struct {
  const void* data;
  const int32_t* rows;
  const int32_t* offsets;
  uint32_t* state;
  int64_t color_start[SPMX_SYMGS_MAX_COLORS + 1];
  int64_t n;
  int32_t nb;
  int32_t diag;
  int32_t colors;
  int32_t values_f64;
  int32_t chunk_rows;
  int32_t grid;
  int32_t device;
} SpmxSymgsPlan;

SPMX_API int spmx_symgs_max_colors(void);

// sets the plan's chunk_rows and grid from its colours and the card, once
// a plan: chunk_rows T = 64 where the largest colour has at most 8,192 rows
// (a pass of a coarse level is one memory latency: many small blocks), else
// 128 (bandwidth: fewer rows a block, more blocks in flight); device ms of
// one f64 step on an H100 at T = 64 / 128: 13^3 0.0312 / 0.0318, 104^3
// 0.2598 / 0.2466 (the other levels in symgs_dia.cu); grid = the blocks of
// the step that the card holds at once (its occupancy at T threads times
// the SMs), at most the work items of the widest pass
SPMX_API int spmx_symgs_prepare(SpmxSymgsPlan* plan);

// one symmetric Gauss-Seidel step toward A x = r, x updated in place: the
// colours 0 .. colors-1, then colors-1 .. 0 (empty colours skipped), all in
// one launch of `grid` blocks of chunk_rows threads: work items of
// chunk_rows rows taken in pass order from a self-resetting ticket, each
// pass begun after the previous pass's done count in `state` shows all its
// items of this launch (a count per launch epoch, so no memset between
// launches), x read with ordinary loads after that acquire, never through
// the read-only path; a colour's pass sets, for each of its rows i, x[i] =
// (r[i] - sum over bands b != diag, in band order, of data[b, k] * x[i +
// offsets[b]]) / data[diag, k] (x outside [0, n) reads 0); r and x (n,) in
// the plan's type, x not aliasing r
SPMX_API int spmx_symgs(const SpmxSymgsPlan* plan, const void* r, void* x, void* stream);

// the same step as one launch a colour pass, 256 threads a block (`state`,
// `chunk_rows` and `grid` not read): the yardstick of the one-launch step,
// whose bits it gives
SPMX_API int spmx_symgs_by_pass(const SpmxSymgsPlan* plan, const void* r, void* x,
                                void* stream);

// The scratch of the fused Krylov kernels (krylov_update.cu) for n-vectors
// of one type, packed once a solve by the wrapper: `partials` (blocks,) of
// the vectors' type (f64 with values_f64 = 1, else f32), `ticket` one int32,
// 0 between launches; `blocks` from spmx_krylov_blocks for this n
typedef struct {
  void* partials;
  int32_t* ticket;
  int64_t n;
  int32_t blocks;
  int32_t values_f64;
  int32_t device;
} SpmxKrylovPlan;

// *blocks = the grid of the Krylov kernels for n-vectors on `device`: the
// blocks the card holds at once, or fewer where n gives each thread less
// than one 16-byte piece (at least 1)
SPMX_API int spmx_krylov_blocks(int device, int values_f64, int64_t n, int32_t* blocks);

// *out = sum_i u[i] v[i] (out a 0-d scalar of the plan's type, not in u or
// v). vec = 1: u and v 16-byte aligned, read in 16-byte pieces
SPMX_API int spmx_krylov_dot(const SpmxKrylovPlan* plan, const void* u, const void* v, int vec,
                             void* out, void* stream);

// alpha = *num / *den; x += alpha p; r -= alpha ap (in place, each a fused
// multiply-add); *rr = sum_i r[i]^2 of the new r. x, r, p, ap distinct;
// rr distinct from num and den. vec = 1: x, r, p, ap 16-byte aligned
SPMX_API int spmx_cg_update(const SpmxKrylovPlan* plan, void* x, void* r, const void* p,
                            const void* ap, int vec, const void* num, const void* den, void* rr,
                            void* stream);

// beta = *num / *den; p = z + beta p (in place, a fused multiply-add); z
// distinct from p. vec = 1: p and z 16-byte aligned
SPMX_API int spmx_p_update(const SpmxKrylovPlan* plan, void* p, const void* z, int vec,
                           const void* num, const void* den, void* stream);

// One column stripe of a CSR-row plan (spmv_csr.cu), packed once by the
// wrapper: the CSR of its `rows` rows, `offsets` (rows + 1) int64, `cols`
// (nnz) uint32 and `vals` (nnz) f32; `coords` (tiles + 1, 2) int64, the
// merge path's (rows, entries) point at item tile * spmx_csr_threads() *
// spmx_csr_items() (the last at rows + nnz); `splits` (num_splits, 3)
// int64 rows (row, first tile, ending tile) of the rows that a tile ends
// and earlier tiles began; `row_ids` (rows) int32, y's row of each of its
// rows, or NULL where its rows are y's; `carry` (tiles) f32 scratch
typedef struct {
  const int64_t* offsets;
  const uint32_t* cols;
  const float* vals;
  const int64_t* coords;
  const int64_t* splits;
  const int32_t* row_ids;
  float* carry;
  int64_t rows;
  int64_t tiles;
  int64_t num_splits;
} SpmxCsrStripe;

// A CSR-row plan: `stripes`, a host array of its num_stripes column
// stripes in the order they run; stripe 0 holds every row of y (row_ids
// NULL), each later stripe the rows with entries in it
typedef struct {
  const SpmxCsrStripe* stripes;
  int64_t num_stripes;
  int64_t rows;
  int64_t ncols;
  int32_t device;
} SpmxCsrPlan;

// the threads of one tile of spmx_csr (256) and the merge items each walks
// (8)
SPMX_API int spmx_csr_threads(void);
SPMX_API int spmx_csr_items(void);

// y[i] = sum over row i's entries of vals * x[cols] for every row < rows:
// stripe by stripe, stripe 0 storing y and each later stripe adding its
// part to its rows; within a stripe in the order of the merge path: each
// thread's items in order, a segmented scan over a tile's threads, then the
// carries of earlier tiles for the split rows (a second launch where the
// stripe has any)
SPMX_API int spmx_csr(const SpmxCsrPlan* plan, const float* x, float* y, void* stream);

// A BFS plan (bfs.cu, graph/bfs.py), packed once by the wrapper: the
// graph's `offsets` (n + 1) int64 and `cols` (nnz) uint32, sorted within
// each row; `has_edges` (words) the bitmap of the vertices of degree > 0;
// the search's state: `unvisited` (words), two frontier bitmaps `bits0`,
// `bits1` (words), two queues `queue0`, `queue1` (n) int32, `prefix` (n)
// int64 and `counts` (2) int64; words = ceil(n / 32); `grid`, the blocks
// of each launch, set by spmx_bfs_prepare
typedef struct {
  const int64_t* offsets;
  const uint32_t* cols;
  const uint32_t* has_edges;
  uint32_t* unvisited;
  uint32_t* bits0;
  uint32_t* bits1;
  int32_t* queue0;
  int32_t* queue1;
  int64_t* prefix;
  int64_t* counts;
  int64_t n;
  int64_t words;
  int32_t grid;
  int32_t device;
} SpmxBfsPlan;

// sets plan->grid: the blocks the card holds at once of the step kernels
SPMX_API int spmx_bfs_prepare(SpmxBfsPlan* plan);

// a search from `source`: parents (n) = source at the source, 0x7fffffff
// at the other vertices with an edge, -1 at the rest; unvisited =
// has_edges less the source; queue0 = [source], prefix[0] its degree (one
// launch)
SPMX_API int spmx_bfs_start(const SpmxBfsPlan* plan, int32_t* parents, int64_t source,
                            void* stream);

// a top-down step from the q vertices of queue `cur` (prefix[0 .. q): the
// inclusive sums of their degrees) into queue cur ^ 1: counts[0] the vertices found,
// counts[1] the sum of their degrees, prefix their degrees, each found
// vertex's parent its smallest frontier neighbour, claimed on parents by
// atomicMin (two launches)
SPMX_API int spmx_bfs_top_down(const SpmxBfsPlan* plan, int32_t* parents, int cur, int64_t q,
                               void* stream);

// frontier bitmap `flip` = the q vertices of queue `cur` (a memset, one
// launch)
SPMX_API int spmx_bfs_enter_bitmap(const SpmxBfsPlan* plan, int cur, int64_t q, int flip,
                                   void* stream);

// a bottom-up step from frontier bitmap `flip` into bitmap flip ^ 1:
// counts[0] the vertices found, each found vertex's parent its first
// frontier neighbour in column order (one launch)
SPMX_API int spmx_bfs_bottom_up(const SpmxBfsPlan* plan, int32_t* parents, int flip,
                                void* stream);

// queue `cur` = the vertices of frontier bitmap `flip`, in no fixed order,
// prefix their degrees, counts[0] their count (one launch)
SPMX_API int spmx_bfs_leave_bitmap(const SpmxBfsPlan* plan, int flip, int cur, void* stream);

// the search's end: parents = -1 at the vertices left unvisited (one
// launch)
SPMX_API int spmx_bfs_end(const SpmxBfsPlan* plan, int32_t* parents, void* stream);
