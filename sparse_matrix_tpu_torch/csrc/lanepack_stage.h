// One LanePack chunk in shared memory, and the cp.async copies that fill
// it: shared by the LanePack SpMV (spmv_lanepack.cu) and SpMM
// (spmm_lanepack.cu) kernels, whose warps stream a segment's chunks
// through a ring of these stages.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_tile.h"
#include "spmx_cuda.h"

namespace spmx {

// 1024 bytes: thread t's slots 4t .. 4t+3 at [t] of each array
struct LanePackStage {
  float4 vals[32];
  int2 lane[32];  // int16 lanes, low half first
  char4 ends[32];  // run ends of lanes 4t .. 4t+3
  char4 starts[32];
};

// Lane t of a warp copies two 16-byte pieces of chunk c: its four values,
// and a piece of the lanes (t < 16), the ends (t < 24) or the starts. One
// commit group a stage is the caller's.
struct LanePackCopier {
  const float4* vals;
  const char* src2;
  int64_t stride2;  // bytes a chunk in the array of the second piece
  int off2;         // that piece's offset from LanePackStage::lane
  int t;

  __device__ __forceinline__ LanePackCopier(const SpmxSegPlan& p, int lane_id)
      : vals(reinterpret_cast<const float4*>(p.vals)),
        src2(lane_id < 16   ? static_cast<const char*>(p.lane) + 16 * lane_id
             : lane_id < 24 ? reinterpret_cast<const char*>(p.ends) + 16 * (lane_id - 16)
                            : reinterpret_cast<const char*>(p.starts) + 16 * (lane_id - 24)),
        stride2(lane_id < 16 ? 256 : 128),
        off2(lane_id < 16   ? 16 * lane_id
             : lane_id < 24 ? 256 + 16 * (lane_id - 16)
                            : 384 + 16 * (lane_id - 24)),
        t(lane_id) {}

  __device__ __forceinline__ void operator()(LanePackStage& d, int64_t c) const {
    spmx_tile::copy16(&d.vals[t], vals + c * 32 + t, true);
    spmx_tile::copy16(reinterpret_cast<char*>(&d.lane[0]) + off2, src2 + c * stride2, true);
  }
};

// the four int16 lanes of thread t's slots
__device__ __forceinline__ void stage_lanes(const LanePackStage& st, int t, int (&ln)[4]) {
  const int2 l = st.lane[t];
  ln[0] = l.x & 0xffff;
  ln[1] = (int)((unsigned)l.x >> 16);
  ln[2] = l.y & 0xffff;
  ln[3] = (int)((unsigned)l.y >> 16);
}

}  // namespace spmx
