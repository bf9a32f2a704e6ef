// The lane-group walk's shared pieces for Hopper (sm_90a): the walk shapes and
// the 16-byte chunk loads that em_sparse.cu (the segment walk) and
// row_walk.cuh (the dense row walk) both use, and the bf16 rounding of
// precision="fast".
//
// A walk takes E = 32 / L entries a warp at once, L lanes an entry, TPL topics
// a lane in chunks of V consecutive topics (V = 4: one 16-byte access, with
// kp % 4 == 0 and 16-byte aligned tables; else V = 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lane_walk {

constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// The walk shapes (L, TPL) built for every topic count and both chunk widths
// (cuda_sparse.WALK_SHAPES; cuda_sparse.walk_shape picks one).
constexpr int kShapes[][2] = {{1, 4}, {1, 8}, {2, 8}, {4, 8}, {8, 8}, {16, 8}, {32, 8}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

// x rounded to bf16 (round to nearest even) and widened back to fp32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// V consecutive floats: one 16-byte access (V = 4) or one float (V = 1).
template <int V>
struct Chunk;

template <>
struct Chunk<1> {
  __device__ __forceinline__ static void load(const float* p, float* out) { out[0] = __ldg(p); }
  __device__ __forceinline__ static void store(float* p, const float* in) { p[0] = in[0]; }
};

template <>
struct Chunk<4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

}  // namespace lane_walk
