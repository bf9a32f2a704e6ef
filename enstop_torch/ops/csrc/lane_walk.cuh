// The lane-group walk's shared pieces for Hopper (sm_90a): the walk shapes and
// the 16-byte chunk loads that em_sparse.cu (the segment walk) and
// row_walk.cuh (the dense row walk) both use, the bf16 rounding of
// precision="fast", and the E-step's ratio x / den in its seven modes.
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

// The E-step's ratio modes, numbered in the order of MODES in
// scripts/exp_divide_pipeline.py (the TPU experiment _make_em_call, l.74-140,
// whose tile math, l.33-69, these restate; cuda_em.RATIO_MODES):
//   0 f32div         x / den                       (IEEE div.rn.f32: today's fp32 modes)
//   1 recip_mul      x * (1 / den)                 (1 / den is rcp.rn.f32)
//   2 lax_recip      x * __frcp_rn(den)            (the correctly rounded reciprocal)
//   3 nr1            y = bf16(rcp.approx(bf16(den))), one Newton step y (2 - den y), x * y
//   4 nr2            the same with two Newton steps
//   5 bf16recip_x32  x * bf16(rcp.approx(bf16(den)))
//   6 bf16r          bf16(bf16(x) / bf16(den))     (precision="fast": BF16R)
// Only modes 0 and 6 serve the estimators; 1-5 are built for the experiment's
// step only (em_dense.cu, em_sparse.cu). On Hopper without --use_fast_math
// mode 0 is a MUFU seed, FMA refinement and a range check that may branch to a
// slow path; modes 3-5 are a MUFU seed and 0-2 FMAs.
constexpr int kF32Div = 0;
constexpr int kBf16r = 6;

// 1 / d to about 1 ulp (MUFU.RCP); d >= 1e-30 > FLT_MIN here, so .ftz changes
// no result, and 1 / d <= ~1e30 stays finite
__device__ __forceinline__ float rcp_approx(float d) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));
  return y;
}

// den is already max(s, 1e-30); x = 0 gives 0 in every mode
template <int RATIO>
__device__ __forceinline__ float ratio(float x, float den) {
  static_assert(RATIO >= 0 && RATIO <= 6, "seven ratio modes");
  if constexpr (RATIO == kF32Div) {
    return x / den;
  } else if constexpr (RATIO == 1) {
    return x * (1.0f / den);
  } else if constexpr (RATIO == 2) {
    return x * __frcp_rn(den);
  } else if constexpr (RATIO == kBf16r) {
    return bf16r(bf16r(x) / bf16r(den));
  } else {
    float y = bf16r(rcp_approx(bf16r(den)));  // the bf16 seed
    if constexpr (RATIO == 3 || RATIO == 4) y = y * (2.0f - den * y);
    if constexpr (RATIO == 4) y = y * (2.0f - den * y);
    return x * y;
  }
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
