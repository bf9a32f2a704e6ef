// Dense-tile pLSA EM kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels in enstop_tpu/ops/pallas_em.py:
//   _make_em_kernel     (fused E+M step: A, B and optional LL)     -> WITH_B (+ the word pass)
//   _make_refit_kernel  (frozen-topics step: B and optional LL)    -> WITH_B
//   _make_ll_kernel     (log-likelihood sweep only)                -> COMPUTE_LL only
// (and the grid-order variants _make_em_kernel_jo / _make_em_kernel_jo_resident /
// _make_refit_kernel_jo_resident(bf16_r=False) of pallas_em_variants.py, which
// compute the same functions), and, with the BF16R flag, the bf16-responsibilities
// kernels of precision="fast" in enstop_tpu/ops/pallas_em_variants.py:
//   _make_em_kernel_jo_resident(bf16_r=True)     -> WITH_B, BF16R (+ the word pass)
//   _make_refit_kernel_jo_resident(bf16_r=True)  -> WITH_B, BF16R
//
// What is computed, for a zero-padded dense count matrix X (n, m) and factors
// zd = P(z|d) (n, kp), wz = P(w|z) (kp, m), per-document weights w (n):
//   S  = zd . wz,  S_safe = max(S, 1e-30),  R = X / S_safe   (no mask: X = 0 gives R = 0)
//   B  = R wz^T                (n, kp)  -- never weighted (the refit's B neither)
//   ll = sum w * X * log S_safe          -- LL of the INPUT factors
// The EM step's A = (w * zd)^T R (kp, m) is not summed here: each word's A is
// summed by the word pass of em_sparse.cu over the word-major nonzeros of X,
// one owner per word, so every element of A is summed in one fixed order.
// BF16R (the TPU's _tile_math(bf16_r=True)): S stays fp32, then
//   R  = bf16(bf16(X) / bf16(S_safe))  (the fp32 quotient rounded to bf16)
//   B  = R bf16(wz)^T
// with every bf16 operand widened to fp32, so each product is exact and the sums
// stay fp32; the LL is unchanged. A float32 X is rounded to bf16 as well, as the
// TPU kernel does. The rounding adds a few instructions per nonzero and removes
// no bytes from the X stream that bounds the kernel.
//
// Route: the TPU kernel multiplies whole (Bd, Bw) tiles on the MXU. On Hopper
// the dense products cost 3 * 2 * n * m * kp FLOP per step (68 GFLOP at the
// 20-Newsgroups shape, 18,848 x 25,088 padded, kp = 24: about 1 ms on the fp32
// CUDA cores at the data sheet's 67 TFLOP/s), while 0.57% of the padded X
// is nonzero. This kernel therefore streams the dense tile and does the S / R /
// B / ll work only for the nonzero entries. That is exactly the TPU kernel's
// function: an entry with X = 0 contributes R = 0 to B and 0 to ll
// (log S_safe is finite). What bounds it is the X stream: 18,848 x 25,088
// x 2 B = 0.95 GB of bf16 per step, 0.28 ms at 3.35 TB/s. The design keeps
// everything else off that stream:
//   * one warp owns one document row. Lanes read X with 16-byte streaming loads
//     (__ldcs, evict-first, so the factors stay in L2), kUnroll loads in flight
//     per lane, and mark the nonzeros they find in a bit mask;
//   * the warp then works through the row's nonzeros together, one lane per
//     topic (KT topics per lane when kp > 32). The row's zd and its B
//     accumulator live in registers. The wz column of a nonzero is read from
//     the transposed copy wzT (m, kp): kp contiguous floats, one coalesced load;
//     S is a warp shuffle reduction;
//   * B[i, :] is written once per row: no cross-block reduction, no atomics.
//     (Accumulating B in shared memory with fp32 atomics instead measured
//     1.41 ms per refit step on the H100 at the 20NG shape, against 0.40 ms
//     for the LL-only pass.)
//   * ll is accumulated by lane 0, summed per block over its warps in order, and
//     written as one partial per block; the caller sums the partials in order.
// Nothing is summed with atomics and each block's rows are fixed by the grid,
// so B and ll are the same from launch to launch. All arithmetic is fp32
// (IEEE division and logf; built without --use_fast_math). kp is at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // document rows per block, one warp each
constexpr int kUnroll = 4;   // 16-byte X loads in flight per lane (VEC * kUnroll <= 32)
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// Elements of X in one 16-byte load, and element e of it as fp32.
template <typename XT>
struct XVec;

template <>
struct XVec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    const uint32_t word = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
    return __uint_as_float(word);
  }
};

template <>
struct XVec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    const int q = e >> 1;
    const uint32_t word = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
    // little-endian: the even element is the low half; bf16 is the top half of fp32
    return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};

// x rounded to bf16 (round to nearest even) and widened back to fp32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// KT topics per lane: lane l holds topics l, l + 32, ..., l + 32 (KT - 1).
template <typename XT, int KT, bool WITH_B, bool COMPUTE_LL, bool BF16R>
__global__ void __launch_bounds__(kWarps * 32)
em_accumulate(const XT* __restrict__ X, const float* __restrict__ zd,
              const float* __restrict__ wzT, const float* __restrict__ w,
              float* __restrict__ B, float* __restrict__ ll_part, int64_t n, int64_t m,
              int kp) {
  __shared__ float ll_warp[kWarps];
  constexpr int VEC = XVec<XT>::kN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_chunks = m / VEC;
  float ll_acc = 0.f;

  for (int64_t i = (int64_t)blockIdx.x * kWarps + warp; i < n;
       i += (int64_t)gridDim.x * kWarps) {
    const float wi = w[i];
    float zd_r[KT], b_r[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int z = lane + 32 * t;
      zd_r[t] = z < kp ? zd[i * kp + z] : 0.f;
      b_r[t] = 0.f;
    }
    const uint4* xrow = reinterpret_cast<const uint4*>(X + i * m);
    for (int64_t base = 0; base < n_chunks; base += 32 * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = base + lane + u * 32;
        v[u] = c < n_chunks ? __ldcs(xrow + c) : make_uint4(0u, 0u, 0u, 0u);
      }
      // bit u * VEC + e: element e of this lane's load u is nonzero
      uint32_t mask = 0u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0u) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (XVec<XT>::get(v[u], e) != 0.f) mask |= 1u << (u * VEC + e);
      }
      // the warp takes the nonzeros one at a time, lowest lane first
      for (uint32_t busy = __ballot_sync(kFull, mask != 0u); busy;
           busy = __ballot_sync(kFull, mask != 0u)) {
        const int src = __ffs(busy) - 1;
        const int bit = __shfl_sync(kFull, __ffs(mask) - 1, src);
        const int u = bit / VEC;
        const int e = bit % VEC;
        float x_src = 0.f;
        if (lane == src) {
          mask &= mask - 1u;
          uint4 vu = v[0];
#pragma unroll
          for (int k = 1; k < kUnroll; ++k)
            if (k == u) vu = v[k];
          x_src = XVec<XT>::get(vu, e);
        }
        const float x = __shfl_sync(kFull, x_src, src);
        const int64_t j = (base + src + u * 32) * VEC + e;
        const float* wz_j = wzT + j * kp;
        float wz_r[KT];
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int z = lane + 32 * t;
          wz_r[t] = z < kp ? __ldg(wz_j + z) : 0.f;
          part = fmaf(zd_r[t], wz_r[t], part);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(kFull, part, off);
        const float s_safe = fmaxf(part, kTiny);
        const float r = BF16R ? bf16r(bf16r(x) / bf16r(s_safe)) : x / s_safe;
        if (COMPUTE_LL && lane == 0) ll_acc += x * logf(s_safe) * wi;
        if (WITH_B) {
#pragma unroll
          for (int t = 0; t < KT; ++t) b_r[t] = fmaf(r, BF16R ? bf16r(wz_r[t]) : wz_r[t], b_r[t]);
        }
      }
    }
    if (WITH_B) {
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int z = lane + 32 * t;
        if (z < kp) B[i * kp + z] = b_r[t];
      }
    }
  }

  if (COMPUTE_LL) {
    if (lane == 0) ll_warp[warp] = ll_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int k = 0; k < kWarps; ++k) total += ll_warp[k];
      ll_part[blockIdx.x] = total;
    }
  }
}

// blocks of the grid: one warp per row, capped; the caller sizes the LL
// partials from the same formula (cuda_em.py:_blocks)
int64_t grid_of(int64_t n) {
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  return blocks < (1 << 30) ? blocks : (1 << 30);
}

template <typename XT, int KT, bool WITH_B, bool COMPUTE_LL, bool BF16R>
cudaError_t launch(const void* X, const void* zd, const void* wzT, const void* w,
                   void* B, void* ll_part, int64_t n, int64_t m, int kp,
                   cudaStream_t stream) {
  em_accumulate<XT, KT, WITH_B, COMPUTE_LL, BF16R><<<(unsigned)grid_of(n), kWarps * 32, 0, stream>>>(
      static_cast<const XT*>(X), static_cast<const float*>(zd),
      static_cast<const float*>(wzT), static_cast<const float*>(w),
      static_cast<float*>(B), static_cast<float*>(ll_part), n, m, kp);
  return cudaGetLastError();
}

template <typename XT, int KT>
cudaError_t by_mode(int bf16_r, int with_b, int compute_ll, const void* X, const void* zd,
                    const void* wzT, const void* w, void* B, void* ll_part, int64_t n,
                    int64_t m, int kp, cudaStream_t s) {
  if (with_b) {
    if (bf16_r) {
      return compute_ll
          ? launch<XT, KT, true, true, true>(X, zd, wzT, w, B, ll_part, n, m, kp, s)
          : launch<XT, KT, true, false, true>(X, zd, wzT, w, B, ll_part, n, m, kp, s);
    }
    return compute_ll
        ? launch<XT, KT, true, true, false>(X, zd, wzT, w, B, ll_part, n, m, kp, s)
        : launch<XT, KT, true, false, false>(X, zd, wzT, w, B, ll_part, n, m, kp, s);
  }
  // the LL sweep has no bf16 mode: precision="fast" keeps the fp32 LL
  if (compute_ll && !bf16_r) {
    return launch<XT, KT, false, true, false>(X, zd, wzT, w, B, ll_part, n, m, kp, s);
  }
  return cudaErrorInvalidValue;
}

template <typename XT>
cudaError_t by_kp(int bf16_r, int with_b, int compute_ll, const void* X, const void* zd,
                  const void* wzT, const void* w, void* B, void* ll_part, int64_t n,
                  int64_t m, int kp, cudaStream_t s) {
  if (kp <= 32) return by_mode<XT, 1>(bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part, n, m, kp, s);
  if (kp <= 64) return by_mode<XT, 2>(bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part, n, m, kp, s);
  if (kp <= 128) return by_mode<XT, 4>(bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part, n, m, kp, s);
  if (kp <= 256) return by_mode<XT, 8>(bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part, n, m, kp, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One entry point for all the modes. Returns cudaGetLastError() after the
// launch (0 on success). ll_part holds one float per block of the grid
// (ceil(n / 8), at most 2^30); with COMPUTE_LL off it is not written. The
// caller checks shapes, 16-byte alignment of X's rows and kp (at most 256).
extern "C" int enstop_em_dense(int x_bf16, int bf16_r, int with_b, int compute_ll,
                               const void* X, const void* zd, const void* wzT,
                               const void* w, void* B, void* ll_part,
                               long long n, long long m, int kp, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? by_kp<__nv_bfloat16>(bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part,
                                    n, m, kp, s)
             : by_kp<float>(bf16_r, with_b, compute_ll, X, zd, wzT, w, B, ll_part, n, m,
                            kp, s);
  return (int)err;
}
