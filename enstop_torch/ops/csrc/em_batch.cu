// Batched multi-run pLSA EM accumulators for Hopper (sm_90a).
//
// Replaces the TPU kernel in enstop_tpu/ops/pallas_batch.py:
//   _make_batch_kernel (l.54)  -> the row pass (B) below; A by em_sparse.cu
// which computes, for R runs that share one zero-padded count matrix X (n, m),
// with run r's factors zd[r] = P(z|d) (n, kp), wz[r] = P(w|z) (kp, m) and
// document weights w[r] (n):
//   S_r  = zd[r] . wz[r],  R_r = X / max(S_r, 1e-30)   (no mask: X = 0 gives R = 0)
//   A[r] = (w[r] * zd[r])^T R_r    (kp, m), weighted
//   B[r] = R_r wz[r]^T             (n, kp), never weighted
// The normalisation of the factors happens outside, as it does in JAX.
//
// Route: the TPU kernel keeps each X tile in VMEM while it serves all R runs'
// matmuls. Here B's arithmetic is that of the dense B pass of em_dense.cu with
// a loop over runs inside the warp, so X is read once for a group of runs. A is
// em_sparse.cu's word pass over the word-major nonzeros of X, launched once for
// all R runs (the grid's y is the run; cuda_batch.batch_words), so each run's A
// is a single run's bit for bit.
//   * row pass (B): one warp owns a document row, streams it with 16-byte
//     evict-first loads and marks its nonzeros, as em_dense.cu does. For each
//     nonzero it computes S, the ratio and B's update for every run of the
//     group; run r's wz column is the kp contiguous floats wzT[r, j, :] (one
//     coalesced load). The group's zd rows and B accumulators live in
//     registers, and B[r, i, :] is written once.
//   * groups: the runs go G at a time, with G * KT <= 16 (KT topics a lane when
//     kp > 32), so a lane holds at most 16 factor values and 16 accumulators of
//     a group and nothing spills under __launch_bounds__(256). X is streamed
//     once per group. G is a power of two that the caller picks
//     (cuda_batch.group_size); the last group's spare slots repeat the last run
//     and write nothing. The G runs of one nonzero are independent chains of
//     loads and shuffle reductions, which the scheduler overlaps.
//   * no atomics: every element of B has one owner and one summing order, so
//     repeat launches give the same bits. Each run keeps the dense B pass's
//     order of operations (fmaf chains and the xor shuffle tree), so run r's B
//     equals a single-run em_accumulators_fused of run r bit for bit.
// Bound of the row pass: X read once (0.95 GB of bf16 at the 20NG shape,
// 18,848 x 25,088) and each run's zd, wz and B once: about 1.04 GB for R = 16,
// kp = 24, 0.31 ms at 3.35 TB/s. What keeps it above that: per nonzero and
// run, a dependent load and a 5-step shuffle reduction, serial within a warp
// and R-fold.
// All arithmetic is fp32 (IEEE division; built without --use_fast_math).
// kp is at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // rows per block, one warp each
constexpr int kUnroll = 4;        // 16-byte X loads in flight per lane, as em_dense.cu
constexpr int kGroupFloats = 16;  // G * KT at most
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

// the run in slot g of the group that starts at r0: spare slots repeat the last run
__device__ __forceinline__ int64_t run_of(int64_t r0, int g, int64_t R) {
  return r0 + g < R ? r0 + g : R - 1;
}

// B over rows. KT topics a lane: lane l holds topics l, l + 32, ..., l + 32 (KT - 1).
template <typename XT, int KT, int G>
__global__ void __launch_bounds__(kWarps * 32)
batch_rows(const XT* __restrict__ X, const float* __restrict__ zd,
           const float* __restrict__ wzT, float* __restrict__ B, int64_t R, int64_t n,
           int64_t m, int kp) {
  constexpr int VEC = XVec<XT>::kN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_chunks = m / VEC;

  for (int64_t i = (int64_t)blockIdx.x * kWarps + warp; i < n;
       i += (int64_t)gridDim.x * kWarps) {
    const uint4* xrow = reinterpret_cast<const uint4*>(X + i * m);
    for (int64_t r0 = 0; r0 < R; r0 += G) {
      float zd_r[G][KT], b_r[G][KT];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* zd_i = zd + (run_of(r0, g, R) * n + i) * kp;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int z = lane + 32 * t;
          zd_r[g][t] = z < kp ? zd_i[z] : 0.f;
          b_r[g][t] = 0.f;
        }
      }
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
          float wz_r[G][KT], part[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float* wz_j = wzT + (run_of(r0, g, R) * m + j) * kp;
            part[g] = 0.f;
#pragma unroll
            for (int t = 0; t < KT; ++t) {
              const int z = lane + 32 * t;
              wz_r[g][t] = z < kp ? __ldg(wz_j + z) : 0.f;
              part[g] = fmaf(zd_r[g][t], wz_r[g][t], part[g]);
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int g = 0; g < G; ++g) part[g] += __shfl_xor_sync(kFull, part[g], off);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float r = x / fmaxf(part[g], kTiny);
#pragma unroll
            for (int t = 0; t < KT; ++t) b_r[g][t] = fmaf(r, wz_r[g][t], b_r[g][t]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (r0 + g >= R) break;
        float* b_i = B + ((r0 + g) * n + i) * kp;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int z = lane + 32 * t;
          if (z < kp) b_i[z] = b_r[g][t];
        }
      }
    }
  }
}

struct Args {
  int x_bf16;
  const void* X;
  const float* zd;
  const float* wzT;
  float* B;
  int64_t R, n, m;
  int kp;
};

unsigned blocks_of(int64_t items) {
  const int64_t blocks = (items + kWarps - 1) / kWarps;
  return (unsigned)(blocks < (1 << 30) ? blocks : (1 << 30));
}

template <int KT, int G>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.x_bf16) {
    batch_rows<__nv_bfloat16, KT, G><<<blocks_of(a.n), kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a.X), a.zd, a.wzT, a.B, a.R, a.n, a.m, a.kp);
  } else {
    batch_rows<float, KT, G><<<blocks_of(a.n), kWarps * 32, 0, s>>>(
        static_cast<const float*>(a.X), a.zd, a.wzT, a.B, a.R, a.n, a.m, a.kp);
  }
  return cudaGetLastError();
}

template <int KT, int G>
cudaError_t launch_if_fits(const Args& a, cudaStream_t s) {
  if constexpr (G * KT <= kGroupFloats) {
    return launch<KT, G>(a, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int KT>
cudaError_t by_group(int group, const Args& a, cudaStream_t s) {
  switch (group) {
    case 1: return launch_if_fits<KT, 1>(a, s);
    case 2: return launch_if_fits<KT, 2>(a, s);
    case 4: return launch_if_fits<KT, 4>(a, s);
    case 8: return launch_if_fits<KT, 8>(a, s);
    case 16: return launch_if_fits<KT, 16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The row pass, on one stream: B (R, n, kp) from X. group is G, a power of two
// with G * KT <= 16. Returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, 16-byte alignment of X's rows and kp (at
// most 256).
extern "C" int enstop_em_batch(int x_bf16, int group, const void* X, const void* zd,
                               const void* wzT, void* B, long long R, long long n, long long m,
                               int kp, void* stream) {
  if (R <= 0 || n <= 0 || m <= 0) return (int)cudaSuccess;
  const Args a{x_bf16, X, static_cast<const float*>(zd), static_cast<const float*>(wzT),
               static_cast<float*>(B), R, n, m, kp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kp <= 0) err = cudaErrorInvalidValue;
  else if (kp <= 32) err = by_group<1>(group, a, s);
  else if (kp <= 64) err = by_group<2>(group, a, s);
  else if (kp <= 128) err = by_group<4>(group, a, s);
  else if (kp <= 256) err = by_group<8>(group, a, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
