// Batched multi-run pLSA EM accumulators for Hopper (sm_90a).
//
// Replaces the TPU kernel in enstop_tpu/ops/pallas_batch.py:
//   _make_batch_kernel (l.54)  -> the row pass (B) and the word pass (A) below
// which computes, for R runs that share one zero-padded count matrix X (n, m),
// with run r's factors zd[r] = P(z|d) (n, kp), wz[r] = P(w|z) (kp, m) and
// document weights w[r] (n):
//   S_r  = zd[r] . wz[r],  R_r = X / max(S_r, 1e-30)   (no mask: X = 0 gives R = 0)
//   A[r] = (w[r] * zd[r])^T R_r    (kp, m), weighted
//   B[r] = R_r wz[r]^T             (n, kp), never weighted
// The normalisation of the factors happens outside, as it does in JAX.
//
// Route: the TPU kernel keeps each X tile in VMEM while it serves all R runs'
// matmuls. Here each run's arithmetic is that of the single-run kernels -- the
// dense B pass of em_dense.cu and the word pass of em_sparse.cu -- with a loop
// over runs inside the warp, so X (and its word-major nonzeros) is read once
// for a group of runs:
//   * row pass (B): one warp owns a document row, streams it with 16-byte
//     evict-first loads and marks its nonzeros, as em_dense.cu does. For each
//     nonzero it computes S, the ratio and B's update for every run of the
//     group; run r's wz column is the kp contiguous floats wzT[r, j, :] (one
//     coalesced load). The group's zd rows and B accumulators live in
//     registers, and B[r, i, :] is written once.
//   * word pass (A): one warp owns a segment of at most 128 word-major entries
//     of one word (cuda_sparse.Side), as em_sparse.cu's word pass does, and
//     gathers zd[r, d, :] for each run of the group; the weight w[r, d] enters
//     A only. The segments' partials (R, n_seg, kp) are summed per (run, word)
//     in segment order by a second kernel into A^T (R, m, kp).
//   * groups: the runs go G at a time, with G * KT <= 16 (KT topics a lane when
//     kp > 32), so a lane holds at most 16 factor values and 16 accumulators of
//     a group and nothing spills under __launch_bounds__(256). X is streamed,
//     and a segment walked, once per group. G is a power of two that the caller
//     picks (cuda_batch.group_size); the last group's spare slots repeat the
//     last run and write nothing. The G runs of one nonzero are independent
//     chains of loads and shuffle reductions, which the scheduler overlaps.
//   * no atomics: every element of A and B has one owner and one summing order,
//     so repeat launches give the same bits. Each run keeps the single-run
//     kernels' order of operations (fmaf chains and the xor shuffle tree), so
//     run r's A and B equal a single-run em_accumulators_fused of run r.
// Bound: X read once (0.95 GB of bf16 at the 20NG shape, 18,848 x 25,088) and
// each run's zd, wz, w, A and B once: about 1.08 GB for R = 16, kp = 24, 0.32 ms
// at 3.35 TB/s. What keeps it above that: per nonzero and run, a dependent
// load and a 5-step shuffle reduction, serial within a warp and R-fold.
// All arithmetic is fp32 (IEEE division; built without --use_fast_math).
// kp is at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // rows (segments, words) per block, one warp each
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

// A over the word-major segments: each segment's partial A^T row for every run.
template <int KT, int G>
__global__ void __launch_bounds__(kWarps * 32)
batch_words(const int64_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_owner,
            const int32_t* __restrict__ idx, const float* __restrict__ vals,
            const float* __restrict__ zd, const float* __restrict__ wzT,
            const float* __restrict__ w, float* __restrict__ partial, int64_t R, int64_t n,
            int64_t m, int64_t n_seg, int kp) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_seg) return;  // whole warps only: no shuffle is left waiting
  const int64_t begin = seg_ptr[seg], end = seg_ptr[seg + 1];
  const int64_t word = seg_owner[seg];
  for (int64_t r0 = 0; r0 < R; r0 += G) {
    float own_r[G][KT], acc[G][KT];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* wz_w = wzT + (run_of(r0, g, R) * m + word) * kp;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int z = lane + 32 * t;
        own_r[g][t] = z < kp ? wz_w[z] : 0.f;
        acc[g][t] = 0.f;
      }
    }
    for (int64_t base = begin; base < end; base += 32) {
      const int cnt = end - base < 32 ? (int)(end - base) : 32;
      int my_j = 0;
      float my_x = 0.f, my_w[G];
#pragma unroll
      for (int g = 0; g < G; ++g) my_w[g] = 0.f;
      if (lane < cnt) {
        my_j = idx[base + lane];
        my_x = vals[base + lane];
#pragma unroll
        for (int g = 0; g < G; ++g) my_w[g] = w[run_of(r0, g, R) * n + my_j];
      }
      for (int e = 0; e < cnt; ++e) {
        const int64_t j = __shfl_sync(kFull, my_j, e);
        const float x = __shfl_sync(kFull, my_x, e);
        float g_r[G][KT], s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* row = zd + (run_of(r0, g, R) * n + j) * kp;
          s[g] = 0.f;
#pragma unroll
          for (int t = 0; t < KT; ++t) {
            const int z = lane + 32 * t;
            g_r[g][t] = z < kp ? __ldg(row + z) : 0.f;
            s[g] += __fmul_rn(own_r[g][t], g_r[g][t]);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(kFull, s[g], off);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float wd = __shfl_sync(kFull, my_w[g], e);
          const float r = x / fmaxf(s[g], kTiny);
#pragma unroll
          for (int t = 0; t < KT; ++t) acc[g][t] = fmaf(g_r[g][t] * wd, r, acc[g][t]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (r0 + g >= R) break;
      float* p = partial + ((r0 + g) * n_seg + seg) * kp;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int z = lane + 32 * t;
        if (z < kp) p[z] = acc[g][t];
      }
    }
  }
}

// One warp per (run, word): the sum of the word's segment partials, in segment
// order, into A^T[r, word, :] (a word with no segments gets 0).
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
reduce_segments(const int64_t* __restrict__ owner_seg_ptr, const float* __restrict__ partial,
                float* __restrict__ AT, int64_t R, int64_t m, int64_t n_seg, int kp) {
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= R * m) return;
  const int64_t r = item / m, word = item % m;
  const float* p = partial + r * n_seg * kp;
  float acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0.f;
  for (int64_t s = owner_seg_ptr[word]; s < owner_seg_ptr[word + 1]; ++s) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int z = lane + 32 * t;
      if (z < kp) acc[t] += p[s * kp + z];
    }
  }
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int z = lane + 32 * t;
    if (z < kp) AT[item * kp + z] = acc[t];
  }
}

struct Args {
  int word, x_bf16;
  const void* X;
  const float* zd;
  const float* wzT;
  const float* w;
  float* B;
  const int64_t* seg_ptr;
  const int32_t* seg_owner;
  const int64_t* owner_seg_ptr;
  const int32_t* idx;
  const float* vals;
  float* partial;
  float* AT;
  int64_t R, n, m, n_seg;
  int kp;
};

unsigned blocks_of(int64_t items) {
  const int64_t blocks = (items + kWarps - 1) / kWarps;
  return (unsigned)(blocks < (1 << 30) ? blocks : (1 << 30));
}

template <int KT, int G>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (!a.word) {
    if (a.x_bf16) {
      batch_rows<__nv_bfloat16, KT, G><<<blocks_of(a.n), kWarps * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a.X), a.zd, a.wzT, a.B, a.R, a.n, a.m, a.kp);
    } else {
      batch_rows<float, KT, G><<<blocks_of(a.n), kWarps * 32, 0, s>>>(
          static_cast<const float*>(a.X), a.zd, a.wzT, a.B, a.R, a.n, a.m, a.kp);
    }
    return cudaGetLastError();
  }
  if (a.n_seg > 0) {
    if (a.n_seg > (int64_t)kWarps << 30) return cudaErrorInvalidValue;
    batch_words<KT, G><<<blocks_of(a.n_seg), kWarps * 32, 0, s>>>(
        a.seg_ptr, a.seg_owner, a.idx, a.vals, a.zd, a.wzT, a.w, a.partial, a.R, a.n, a.m,
        a.n_seg, a.kp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.R * a.m > (int64_t)kWarps << 30) return cudaErrorInvalidValue;
  reduce_segments<KT><<<blocks_of(a.R * a.m), kWarps * 32, 0, s>>>(
      a.owner_seg_ptr, a.partial, a.AT, a.R, a.m, a.n_seg, a.kp);
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

// One entry point for both passes, on one stream: with word = 0 the row pass
// writes B (R, n, kp) from X; with word = 1 the word pass writes the segment
// partials (R, n_seg, kp) and the reduction A^T (R, m, kp) from the word-major
// segments (seg_ptr, seg_owner, owner_seg_ptr, idx, vals). group is G, a power
// of two with G * KT <= 16. Returns cudaGetLastError() after the launches (0 on
// success). The caller checks shapes, index ranges, 16-byte alignment of X's
// rows and kp (at most 256).
extern "C" int enstop_em_batch(int word, int x_bf16, int group, const void* X,
                               const void* zd, const void* wzT, const void* w, void* B,
                               const void* seg_ptr, const void* seg_owner,
                               const void* owner_seg_ptr, const void* idx, const void* vals,
                               void* partial, void* AT, long long R, long long n, long long m,
                               long long n_seg, int kp, void* stream) {
  if (R <= 0 || n <= 0 || m <= 0) return (int)cudaSuccess;
  const Args a{word, x_bf16, X, static_cast<const float*>(zd), static_cast<const float*>(wzT),
               static_cast<const float*>(w), static_cast<float*>(B),
               static_cast<const int64_t*>(seg_ptr), static_cast<const int32_t*>(seg_owner),
               static_cast<const int64_t*>(owner_seg_ptr), static_cast<const int32_t*>(idx),
               static_cast<const float*>(vals), static_cast<float*>(partial),
               static_cast<float*>(AT), R, n, m, n_seg, kp};
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
