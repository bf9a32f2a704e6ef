// Sparse O(nnz) pLSA EM passes for Hopper (sm_90a).
//
// Replaces the TPU kernels in enstop_tpu/ops/pallas_sell.py:
//   _make_word_pass_kernel (l.456)  -> WORD = true:  A^T (m, kp) and optional LL
//   _make_doc_pass_kernel  (l.490)  -> WORD = false: B (n, kp) and optional LL
// which compute, per nonzero (d, w, x) of the corpus, with zd = P(z|d) (n, kp),
// wzT = P(w|z)^T (m, kp) and per-document weights w (n):
//   v      = zd[d, :] * wzT[w, :]                 (one fp32 product per topic)
//   s      = sum_z v                              (the LL's normalizer, never masked)
//   v_used = THRESH ? (v > thresh ? v : 0) : v,   s_used = sum_z v_used
//   r      = x / max(s_used, 1e-30)
//   word pass:  A^T[w, :] += (THRESH ? v_used : zd[d, :]) * w[d] * r
//   doc pass:   B[d, :]   += (THRESH ? v_used : wzT[w, :]) * r      (never weighted)
//   LL         += x * log(max(s, 1e-30)) * w[d]
// With THRESH the contribution already holds the owner's factor, so the step
// does not multiply by it again (pallas_sell.py:643-648). BF16R (word pass,
// no THRESH; the A half of the dense EM step at precision="fast") rounds as the
// dense kernel's BF16R mode does: r = bf16(bf16(x) / bf16(max(s, 1e-30))) and
// the operand bf16(zd[d, :] * w[d]), with fp32 products and sums.
//
// Route: the TPU kernels sort the nonzeros into tiles and turn the gathers and
// the scatter into one-hot MXU products, because the TPU has no per-lane gather.
// Hopper gathers, so this kernel walks the nonzeros in their sorted order and
// gathers each entry's factor row directly. The layout (cuda_sparse.py:Side) is
// one sort order of the nonzeros -- word-major for the word pass, doc-major for
// the doc pass -- cut into segments of at most 128 entries, each within one
// owner (the word, resp. the document), an owner's segments consecutive.
//   * One warp per segment, one lane per topic (KT topics a lane when kp > 32).
//     The owner's factor row and the segment's partial sum live in registers.
//     The warp loads 32 entries' (index, count, weight) at a time, one a lane,
//     and takes them one at a time by shuffle: a gather of kp contiguous floats
//     (coalesced), s and s_used by shuffle reductions, then the contribution.
//     Each lane keeps its entry's s and adds that entry's LL term after the 32.
//   * Skew: in a Zipf corpus one word may hold nearly every document (about
//     250,000 entries in a 250,000-document corpus), so no warp walks a whole
//     column: the column is many segments, walked by many warps at once.
//   * The segments' partials go to a (segments, kp) buffer; a second kernel,
//     one warp per owner, sums its segments' rows in index order (an owner with
//     none gets 0). The LL is one partial per segment (a fixed-order warp
//     reduction of the lanes' sums); the caller sums them in order. Nothing is
//     summed with atomics, so A, B and the LL are the same from launch to launch.
//   * v is one rounded fp32 product (__fmul_rn, never contracted into an FMA),
//     so the THRESH mask agrees with the plain version bit for bit.
// Bound: the bytes it must move -- the index and count arrays (8 B a nonzero),
// both factor tables and the weights once, the output once: about 196 MB for the
// word pass at 250,000 x 141,000 with 19 M nonzeros and k = 20, 0.059 ms at
// 3.35 TB/s. The gathered rows (80-96 B) come from tables of 13-24 MB that stay
// in the 50 MB L2. The warp's serial walk of its entries (a dependent gather
// and two shuffle reductions per entry) is what keeps it above that bound.
// All arithmetic is fp32 (IEEE division and logf). kp is at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // segments (resp. owners) per block, one warp each
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// x rounded to bf16 (round to nearest even) and widened back to fp32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// KT topics per lane: lane l holds topics l, l + 32, ..., l + 32 (KT - 1).
template <int KT, bool WORD, bool THRESH, bool COMPUTE_LL, bool BF16R>
__global__ void __launch_bounds__(kWarps * 32)
segment_pass(const int64_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_owner,
             const int32_t* __restrict__ idx, const float* __restrict__ vals,
             const float* __restrict__ zd, const float* __restrict__ wzT,
             const float* __restrict__ w, float thresh, float* __restrict__ partial,
             float* __restrict__ ll_seg, int64_t n_seg, int kp) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_seg) return;  // whole warps only: no shuffle is left waiting
  const int64_t begin = seg_ptr[seg], end = seg_ptr[seg + 1];
  const int64_t owner = seg_owner[seg];
  const float* own_tab = WORD ? wzT : zd;   // the owner's row, kept in registers
  const float* oth_tab = WORD ? zd : wzT;   // the entry's row, gathered
  const float w_own = WORD ? 1.f : w[owner];
  float own_r[KT], acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int z = lane + 32 * t;
    own_r[t] = z < kp ? own_tab[owner * kp + z] : 0.f;
    acc[t] = 0.f;
  }
  float ll_acc = 0.f;
  for (int64_t base = begin; base < end; base += 32) {
    const int cnt = end - base < 32 ? (int)(end - base) : 32;
    int my_j = 0;
    float my_x = 0.f, my_w = w_own, my_s = 0.f;
    if (lane < cnt) {
      my_j = idx[base + lane];
      my_x = vals[base + lane];
      if (WORD) my_w = w[my_j];
    }
    for (int e = 0; e < cnt; ++e) {
      const int64_t j = __shfl_sync(kFull, my_j, e);
      const float x = __shfl_sync(kFull, my_x, e);
      const float wd = WORD ? __shfl_sync(kFull, my_w, e) : 1.f;
      const float* row = oth_tab + j * kp;
      float g_r[KT], v_r[KT];
      float s = 0.f, s_used = 0.f;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int z = lane + 32 * t;
        g_r[t] = z < kp ? __ldg(row + z) : 0.f;
        v_r[t] = __fmul_rn(own_r[t], g_r[t]);
        s += v_r[t];
        if (THRESH) {
          v_r[t] = v_r[t] > thresh ? v_r[t] : 0.f;
          s_used += v_r[t];
        }
      }
      s = warp_sum(s);
      s_used = THRESH ? warp_sum(s_used) : s;
      if (lane == e) my_s = s;
      const float r = BF16R ? bf16r(bf16r(x) / bf16r(fmaxf(s_used, kTiny)))
                            : x / fmaxf(s_used, kTiny);
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        float a = THRESH ? v_r[t] : g_r[t];
        if (WORD) a = a * wd;
        if (BF16R) a = bf16r(a);
        acc[t] = fmaf(a, r, acc[t]);
      }
    }
    if (COMPUTE_LL && lane < cnt) ll_acc += my_x * logf(fmaxf(my_s, kTiny)) * my_w;
  }
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int z = lane + 32 * t;
    if (z < kp) partial[seg * kp + z] = acc[t];
  }
  if (COMPUTE_LL) {
    ll_acc = warp_sum(ll_acc);
    if (lane == 0) ll_seg[seg] = ll_acc;
  }
}

// One warp per owner: the sum of its segments' partial rows, in index order.
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
reduce_segments(const int64_t* __restrict__ owner_seg_ptr, const float* __restrict__ partial,
                float* __restrict__ out, int64_t n_owner, int kp) {
  const int lane = threadIdx.x & 31;
  const int64_t owner = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (owner >= n_owner) return;
  float acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0.f;
  for (int64_t s = owner_seg_ptr[owner]; s < owner_seg_ptr[owner + 1]; ++s) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int z = lane + 32 * t;
      if (z < kp) acc[t] += partial[s * kp + z];
    }
  }
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int z = lane + 32 * t;
    if (z < kp) out[owner * kp + z] = acc[t];
  }
}

struct Args {
  const int64_t* seg_ptr;
  const int32_t* seg_owner;
  const int64_t* owner_seg_ptr;
  const int32_t* idx;
  const float* vals;
  const float* zd;
  const float* wzT;
  const float* w;
  float thresh;
  float* partial;
  float* ll_seg;
  float* out;
  int64_t n_seg, n_owner;
  int kp;
};

unsigned blocks_of(int64_t items) { return (unsigned)((items + kWarps - 1) / kWarps); }

template <int KT, bool WORD, bool THRESH, bool COMPUTE_LL, bool BF16R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_seg > 0) {
    segment_pass<KT, WORD, THRESH, COMPUTE_LL, BF16R><<<blocks_of(a.n_seg), kWarps * 32, 0, stream>>>(
        a.seg_ptr, a.seg_owner, a.idx, a.vals, a.zd, a.wzT, a.w, a.thresh, a.partial,
        a.ll_seg, a.n_seg, a.kp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n_owner > 0) {
    reduce_segments<KT><<<blocks_of(a.n_owner), kWarps * 32, 0, stream>>>(
        a.owner_seg_ptr, a.partial, a.out, a.n_owner, a.kp);
  }
  return cudaGetLastError();
}

template <int KT, bool WORD, bool THRESH, bool BF16R>
cudaError_t by_ll(int compute_ll, const Args& a, cudaStream_t s) {
  return compute_ll ? launch<KT, WORD, THRESH, true, BF16R>(a, s)
                    : launch<KT, WORD, THRESH, false, BF16R>(a, s);
}

// the modes: word pass plain, thresholded or bf16r; doc pass plain or thresholded
template <int KT>
cudaError_t by_mode(int word, int thresholded, int compute_ll, int bf16_r, const Args& a,
                    cudaStream_t s) {
  if (word) {
    if (bf16_r) {
      return thresholded ? cudaErrorInvalidValue : by_ll<KT, true, false, true>(compute_ll, a, s);
    }
    return thresholded ? by_ll<KT, true, true, false>(compute_ll, a, s)
                       : by_ll<KT, true, false, false>(compute_ll, a, s);
  }
  if (bf16_r) return cudaErrorInvalidValue;
  return thresholded ? by_ll<KT, false, true, false>(compute_ll, a, s)
                     : by_ll<KT, false, false, false>(compute_ll, a, s);
}

}  // namespace

// One entry point for both passes: the segment pass, then the owner reduction,
// on one stream. Returns cudaGetLastError() after the launches (0 on success).
// partial holds (n_seg, kp) floats, ll_seg n_seg floats (written only with
// compute_ll), out (n_owner, kp) floats; the caller checks shapes, index ranges
// and kp (at most 256).
extern "C" int enstop_em_sparse(int word, int thresholded, int compute_ll, int bf16_r,
                                const void* seg_ptr, const void* seg_owner,
                                const void* owner_seg_ptr, const void* idx, const void* vals,
                                const void* zd, const void* wzT, const void* w, float thresh,
                                void* partial, void* ll_seg, void* out, long long n_seg,
                                long long n_owner, int kp, void* stream) {
  const Args a{static_cast<const int64_t*>(seg_ptr), static_cast<const int32_t*>(seg_owner),
               static_cast<const int64_t*>(owner_seg_ptr), static_cast<const int32_t*>(idx),
               static_cast<const float*>(vals), static_cast<const float*>(zd),
               static_cast<const float*>(wzT), static_cast<const float*>(w), thresh,
               static_cast<float*>(partial), static_cast<float*>(ll_seg),
               static_cast<float*>(out), n_seg, n_owner, kp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kp <= 32) err = by_mode<1>(word, thresholded, compute_ll, bf16_r, a, s);
  else if (kp <= 64) err = by_mode<2>(word, thresholded, compute_ll, bf16_r, a, s);
  else if (kp <= 128) err = by_mode<4>(word, thresholded, compute_ll, bf16_r, a, s);
  else if (kp <= 256) err = by_mode<8>(word, thresholded, compute_ll, bf16_r, a, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
