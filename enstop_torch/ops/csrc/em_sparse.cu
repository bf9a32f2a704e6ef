// Sparse O(nnz) pLSA EM passes for Hopper (sm_90a).
//
// Replaces the TPU kernels in enstop_tpu/ops/pallas_sell.py:
//   _make_word_pass_kernel (l.456)  -> WORD = true:  A^T (m, kp) and optional LL
//   _make_doc_pass_kernel  (l.490)  -> WORD = false: B (n, kp) and optional LL
// and sums A for the dense EM steps (em_dense.cu), in every ratio mode of
// lane_walk.cuh: 0 (fp32), 6 (BF16R, below) and, for the step of the divide
// experiment (scripts/exp_divide_pipeline.py:88), 1-5, built for the word pass
// without THRESH at (L, TPL) = (4, 8) alone, with the fp32 operand of RATIO 0.
// which compute, per nonzero (d, w, x) of the corpus, with zd = P(z|d) (n, kp),
// wzT = P(w|z)^T (m, kp) and per-document weights w (n):
//   v      = zd[d, :] * wzT[w, :]                 (one fp32 product per topic)
//   s      = sum_z v                              (the LL's normalizer, never masked)
//   v_used = THRESH ? (v > thresh ? v : 0) : v,   s_used = sum_z v_used
//   r      = ratio<RATIO>(x, max(s_used, 1e-30))      (x / max(s_used, 1e-30): RATIO 0)
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
// the doc pass -- cut into segments of at most cuda_sparse.SEG_LEN entries
// (512), each within one owner (the word, resp. the document), an owner's
// segments consecutive.
//
// What bounds it: not the bytes. The index and count stream is 8 B a nonzero,
// and the gathered rows (kp floats an entry, about 1.2 GB a pass at 14.8 M
// nonzeros and k = 20) come from tables of 11-20 MB that stay in the 50 MB L2.
// A walk that takes one entry a warp at a time, one lane a topic, issues about
// 40 instructions an entry (three shuffles to broadcast the entry, two shuffle
// reductions, an IEEE division for the whole warp, 64-bit offsets) and leaves
// the lanes past kp idle: it is bound by instruction issue. So this walk:
//   * Takes E = 32 / L entries a warp at once, each held by a group of L lanes.
//     A lane holds TPL topics of the owner's row, of the gathered row and of the
//     segment's accumulator in registers, as C = TPL / V chunks of V topics:
//     chunk c of the lane at place g in its group holds topics (c L + g) V ..
//     (c L + g) V + V - 1. With kp % 4 == 0 and 16-byte aligned tables V = 4
//     (one 16-byte load a chunk), otherwise V = 1. The warp loads 32 entries'
//     index, count and weight at a time, one a lane, in one coalesced load
//     each; a group takes its entry's by shuffle and gathers the row of its
//     next entry one step ahead, so that a gather is in flight while the last
//     is summed. It sums s (and s_used) over its chunks and then over its L
//     lanes by log2(L) xor shuffles, and divides: one division serves E
//     entries. cuda_sparse.walk_shape(kp) picks (L, TPL) among the shapes
//     of lane_walk.cuh, by measurement on the card.
//   * At the segment's end the E groups' accumulators are summed by a fixed xor
//     tree over the entry slots, lowest slot bit first: log2(E) steps of TPL
//     values a segment, not an entry. The steps that would add only slots that
//     took no entry (+0) are skipped, which changes no bit.
//   * Addresses: the row of entry j is one 32 x 32 -> 64-bit multiply-add of j
//     by the row's bytes onto the lane's base; the segment's index and count
//     pointers are hoisted out of the loop, which counts in 32 bits. A table may
//     hold more than 2^31 floats.
//   * Skew: in a Zipf corpus one word may hold nearly every document (about
//     250,000 entries in a 250,000-document corpus), so no warp walks a whole
//     column: the column is many segments, walked by many warps at once. The
//     owner's segments are then summed by one warp, serially: 512 entries a
//     segment keep that chain short (488 rows for that word) and the walks long.
//   * The segments' partials go to a (segments, kp) buffer; a second kernel,
//     one warp per owner, sums its segments' rows in index order (an owner with
//     none gets 0). A launch may hold R runs that share the layout (the word
//     pass of cuda_batch's batched fit): the grid's y is the run, and each run
//     is walked exactly as a run of its own, so its A is a single run's. The LL is one partial per segment (a fixed-order warp
//     reduction of the lanes' sums); the caller sums them in order. Nothing is
//     summed with atomics and every sum has one order, so A, B and the LL are
//     the same from launch to launch.
//   * v is one rounded fp32 product (__fmul_rn, never contracted into an FMA),
//     so the THRESH mask agrees with the plain version bit for bit.
// Bound: the bytes it must move -- the index and count arrays (8 B a nonzero),
// both factor tables and the weights once, the output once: about 162 MB for the
// word pass at 250,000 x 141,000 with 14.8 M nonzeros and k = 20, 0.048 ms at
// 3.35 TB/s.
// All arithmetic is fp32 (IEEE division in RATIO 0 and 6, and logf). kp is at
// most 256.

#include "lane_walk.cuh"

namespace {

constexpr int kWarps = 8;  // segments (resp. owners) per block, one warp each
using namespace lane_walk;

// Built with 16-byte chunks only: the other shapes that the sweep over L times
// at kp = 20, 24 and 104 (cuda_sparse.SWEEP_SHAPES).
constexpr int kSweepShapes[][2] = {{1, 20}, {1, 24}, {2, 12}, {8, 4}, {8, 16}, {32, 4}};

// L lanes an entry, E = 32 / L entries at once, TPL topics a lane in C = TPL / V
// chunks of V; compute_ll is the same for every warp of a launch. blockIdx.y is
// the run: run r reads the tables at r times their strides and writes its own
// partials.
template <int L, int TPL, int V, bool WORD, bool THRESH, int RATIO>
__global__ void __launch_bounds__(kWarps * 32)
segment_pass(const int64_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_owner,
             const int32_t* __restrict__ idx, const float* __restrict__ vals,
             const float* __restrict__ zd, const float* __restrict__ wzT,
             const float* __restrict__ w, float thresh, float* __restrict__ partial,
             float* __restrict__ ll_seg, int64_t n_seg, int kp, int compute_ll,
             int64_t zd_stride, int64_t wzT_stride, int64_t w_stride) {
  constexpr int E = 32 / L;
  constexpr int C = TPL / V;
  constexpr int STRIDE = L * V;  // topics from one chunk of a lane to its next
  constexpr bool BF16R = RATIO == kBf16r;
  static_assert(32 % L == 0 && TPL % V == 0, "L divides the warp, V divides TPL");
  const int lane = threadIdx.x & 31;
  const int slot = lane / L;        // the entry slot of the lane's group
  const int first = lane % L * V;   // the lane's first topic
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_seg) return;  // whole warps only: no shuffle is left waiting
  const int64_t begin = seg_ptr[seg];
  const int cnt = (int)(seg_ptr[seg + 1] - begin);
  const unsigned owner = (unsigned)seg_owner[seg];
  const unsigned ukp = (unsigned)kp;
  const int64_t run = blockIdx.y;
  zd += run * zd_stride;
  wzT += run * wzT_stride;
  w += run * w_stride;
  const float* own_tab = WORD ? wzT : zd;   // the owner's row, kept in registers
  const float* oth_tab = WORD ? zd : wzT;   // the entry's row, gathered
  const float w_own = WORD ? 1.f : __ldg(w + owner);
  bool live[C];
  float own_r[C][V], acc[C][V];
  const float* own_row = own_tab + (size_t)owner * ukp + first;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    live[c] = first + c * STRIDE < kp;
    if (live[c]) {
      Chunk<V>::load(own_row + c * STRIDE, own_r[c]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) own_r[c][v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
  }
  // the gathered row of entry j starts at oth_first + j * 4 kp bytes
  const char* oth_first = reinterpret_cast<const char*>(oth_tab + first);
  const unsigned row_bytes = 4u * ukp;
  const int32_t* seg_idx = idx + begin;
  const float* seg_val = vals + begin;
  float ll_acc = 0.f;
  for (int chunk = 0; chunk < cnt; chunk += 32) {
    // the next 32 entries, one a lane: index, count and (word pass) weight
    const int n_in = cnt - chunk < 32 ? cnt - chunk : 32;
    unsigned my_j = 0;
    float my_x = 0.f, my_w = w_own;
    if (lane < n_in) {
      my_j = (unsigned)__ldg(seg_idx + chunk + lane);
      my_x = __ldg(seg_val + chunk + lane);
      if (WORD) my_w = __ldg(w + my_j);
    }
    // the row of the group's next entry, gathered one step ahead: a slot past
    // the segment's end gathers nothing and holds 0 (it then adds +0 everywhere)
    float next_r[C][V];
    auto gather = [&](int src) {
      const bool on = src < n_in;
      const float* row = reinterpret_cast<const float*>(
          oth_first + (size_t)__shfl_sync(kFull, my_j, src & 31) * row_bytes);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (on && live[c]) {
          Chunk<V>::load(row + c * STRIDE, next_r[c]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) next_r[c][v] = 0.f;
        }
      }
    };
    gather(slot);
    for (int sub = 0; sub < n_in; sub += E) {
      const int src = sub + slot;  // the lane that holds the group's entry
      const bool on = src < n_in;
      const float x = __shfl_sync(kFull, my_x, src);
      const float wd = WORD ? __shfl_sync(kFull, my_w, src) : w_own;
      float g_r[C][V];  // the gathered row, then (THRESH) the kept products
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) g_r[c][v] = next_r[c][v];
      }
      gather(src + E);
      float s = 0.f, s_used = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float p = __fmul_rn(own_r[c][v], g_r[c][v]);
          s += p;
          if (THRESH) {
            g_r[c][v] = p > thresh ? p : 0.f;
            s_used += g_r[c][v];
          }
        }
      }
      // the group's sums; with THRESH, s serves the LL only
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        if (!THRESH || compute_ll) s += __shfl_xor_sync(kFull, s, off);
        if (THRESH) s_used += __shfl_xor_sync(kFull, s_used, off);
      }
      const float den = fmaxf(THRESH ? s_used : s, kTiny);
      const float r = ratio<RATIO>(x, den);
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float a = g_r[c][v];
          if (WORD) a = a * wd;
          if (BF16R) a = bf16r(a);
          acc[c][v] = fmaf(a, r, acc[c][v]);
        }
      }
      if (compute_ll && on && first == 0) ll_acc += x * logf(fmaxf(s, kTiny)) * wd;
    }
  }
  // The slots' accumulators, summed over the slot bits lowest first: after the
  // step at offset L 2^i, slot 0 holds slots 0 .. 2^(i+1) - 1. Slots that took
  // no entry hold +0, so the steps past the used ones are skipped.
  const int used = cnt < E ? cnt : E;
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
    if (off >= used * L) break;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] += __shfl_xor_sync(kFull, acc[c][v], off);
    }
  }
  if (slot == 0) {
    float* out = partial + (size_t)(run * n_seg + seg) * ukp + first;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (live[c]) Chunk<V>::store(out + c * STRIDE, acc[c]);
    }
  }
  if (compute_ll) {
    ll_acc = warp_sum(ll_acc);
    if (lane == 0) ll_seg[run * n_seg + seg] = ll_acc;
  }
}

// One warp per (owner, run): the sum of its segments' partial rows, in index order.
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
reduce_segments(const int64_t* __restrict__ owner_seg_ptr, const float* __restrict__ partial,
                float* __restrict__ out, int64_t n_owner, int64_t n_seg, int kp) {
  const int lane = threadIdx.x & 31;
  const int64_t owner = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (owner >= n_owner) return;
  partial += blockIdx.y * n_seg * kp;
  out += blockIdx.y * n_owner * kp;
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
  int64_t n_seg, n_owner, runs, zd_stride, wzT_stride, w_stride;
  int kp, compute_ll;
};

unsigned blocks_of(int64_t items) { return (unsigned)((items + kWarps - 1) / kWarps); }

template <int KT>
cudaError_t reduce(const Args& a, cudaStream_t stream) {
  reduce_segments<KT><<<dim3(blocks_of(a.n_owner), (unsigned)a.runs), kWarps * 32, 0, stream>>>(
      a.owner_seg_ptr, a.partial, a.out, a.n_owner, a.n_seg, a.kp);
  return cudaGetLastError();
}

template <int L, int TPL, int V, bool WORD, bool THRESH, int RATIO>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_seg > 0) {
    segment_pass<L, TPL, V, WORD, THRESH, RATIO>
        <<<dim3(blocks_of(a.n_seg), (unsigned)a.runs), kWarps * 32, 0, stream>>>(
            a.seg_ptr, a.seg_owner, a.idx, a.vals, a.zd, a.wzT, a.w, a.thresh, a.partial,
            a.ll_seg, a.n_seg, a.kp, a.compute_ll, a.zd_stride, a.wzT_stride, a.w_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n_owner <= 0) return cudaSuccess;
  if (a.kp <= 32) return reduce<1>(a, stream);
  if (a.kp <= 64) return reduce<2>(a, stream);
  if (a.kp <= 128) return reduce<4>(a, stream);
  return reduce<8>(a, stream);
}

// the modes: word pass plain, thresholded or bf16r; doc pass plain or
// thresholded; ratio modes 1-5 for the plain word pass at (L, TPL) = (4, 8)
template <int L, int TPL, int V>
cudaError_t by_mode(int word, int thresholded, int ratio, const Args& a, cudaStream_t s) {
  if (ratio != kF32Div && (!word || thresholded)) return cudaErrorInvalidValue;
  if (!word) {
    return thresholded ? launch<L, TPL, V, false, true, kF32Div>(a, s)
                       : launch<L, TPL, V, false, false, kF32Div>(a, s);
  }
  if (thresholded) return launch<L, TPL, V, true, true, kF32Div>(a, s);
  switch (ratio) {
    case kF32Div: return launch<L, TPL, V, true, false, kF32Div>(a, s);
    case kBf16r: return launch<L, TPL, V, true, false, kBf16r>(a, s);
    default: break;
  }
  if constexpr (L == 4 && TPL == 8) {
    switch (ratio) {
      case 1: return launch<L, TPL, V, true, false, 1>(a, s);
      case 2: return launch<L, TPL, V, true, false, 2>(a, s);
      case 3: return launch<L, TPL, V, true, false, 3>(a, s);
      case 4: return launch<L, TPL, V, true, false, 4>(a, s);
      case 5: return launch<L, TPL, V, true, false, 5>(a, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// the instance of shape I of kShapes (lane_walk.cuh; then, with V = 4, of
// kSweepShapes) that is (l, tpl)
template <int V, int I>
cudaError_t by_shape(int l, int tpl, int word, int thresholded, int ratio, const Args& a,
                     cudaStream_t s) {
  constexpr int kN = kNumShapes;
  constexpr int kSweep = V == 4 ? sizeof(kSweepShapes) / sizeof(kSweepShapes[0]) : 0;
  if constexpr (I < kN + kSweep) {
    constexpr int L = I < kN ? kShapes[I][0] : kSweepShapes[I - kN][0];
    constexpr int TPL = I < kN ? kShapes[I][1] : kSweepShapes[I - kN][1];
    if (l == L && tpl == TPL) return by_mode<L, TPL, V>(word, thresholded, ratio, a, s);
    return by_shape<V, I + 1>(l, tpl, word, thresholded, ratio, a, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry point for both passes: the segment pass, then the owner reduction,
// in ratio mode `ratio` (lane_walk.cuh; 0 fp32, 6 bf16r, 1-5 as by_mode builds them),
// on one stream, for `runs` runs that share the layout (1 <= runs <= 65535).
// Returns cudaGetLastError() after the launches (0 on success). lanes and tpl
// are the walk's shape (L, TPL), one of kShapes (or, with kp % 4 == 0,
// kSweepShapes) with L * TPL >= kp. Per run: zd holds (n, kp) floats, wzT
// (m, kp), w n, partial (n_seg, kp), ll_seg n_seg (written only with
// compute_ll), out (n_owner, kp); the runs' blocks follow each other. n is
// n_index for the word pass and n_owner for the doc pass, m the other. The
// caller checks shapes, index ranges and kp (at most 256).
extern "C" int enstop_em_sparse(int word, int thresholded, int compute_ll, int ratio,
                                int lanes, int tpl, long long runs, const void* seg_ptr,
                                const void* seg_owner, const void* owner_seg_ptr,
                                const void* idx, const void* vals, const void* zd,
                                const void* wzT, const void* w, float thresh, void* partial,
                                void* ll_seg, void* out, long long n_seg, long long n_owner,
                                long long n_index, int kp, void* stream) {
  if (kp <= 0 || kp > 256 || (long long)lanes * tpl < kp || runs < 1 || runs > 65535 ||
      ratio < 0 || ratio > lane_walk::kBf16r) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = word ? n_index : n_owner, m = word ? n_owner : n_index;
  const Args a{static_cast<const int64_t*>(seg_ptr), static_cast<const int32_t*>(seg_owner),
               static_cast<const int64_t*>(owner_seg_ptr), static_cast<const int32_t*>(idx),
               static_cast<const float*>(vals), static_cast<const float*>(zd),
               static_cast<const float*>(wzT), static_cast<const float*>(w), thresh,
               static_cast<float*>(partial), static_cast<float*>(ll_seg),
               static_cast<float*>(out), n_seg, n_owner, runs, n * kp, m * kp, n, kp,
               compute_ll};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = kp % 4 == 0 && tpl % 4 == 0 &&
                   ((uintptr_t)zd | (uintptr_t)wzT | (uintptr_t)partial) % 16 == 0;
  const cudaError_t err = vec ? by_shape<4, 0>(lanes, tpl, word, thresholded, ratio, a, s)
                              : by_shape<1, 0>(lanes, tpl, word, thresholded, ratio, a, s);
  return (int)err;
}
