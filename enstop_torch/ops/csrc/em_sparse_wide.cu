// Sparse O(nnz) pLSA EM passes past 256 topics, for Hopper (sm_90a): the word
// pass (WORD = true, A^T (m, kp)) and the doc pass (WORD = false, B (n, kp)) of
// em_sparse.cu at kp = 257 .. 2048 (cuda_sparse.MAX_KP), with the optional LL.
// They replace the same TPU kernels (enstop_tpu/ops/pallas_sell.py:456
// _make_word_pass_kernel, :490 _make_doc_pass_kernel) and compute the same
// function, stated in em_sparse.cu, in the modes that the sparse fit, the refit
// and the LL test reach: ratio mode 0 (x / den in IEEE fp32), with or without
// THRESH, weighted, for R runs that share the layout. em_sparse.cu keeps every
// topic count up to 256; nothing here changes one of its instances.
//
// Why a walk of its own: em_sparse.cu's lane groups hold TPL <= 8 topics a lane
// of three rows in registers (the owner's row, the gathered row, the segment's
// accumulator) for at most 32 lanes an entry, 256 topics. Past that the rows do
// not fit. So here:
//   * One warp walks a segment, one entry at a time, its 32 lanes over the
//     entry's topics: lane l holds topics (c 32 + l) V .. (c 32 + l) V + V - 1
//     of chunk c, C = TPL / V chunks (V = 4: one 16-byte access, with kp % 4 ==
//     0 and 16-byte aligned tables; else V = 1). TPL = 16, 32 or 64 covers kp up
//     to 512, 1024 or 2048 (kWideShapes, mirrored as cuda_sparse.WIDE_SHAPES).
//   * The owner's row lies in shared memory (32 TPL floats a warp, loaded once a
//     segment, 0 past kp); the gathered row and the accumulator in registers, 2
//     TPL floats a lane.
//   * An entry: its row gathered with all C loads in flight at once, the
//     products and s (and s_used) over the lane's topics, a 5-step xor reduction
//     that leaves every lane the same bits, one division, the accumulation. The
//     warp loads 32 entries' index, count and weight at a time, one a lane, and
//     hands each entry's to every lane by shuffle.
//   * The segments' partials go to a (segments, kp) buffer, and a second kernel,
//     one warp per owner, sums an owner's rows in index order, as em_sparse.cu
//     does: no atomics, every sum in one order, so A, B and the LL are the same
//     from launch to launch.
//   * v is one rounded fp32 product (__fmul_rn, never contracted into an FMA),
//     so the THRESH mask agrees with the plain version bit for bit.
// What bounds it: the gathers. At kp = 1,000 an entry's row is 4 KB: 279 GB a
// pass over UCI NYTimes's 69.7 M nonzeros, from tables (P(z|d) 1.2 GB, P(w|z)^T
// 0.41 GB) that the 50 MB L2 holds a few percent of: 83 ms a pass at 3.35
// TB/s, against 3.1 ms for a pass's fp32 operations. So each row is gathered
// once a pass: a walk that tiled the topic axis would gather it twice, once for
// s and once to accumulate. The arithmetic (about 2 C + 4 TPL instructions a
// lane an entry) stays under the gathers' time.

#include "lane_walk.cuh"

namespace {

constexpr int kWarps = 4;  // segments (resp. owners) per block, one warp each
using namespace lane_walk;

// The shapes (L, TPL) built: one entry a warp at a time, TPL topics a lane
// (cuda_sparse.WIDE_SHAPES; cuda_sparse.walk_shape picks one).
constexpr int kWideShapes[][2] = {{32, 16}, {32, 32}, {32, 64}};

// V consecutive floats of shared memory
template <int V>
__device__ __forceinline__ void smem_load(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
    out[0] = *p;
  }
}

// One warp a segment, the entries one at a time; blockIdx.y is the run: run r
// reads the tables at r times their strides and writes its own partials.
template <int TPL, int V, bool WORD, bool THRESH>
__global__ void __launch_bounds__(kWarps * 32)
wide_walk_segments(const int64_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_owner,
                   const int32_t* __restrict__ idx, const float* __restrict__ vals,
                   const float* __restrict__ zd, const float* __restrict__ wzT,
                   const float* __restrict__ w, float thresh, float* __restrict__ partial,
                   float* __restrict__ ll_seg, int64_t n_seg, int kp, int compute_ll,
                   int64_t zd_stride, int64_t wzT_stride, int64_t w_stride) {
  constexpr int C = TPL / V;
  constexpr int ROW = 32 * TPL;  // the owner's row in shared memory, padded
  static_assert(TPL % V == 0, "V divides TPL");
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  float* own_s = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * ROW;
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_seg) return;  // whole warps only; no block-wide barrier follows
  const int64_t begin = seg_ptr[seg];
  const int cnt = (int)(seg_ptr[seg + 1] - begin);
  const unsigned owner = (unsigned)seg_owner[seg];
  const int64_t run = blockIdx.y;
  zd += run * zd_stride;
  wzT += run * wzT_stride;
  w += run * w_stride;
  const float* own_tab = WORD ? wzT : zd;   // the owner's row, kept in shared memory
  const float* oth_tab = WORD ? zd : wzT;   // the entry's row, gathered
  const float w_own = WORD ? 1.f : __ldg(w + owner);
  const float* own_row = own_tab + (size_t)owner * (unsigned)kp;
  for (int t = lane; t < ROW; t += 32) own_s[t] = t < kp ? __ldg(own_row + t) : 0.f;
  __syncwarp();
  bool live[C];
  float acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    live[c] = (c * 32 + lane) * V < kp;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
  }
  const float* oth_first = oth_tab + lane * V;  // + j kp: the lane's first topic of row j
  const float* own_first = own_s + lane * V;
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
    for (int e = 0; e < n_in; ++e) {
      const unsigned j = __shfl_sync(kFull, my_j, e);
      const float x = __shfl_sync(kFull, my_x, e);
      const float wd = WORD ? __shfl_sync(kFull, my_w, e) : w_own;
      const float* row = oth_first + (size_t)j * (unsigned)kp;
      float g[C][V];  // the gathered row, then (THRESH) the kept products
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (live[c]) {
          Chunk<V>::load(row + c * 32 * V, g[c]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) g[c][v] = 0.f;
        }
      }
      float s = 0.f, s_used = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        float own[V];
        smem_load<V>(own_first + c * 32 * V, own);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float p = __fmul_rn(own[v], g[c][v]);
          s += p;
          if (THRESH) {
            g[c][v] = p > thresh ? p : 0.f;
            s_used += g[c][v];
          }
        }
      }
      // the warp's sums; with THRESH, s serves the LL only
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        if (!THRESH || compute_ll) s += __shfl_xor_sync(kFull, s, off);
        if (THRESH) s_used += __shfl_xor_sync(kFull, s_used, off);
      }
      const float r = ratio<kF32Div>(x, fmaxf(THRESH ? s_used : s, kTiny));
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float a = g[c][v];
          if (WORD) a = a * wd;
          acc[c][v] = fmaf(a, r, acc[c][v]);
        }
      }
      if (compute_ll && lane == 0) ll_acc += x * logf(fmaxf(s, kTiny)) * wd;
    }
  }
  float* out = partial + (size_t)(run * n_seg + seg) * (unsigned)kp + lane * V;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (live[c]) Chunk<V>::store(out + c * 32 * V, acc[c]);
  }
  if (compute_ll && lane == 0) ll_seg[run * n_seg + seg] = ll_acc;
}

// One warp per (owner, run): the sum of its segments' partial rows, in index
// order, the lane's topics as in the segment walk (an owner with none gets 0).
template <int TPL, int V>
__global__ void __launch_bounds__(kWarps * 32)
wide_walk_reduce(const int64_t* __restrict__ owner_seg_ptr, const float* __restrict__ partial,
                 float* __restrict__ out, int64_t n_owner, int64_t n_seg, int kp) {
  constexpr int C = TPL / V;
  const int lane = threadIdx.x & 31;
  const int64_t owner = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (owner >= n_owner) return;
  partial += (int64_t)blockIdx.y * n_seg * kp + lane * V;
  out += ((int64_t)blockIdx.y * n_owner + owner) * kp + lane * V;
  bool live[C];
  float acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    live[c] = (c * 32 + lane) * V < kp;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
  }
  for (int64_t s = owner_seg_ptr[owner]; s < owner_seg_ptr[owner + 1]; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!live[c]) continue;
      float p[V];
      Chunk<V>::load(partial + s * kp + c * 32 * V, p);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] += p[v];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (live[c]) Chunk<V>::store(out + c * 32 * V, acc[c]);
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

template <int TPL, int V, bool WORD, bool THRESH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_seg > 0) {
    const size_t smem = sizeof(float) * kWarps * 32 * TPL;
    wide_walk_segments<TPL, V, WORD, THRESH>
        <<<dim3(blocks_of(a.n_seg), (unsigned)a.runs), kWarps * 32, smem, stream>>>(
            a.seg_ptr, a.seg_owner, a.idx, a.vals, a.zd, a.wzT, a.w, a.thresh, a.partial,
            a.ll_seg, a.n_seg, a.kp, a.compute_ll, a.zd_stride, a.wzT_stride, a.w_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n_owner <= 0) return cudaSuccess;
  wide_walk_reduce<TPL, V><<<dim3(blocks_of(a.n_owner), (unsigned)a.runs), kWarps * 32, 0,
                             stream>>>(a.owner_seg_ptr, a.partial, a.out, a.n_owner, a.n_seg,
                                       a.kp);
  return cudaGetLastError();
}

template <int TPL, int V>
cudaError_t by_mode(int word, int thresholded, const Args& a, cudaStream_t s) {
  if (word) {
    return thresholded ? launch<TPL, V, true, true>(a, s) : launch<TPL, V, true, false>(a, s);
  }
  return thresholded ? launch<TPL, V, false, true>(a, s) : launch<TPL, V, false, false>(a, s);
}

template <int V>
cudaError_t by_shape(int tpl, int word, int thresholded, const Args& a, cudaStream_t s) {
  switch (tpl) {
    case kWideShapes[0][1]: return by_mode<kWideShapes[0][1], V>(word, thresholded, a, s);
    case kWideShapes[1][1]: return by_mode<kWideShapes[1][1], V>(word, thresholded, a, s);
    case kWideShapes[2][1]: return by_mode<kWideShapes[2][1], V>(word, thresholded, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry point for both passes, with em_sparse.cu's arguments: the segment
// walk, then the owner reduction, on one stream, for `runs` runs that share the
// layout (1 <= runs <= 65535). Returns cudaGetLastError() after the launches (0
// on success). ratio must be 0 (fp32), lanes 32 and tpl one of kWideShapes with
// 256 < kp <= 32 tpl. Per run: zd holds (n, kp) floats, wzT (m, kp), w n,
// partial (n_seg, kp), ll_seg n_seg (written only with compute_ll), out
// (n_owner, kp); the runs' blocks follow each other. n is n_index for the word
// pass and n_owner for the doc pass, m the other. The caller checks shapes and
// index ranges.
extern "C" int enstop_em_sparse_wide(int word, int thresholded, int compute_ll, int ratio,
                                     int lanes, int tpl, long long runs, const void* seg_ptr,
                                     const void* seg_owner, const void* owner_seg_ptr,
                                     const void* idx, const void* vals, const void* zd,
                                     const void* wzT, const void* w, float thresh,
                                     void* partial, void* ll_seg, void* out, long long n_seg,
                                     long long n_owner, long long n_index, int kp,
                                     void* stream) {
  if (kp <= 256 || lanes != 32 || (long long)lanes * tpl < kp || runs < 1 || runs > 65535 ||
      ratio != lane_walk::kF32Div) {
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
  const bool vec = kp % 4 == 0 &&
                   ((uintptr_t)zd | (uintptr_t)wzT | (uintptr_t)partial | (uintptr_t)out) % 16 == 0;
  const cudaError_t err = vec ? by_shape<4>(tpl, word, thresholded, a, s)
                              : by_shape<1>(tpl, word, thresholded, a, s);
  return (int)err;
}
