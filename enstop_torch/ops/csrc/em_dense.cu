// Dense-tile pLSA EM kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels in enstop_tpu/ops/pallas_em.py:
//   _make_em_kernel     (fused E+M step: A, B and optional LL)     -> WITH_B (+ the word pass)
//   _make_refit_kernel  (frozen-topics step: B and optional LL)    -> WITH_B
//   _make_ll_kernel     (log-likelihood sweep only)                -> COMPUTE_LL only
// (and the grid-order variants _make_em_kernel_jo / _make_em_kernel_jo_resident /
// _make_refit_kernel_jo_resident(bf16_r=False) of pallas_em_variants.py, which
// compute the same functions), and, with BF16R (ratio mode 6), the bf16-responsibilities
// kernels of precision="fast" in enstop_tpu/ops/pallas_em_variants.py:
//   _make_em_kernel_jo_resident(bf16_r=True)     -> WITH_B, BF16R (+ the word pass)
//   _make_refit_kernel_jo_resident(bf16_r=True)  -> WITH_B, BF16R
// and the TPU experiments outside the package:
//   scripts/exp_divide_pipeline.py:88 (the kernel of _make_em_call: the EM step
//     without LL in seven ratio modes)  -> WITH_B, RATIO 0-6 (+ the word pass)
//   scripts/exp_kernel_variants.py:52 _make_em_kernel_nomask (the mask-free
//     step, since shipped as _make_em_kernel)  -> as _make_em_kernel
// BF16R is ratio mode 6 (lane_walk.cuh: ratio<RATIO>), the fp32 modes mode 0;
// modes 1-5 are built for bf16 X, B only, at (L, TPL) = (4, 8) alone.
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
// x 2 B = 0.95 GB of bf16 per step, 0.28 ms at 3.35 TB/s (0.32 ms measured for
// the stream alone). The walk over the 2.7 M nonzeros costs about as much SM
// time again if it is done one nonzero a warp at a time (about 21 SM-cycles
// and 40 instructions a nonzero), and a warp that walks issues no loads. So the
// design (row_walk.cuh) keeps the walk off the stream:
//   * one warp owns one document row and stages it through a ring of windows
//     in shared memory with asynchronous copies (TMA bulk copies, evict-first,
//     so the factors stay in L2), stages - 1 windows in flight
//     while it scans and walks the current one;
//   * it compacts the window's nonzeros into a queue in shared memory (a
//     ballot skips empty chunks, a prefix sum places the rest in column
//     order) and walks the queue with the segment walk's lane groups (L lanes
//     an entry, E = 32 / L entries at once, one division for E entries, the
//     next entry's wzT row gathered one step ahead), with the row's zd and its
//     B accumulators in registers;
//   * B[i, :] is written once per row: no cross-block reduction, no atomics;
//   * ll is summed per entry by the first lane of each slot, over the warp by a
//     fixed xor tree, per block over its warps in order, and written as one
//     partial per block; the caller sums the partials in order.
// Every sum has the fixed order of row_walk.cuh's order invariant, so B and ll
// are the same from launch to launch and whatever the stream's shape. All
// arithmetic is fp32 (IEEE division and logf; built without --use_fast_math).
// kp is at most 256.

#include "row_walk.cuh"

namespace {

using row_walk::Args;

template <typename XT, int L, int TPL, int V, bool WITH_B, bool COMPUTE_LL, int RATIO>
__global__ void __launch_bounds__(row_walk::kMaxWarps * 32)
em_accumulate(Args a, float* __restrict__ ll_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ll_warp[row_walk::kMaxWarps];
  float ll = row_walk::walk_rows<XT, L, TPL, V, WITH_B, COMPUTE_LL, RATIO>(a, smem);
  if (COMPUTE_LL) {
    ll = row_walk::warp_sum(ll);
    if ((threadIdx.x & 31) == 0) ll_warp[threadIdx.x >> 5] = ll;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int k = 0; k < a.warps; ++k) total += ll_warp[k];
      ll_part[blockIdx.x] = total;
    }
  }
}

template <typename XT, int L, int TPL, int V, bool WITH_B, bool COMPUTE_LL, int RATIO>
cudaError_t launch(const Args& a, float* ll_part, cudaStream_t s) {
  const auto kernel = em_accumulate<XT, L, TPL, V, WITH_B, COMPUTE_LL, RATIO>;
  const size_t bytes = row_walk::smem_bytes(a.warps, a.stages, a.window, a.queue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)row_walk::blocks_of(a.n, a.warps), a.warps * 32, bytes, s>>>(a, ll_part);
  return cudaGetLastError();
}

// the modes: B + LL, B only, their bf16r forms, and the LL sweep (fp32 only:
// precision="fast" keeps the fp32 LL); ratio modes 1-5 (lane_walk.cuh) only
// where the divide experiment ran its step: bf16 X, B only, at the walk shape
// of kp 17-32, (L, TPL) = (4, 8)
template <typename XT, int L, int TPL, int V>
cudaError_t by_mode(int ratio, int with_b, int compute_ll, const Args& a, float* ll_part,
                    cudaStream_t s) {
  using row_walk::kBf16r;
  using row_walk::kF32Div;
  if (with_b) {
    if (ratio == kBf16r) {
      return compute_ll ? launch<XT, L, TPL, V, true, true, kBf16r>(a, ll_part, s)
                        : launch<XT, L, TPL, V, true, false, kBf16r>(a, ll_part, s);
    }
    if (ratio == kF32Div) {
      return compute_ll ? launch<XT, L, TPL, V, true, true, kF32Div>(a, ll_part, s)
                        : launch<XT, L, TPL, V, true, false, kF32Div>(a, ll_part, s);
    }
    if constexpr (sizeof(XT) == 2 && L == 4 && TPL == 8) {
      if (!compute_ll) {
        switch (ratio) {
          case 1: return launch<XT, L, TPL, V, true, false, 1>(a, ll_part, s);
          case 2: return launch<XT, L, TPL, V, true, false, 2>(a, ll_part, s);
          case 3: return launch<XT, L, TPL, V, true, false, 3>(a, ll_part, s);
          case 4: return launch<XT, L, TPL, V, true, false, 4>(a, ll_part, s);
          case 5: return launch<XT, L, TPL, V, true, false, 5>(a, ll_part, s);
          default: break;
        }
      }
    }
    return cudaErrorInvalidValue;
  }
  if (compute_ll && ratio == kF32Div) {
    return launch<XT, L, TPL, V, false, true, kF32Div>(a, ll_part, s);
  }
  return cudaErrorInvalidValue;
}

// the instance of shape I of kShapes (then, for bf16 X with V = 4 in the B-only
// mode, of kSweepShapes) that is (l, tpl)
template <typename XT, int V, int I>
cudaError_t by_shape(int l, int tpl, int ratio, int with_b, int compute_ll, const Args& a,
                     float* ll_part, cudaStream_t s) {
  constexpr int kN = row_walk::kNumShapes;
  constexpr bool kSweep = V == 4 && sizeof(XT) == 2;
  if constexpr (I < kN) {
    constexpr int L = row_walk::kShapes[I][0], TPL = row_walk::kShapes[I][1];
    if (l == L && tpl == TPL) {
      return by_mode<XT, L, TPL, V>(ratio, with_b, compute_ll, a, ll_part, s);
    }
    return by_shape<XT, V, I + 1>(l, tpl, ratio, with_b, compute_ll, a, ll_part, s);
  } else if constexpr (kSweep && I < kN + row_walk::kNumSweepShapes) {
    constexpr int L = row_walk::kSweepShapes[I - kN][0], TPL = row_walk::kSweepShapes[I - kN][1];
    if (l == L && tpl == TPL && with_b && !compute_ll && ratio == row_walk::kF32Div) {
      return launch<XT, L, TPL, V, true, false, row_walk::kF32Div>(a, ll_part, s);
    }
    return by_shape<XT, V, I + 1>(l, tpl, ratio, with_b, compute_ll, a, ll_part, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t by_chunk(int vec, int l, int tpl, int ratio, int with_b, int compute_ll,
                     const Args& a, float* ll_part, cudaStream_t s) {
  return vec ? by_shape<XT, 4, 0>(l, tpl, ratio, with_b, compute_ll, a, ll_part, s)
             : by_shape<XT, 1, 0>(l, tpl, ratio, with_b, compute_ll, a, ll_part, s);
}

}  // namespace

// One entry point for all the modes; ratio is lane_walk.cuh's mode (0 fp32,
// 6 bf16r, 1-5 as by_mode builds them). Returns cudaGetLastError() after the
// launch (0 on success). lanes and tpl are the walk's shape (L, TPL), one of
// row_walk.cuh's kShapes (or, for bf16 X in the B-only mode with kp % 4 == 0,
// kSweepShapes) with L * TPL >= kp; warps, stages, window and queue the
// stream's (row_walk::check). ll_part holds one float per block of the grid
// (ceil(n / warps)); with COMPUTE_LL off it is not written. The caller checks
// shapes, 16-byte alignment of X's rows and kp (at most 256).
extern "C" int enstop_em_dense(int x_bf16, int ratio, int with_b, int compute_ll, int lanes,
                               int tpl, int warps, int stages, int window, int queue,
                               const void* X, const void* zd, const void* wzT, const void* w,
                               void* B, void* ll_part, long long n, long long m, int kp,
                               void* stream) {
  const Args a{X, static_cast<const float*>(zd), static_cast<const float*>(wzT),
               static_cast<const float*>(w), static_cast<float*>(B), n, m, 1, kp,
               warps, stages, window, queue};
  cudaError_t err = row_walk::check(a, lanes, tpl, x_bf16 ? 8 : 4);
  if (err == cudaSuccess && (ratio < 0 || ratio > row_walk::kBf16r)) err = cudaErrorInvalidValue;
  if (err != cudaSuccess || n <= 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = row_walk::vec_ok(a, tpl);
  float* llp = static_cast<float*>(ll_part);
  err = x_bf16 ? by_chunk<__nv_bfloat16>(vec, lanes, tpl, ratio, with_b, compute_ll, a, llp, s)
               : by_chunk<float>(vec, lanes, tpl, ratio, with_b, compute_ll, a, llp, s);
  return (int)err;
}
