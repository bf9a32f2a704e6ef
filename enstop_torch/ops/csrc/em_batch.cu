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
// matmuls. Here B is the dense B pass of em_dense.cu run for every run over one
// stream of X (row_walk.cuh): a warp stages its document row through a ring of
// windows in shared memory and compacts its nonzeros into a queue there once,
// and then walks the queue once for each run, with that run's zd row and B
// accumulators in registers and its wzT rows gathered from L2. The queue holds
// `queue` nonzeros (512 by default; a 20NG row holds at most 196), so no run's
// accumulators are carried while X streams: only a row whose nonzeros overflow
// the queue is streamed again for each run after the first. A is
// em_sparse.cu's word pass over the word-major nonzeros of X, launched once
// for all R runs (the grid's y is the run; cuda_batch.batch_words), so each
// run's A is a single run's bit for bit.
//   * each run's walk is em_dense.cu's B-only walk, the same instance (walk
//     shape, chunk width) and row_walk.cuh's order invariant, so run r's B
//     equals a single-run em_accumulators_fused of run r bit for bit;
//   * no atomics: every element of B has one owner and one summing order, so
//     repeat launches give the same bits.
// Bound of the row pass: X read once (0.95 GB of bf16 at the 20NG shape,
// 18,848 x 25,088) and each run's zd, wz and B once: about 1.04 GB for R = 16,
// kp = 24, 0.31 ms at 3.35 TB/s. What keeps it above that: the walk, R times
// for each nonzero, is bound by instruction issue (about 16 instructions an
// entry at L = 4, as the segment walk of em_sparse.cu), and the runs' wzT
// tables (2.4 MB each at 20NG) must share the 50 MB L2.
// All arithmetic is fp32 (IEEE division; built without --use_fast_math).
// kp is at most 256.

#include "row_walk.cuh"

namespace {

using row_walk::Args;

template <typename XT, int L, int TPL, int V>
__global__ void __launch_bounds__(row_walk::kMaxWarps * 32) batch_rows(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  row_walk::walk_rows<XT, L, TPL, V, true, false, row_walk::kF32Div>(a, smem);
}

template <typename XT, int L, int TPL, int V>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const auto kernel = batch_rows<XT, L, TPL, V>;
  const size_t bytes = row_walk::smem_bytes(a.warps, a.stages, a.window, a.queue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)row_walk::blocks_of(a.n, a.warps), a.warps * 32, bytes, s>>>(a);
  return cudaGetLastError();
}

// the instance of shape I of kShapes (then, for bf16 X with V = 4, of
// kSweepShapes) that is (l, tpl)
template <typename XT, int V, int I>
cudaError_t by_shape(int l, int tpl, const Args& a, cudaStream_t s) {
  constexpr int kN = row_walk::kNumShapes;
  constexpr bool kSweep = V == 4 && sizeof(XT) == 2;
  if constexpr (I < kN + (kSweep ? row_walk::kNumSweepShapes : 0)) {
    constexpr int L = I < kN ? row_walk::kShapes[I][0] : row_walk::kSweepShapes[I - kN][0];
    constexpr int TPL = I < kN ? row_walk::kShapes[I][1] : row_walk::kSweepShapes[I - kN][1];
    if (l == L && tpl == TPL) return launch<XT, L, TPL, V>(a, s);
    return by_shape<XT, V, I + 1>(l, tpl, a, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t by_chunk(int vec, int l, int tpl, const Args& a, cudaStream_t s) {
  return vec ? by_shape<XT, 4, 0>(l, tpl, a, s) : by_shape<XT, 1, 0>(l, tpl, a, s);
}

}  // namespace

// The row pass, on one stream: B (R, n, kp) from X (n, m), zd (R, n, kp) and
// wzT (R, m, kp). lanes and tpl are the walk's shape and warps, stages, window
// and queue the stream's, as for enstop_em_dense (row_walk::check). Returns
// cudaGetLastError() after the launch (0 on success). The caller checks shapes,
// 16-byte alignment of X's rows and kp (at most 256).
extern "C" int enstop_em_batch(int x_bf16, int lanes, int tpl, int warps, int stages,
                               int window, int queue, const void* X, const void* zd,
                               const void* wzT, void* B, long long R, long long n,
                               long long m, int kp, void* stream) {
  const Args a{X, static_cast<const float*>(zd), static_cast<const float*>(wzT), nullptr,
               static_cast<float*>(B), n, m, R, kp, warps, stages, window, queue};
  cudaError_t err = row_walk::check(a, lanes, tpl, x_bf16 ? 8 : 4);
  if (err != cudaSuccess || n <= 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = row_walk::vec_ok(a, tpl);
  err = x_bf16 ? by_chunk<__nv_bfloat16>(vec, lanes, tpl, a, s)
               : by_chunk<float>(vec, lanes, tpl, a, s);
  return (int)err;
}
