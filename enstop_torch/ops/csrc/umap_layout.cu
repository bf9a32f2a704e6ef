// The UMAP layout's SGD for Hopper (sm_90a): every epoch in one launch.
//
// Replaces no TPU kernel. The JAX package runs the layout as one compiled
// lax.fori_loop (enstop_tpu/cluster/umap.py _optimize_layout_device); the port
// ran it as an eager PyTorch loop of about 135 small launches an epoch (67,500
// for 500 epochs), bound by dispatch and launch, not by the card. This kernel
// runs the loop of enstop_torch/cluster/umap.py _layout_loop, epoch by epoch,
// for the n points of the fuzzy graph's E directed edges (h, t):
//   alpha  = initial_alpha * (1 - epoch / n_epochs)   (double, then rounded to float)
//   active = next_epoch <= epoch + 1
//   attractive step, every term from the positions before it, over the active edges:
//     d = x[h] - x[t],  dsq = |d|^2 (the dimensions summed in order),
//     g = clamp((dsq > 0 ? c_att dsq^(b-1) / (a dsq^b + 1) : 0) d, -4, 4)
//     x[h] += alpha g,  then  x[t] += -alpha g
//   then `rounds` negative rounds, each from the positions the last one left:
//     n_e = draw(seed, epoch, round, e);  nothing if n_e == h or e is inactive
//     d = x[h] - x[n_e],  g = clamp((dsq > 0 ? (1 / ((0.001 + dsq)(a dsq^b + 1))) c_rep : 0) d, -4, 4)
//     x[h] += alpha g
//   next_epoch += eps over the active edges.
// c_att = -2ab and c_rep = 2b come from the caller, rounded to float as the
// loop rounds them. Every product, sum and quotient is one rounded fp32
// operation (the __f*_rn intrinsics: nothing contracted into an FMA), in the
// loop's order; powf is CUDA's, which may differ from the CPU's in the last
// bits (with b = 1 it is exact, and the kernel gives the loop's bits).
//
// Design. An ensemble's layout is one SM's worth (320 points of 5 floats and
// 4,800-9,600 edges), so below GRID_EDGES (ops/cuda_umap.py) one block of up
// to 1,024 threads runs it, with block-wide barriers between its phases; a
// larger graph (the UMAP facade's thousands of points) runs on about a thread
// an edge over many blocks, under grid-wide barriers (a cooperative launch).
// The same code runs both: only the barrier and the threads' numbering differ.
// An epoch first lists its active edges (a scan, block-wide and then over the
// blocks' totals; about 41 % of the edges at the ensemble's graph, since weak
// edges are sampled rarely) and moves their next_epoch on; then runs
// 1 + rounds steps, each reading one copy of the positions and writing the
// other, each in two phases:
//   1. a thread an active edge: its scalar coefficient (the part with dsq, the
//      powf and the quotient; 0 where the edge adds nothing) and, in a negative
//      round, its sample, into tables of E words. The attractive term is
//      computed once an edge, for both of its ends.
//   2. a thread a point (i = thread, thread + threads, ...): for each of its
//      coordinates k, the terms of the edges i heads and, in the attractive
//      step, of those it tails (by_tail, stable by tail; tail_heads their
//      other ends), each alpha clamp(c (x_i[k] - x_o[k])) (or its mirror),
//      summed from 0 in edge order, the heads' and the tails' apart, and added
//      as (x + heads) + tails, as the loop's segment sums do. The sums of up
//      to 8 coordinates are held in registers, in an instance for their number.
// Every term has one owner and one order, with no atomics, so a layout is the
// same bits from launch to launch and on any number of blocks. The negative
// samples come from a counter-based hash keyed by (seed, epoch, round, edge)
// (draw below; umap._negative_samples gives the same draws in numpy), so no
// state is carried between rounds. On one block the positions and the three
// tables sit in shared memory when 2 n dim + 3 E words fit the block's opt-in
// limit (read from the device; SMEM), else in device memory, the same code.
// Measured on an H100 at 320 points and 4,800 edges, 500 epochs (the design's
// steps, scripts/torch_umap_layout.py): a thread a point walking its own edges
// 39.4 ms; the two phases 30.5 ms; with the sums of a point's coordinates held
// in registers in an instance for their number 21.5 ms; over the active edges
// alone 13.8 ms. There, in shared memory 14.6 ms, in device memory 22.5 ms,
// on 132 blocks 26.2 ms (at most 3.7 us a grid-wide barrier); at 1,500 points in
// 20 dimensions (26,982 edges) one block 469 ms, 27 blocks 249 ms; at 10,000
// points in 2 (222,314 edges, 200 epochs) one block 391 ms, 218 blocks (the
// card holds 132 at once) 32.7 ms.
//
// Bound: the instructions on one SM. An epoch evaluates about 6 x 0.41 E
// coefficients (each active edge's attractive term once, with two powf, and 5
// negative ones with one), some 200 instructions each with powf and the IEEE
// quotient, and 6 n dim ordered sums of 15-30 terms (about 45 instructions a
// term of a point): about 0.12 M warp-instructions an epoch at E = 4,800,
// 15 us at 4 a cycle and 1.98 GHz, 7.6 ms for 500 epochs; and 8,000 barriers.
// The rest of the card idles: the layout is one small serial problem, and the
// point of the kernel is to take the 67,500 launches away.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBlocks = 1024;
constexpr int kChunk = 8;  // the coordinates of a point whose sums a thread holds at once
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Args {
  const int* heads;      // (E,) the head of each edge, nondecreasing
  const int* tails;      // (E,)
  const int* by_tail;    // (E,) the edge ids sorted stably by tail
  const int* tail_heads; // (E,) the head of each edge in that order
  const int* head_ptr;   // (n + 1,) the edges of head i: [head_ptr[i], head_ptr[i + 1])
  const int* tail_ptr;   // (n + 1,) by_tail[tail_ptr[i] .. tail_ptr[i + 1]) have tail i
  const float* eps;      // (E,) epochs per sample
  float* x;              // (n, dim): the start in, the layout out
  float* work;           // next_epoch (E), then, unless SMEM, the second copy of the
                         // positions (n dim), the coefficients, the samples and the
                         // active edges (E each), then a count a block (kMaxBlocks)
  long long n_edges;
  int n, dim, n_epochs, rounds;
  double initial_alpha;
  float a, b, b_minus_1, c_att, c_rep;
  uint32_t seed;
};

// lowbias32 (C. Wellons): a bijection of 32-bit words with good avalanche
__device__ inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ inline uint32_t round_key(uint32_t seed, uint32_t epoch, uint32_t round) {
  return mix32(mix32(mix32(seed ^ kGolden) ^ epoch) ^ round);
}

// the negative sample of edge e in the round of `key`: a point in [0, n) by multiply-shift
__device__ inline int draw(uint32_t key, uint32_t e, uint32_t n) {
  return (int)(((uint64_t)mix32(key ^ e) * n) >> 32);
}

// this thread's place among the launch's threads, and their number
__device__ inline int thread_id() { return blockIdx.x * blockDim.x + threadIdx.x; }
__device__ inline int n_threads() { return gridDim.x * blockDim.x; }

// a barrier of every thread of the launch, after which each sees what the
// others wrote before it: the block's for one block, else the grid's (the
// launch is cooperative, every block resident)
__device__ inline void sync_all() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cooperative_groups::this_grid().sync();
  }
}

__device__ inline float clamp4(float v) { return fminf(fmaxf(v, -4.0f), 4.0f); }

// |p - q|^2, the dimensions summed in order
__device__ inline float sq_dist(const float* p, const float* q, int dim) {
  float s = 0.0f;
  for (int k = 0; k < dim; ++k) {
    const float d = __fsub_rn(p[k], q[k]);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  return s;
}

__device__ inline float attract_coef(float dsq, const Args& a) {
  if (!(dsq > 0.0f)) return 0.0f;
  return __fdiv_rn(__fmul_rn(a.c_att, powf(dsq, a.b_minus_1)),
                   __fadd_rn(__fmul_rn(a.a, powf(dsq, a.b)), 1.0f));
}

__device__ inline float repel_coef(float dsq, const Args& a) {
  if (!(dsq > 0.0f)) return 0.0f;
  const float den = __fmul_rn(__fadd_rn(0.001f, dsq), __fadd_rn(__fmul_rn(a.a, powf(dsq, a.b)), 1.0f));
  return __fmul_rn(__frcp_rn(den), a.c_rep);
}

// The epoch's active edges (next_epoch <= limit), listed in `active` in edge
// order, a thread a run of consecutive edges placed by a scan of their counts
// (block-wide, then over the blocks' totals); each active edge's next_epoch
// moves on (nothing reads it again this epoch), and every edge's coefficient
// is cleared. Returns their number.
__device__ int list_active(const Args& a, float limit, float* coef, int* active) {
  __shared__ int warp_sums[kMaxThreads / 32];
  __shared__ int grid_at[2];  // the block's first place in the list, and the list's length
  const long long E = a.n_edges, per = (E + n_threads() - 1) / n_threads();
  const long long lo = min((long long)thread_id() * per, E), hi = min(lo + per, E);
  int mine = 0;
  for (long long e = lo; e < hi; ++e) {
    coef[e] = 0.0f;
    mine += a.work[e] <= limit;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = mine;  // inclusive sums within the warp, then of the warps' totals
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    if (lane < warps) warp_sums[lane] = w;
  }
  __syncthreads();
  int at = incl - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
  int total = warp_sums[warps - 1];
  if (gridDim.x > 1) {
    int* block_sums = reinterpret_cast<int*>(a.work + 4 * E + (long long)a.n * a.dim);
    if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
    sync_all();
    if (warp == 0) {
      int before = 0, all = 0;
      for (int j = lane; j < (int)gridDim.x; j += 32) {
        const int v = block_sums[j];
        all += v;
        before += j < (int)blockIdx.x ? v : 0;
      }
      for (int d = 16; d > 0; d >>= 1) {
        before += __shfl_down_sync(0xffffffffu, before, d);
        all += __shfl_down_sync(0xffffffffu, all, d);
      }
      if (lane == 0) {
        grid_at[0] = before;
        grid_at[1] = all;
      }
    }
    __syncthreads();
    at += grid_at[0];
    total = grid_at[1];
  }
  for (long long e = lo; e < hi; ++e) {
    const float ne = a.work[e];
    if (ne <= limit) {
      active[at++] = (int)e;
      a.work[e] = __fadd_rn(ne, a.eps[e]);
    }
  }
  return total;
}

// Phase 1: each active edge's coefficient (0 where it adds nothing) and, in a
// negative round (key), its sample. An inactive edge keeps coefficient 0 and
// its last sample.
template <bool ATTRACT>
__device__ void edge_terms(const Args& a, const float* x, float* coef, int* sample,
                           const int* active, int n_active, uint32_t key) {
  const int dim = a.dim;
  for (int j = thread_id(); j < n_active; j += n_threads()) {
    const int e = active[j], h = a.heads[e];
    const int o = ATTRACT ? a.tails[e] : draw(key, (uint32_t)e, (uint32_t)a.n);
    float c = 0.0f;
    if (ATTRACT || o != h) {
      const float dsq = sq_dist(x + (size_t)h * dim, x + (size_t)o * dim, dim);
      c = ATTRACT ? attract_coef(dsq, a) : repel_coef(dsq, a);
    }
    coef[e] = c;
    if (!ATTRACT) sample[e] = o;
  }
}

// Phase 2 for coordinates c0 .. c0 + W - 1 of point i: their sums in registers.
// An edge with coefficient 0 adds +-0 in the loop, which leaves every sum as
// it is: its term is computed and not added, so the walk has no branch.
template <bool ATTRACT, int W>
__device__ void chunk_sums(const Args& a, const float* x, float* y, const float* coef,
                           const int* sample, float alpha, int i, int c0) {
  const int dim = a.dim;
  float own[W], heads[W], tails[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    own[k] = x[(size_t)i * dim + c0 + k];
    heads[k] = tails[k] = 0.0f;
  }
  for (int e = a.head_ptr[i]; e < a.head_ptr[i + 1]; ++e) {
    const float c = coef[e];
    const float* xo = x + (size_t)(ATTRACT ? a.tails[e] : sample[e]) * dim + c0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float t = __fmul_rn(alpha, clamp4(__fmul_rn(c, __fsub_rn(own[k], xo[k]))));
      heads[k] = c != 0.0f ? __fadd_rn(heads[k], t) : heads[k];
    }
  }
  if (ATTRACT) {
    for (int q = a.tail_ptr[i]; q < a.tail_ptr[i + 1]; ++q) {
      const float c = coef[a.by_tail[q]];
      const float* xo = x + (size_t)a.tail_heads[q] * dim + c0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float t = __fmul_rn(-alpha, clamp4(__fmul_rn(c, __fsub_rn(xo[k], own[k]))));
        tails[k] = c != 0.0f ? __fadd_rn(tails[k], t) : tails[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float moved = __fadd_rn(own[k], heads[k]);
    y[(size_t)i * dim + c0 + k] = ATTRACT ? __fadd_rn(moved, tails[k]) : moved;
  }
}

// chunk_sums for w = min(kChunk, dim - c0) coordinates, an instance a width:
// a width held in registers and unrolled costs no instruction for a
// coordinate it does not have (measured: 5 coordinates in an 8-wide chunk
// took 33.2 ms a layout, in a 5-wide one 28.1 ms)
template <bool ATTRACT, int W = kChunk>
__device__ void chunk_sums_of(int w, const Args& a, const float* x, float* y, const float* coef,
                              const int* sample, float alpha, int i, int c0) {
  if constexpr (W > 1) {
    if (w < W) return chunk_sums_of<ATTRACT, W - 1>(w, a, x, y, coef, sample, alpha, i, c0);
  }
  chunk_sums<ATTRACT, W>(a, x, y, coef, sample, alpha, i, c0);
}

// Phase 2: y from x, a thread a point, the sums of up to kChunk of its
// coordinates at once (its edges walked again for each further kChunk).
template <bool ATTRACT>
__device__ void point_sums(const Args& a, const float* x, float* y, const float* coef,
                           const int* sample, float alpha) {
  for (int i = thread_id(); i < a.n; i += n_threads()) {
    for (int c0 = 0; c0 < a.dim; c0 += kChunk) {
      chunk_sums_of<ATTRACT>(min(kChunk, a.dim - c0), a, x, y, coef, sample, alpha, i, c0);
    }
  }
}

// Positions and tables are never read through the read-only cache: a phase
// reads what the last one wrote in the same launch.
template <bool SMEM>
__global__ void __launch_bounds__(kMaxThreads) layout(Args a) {
  extern __shared__ float smem[];
  const size_t nd = (size_t)a.n * a.dim, E = (size_t)a.n_edges;
  float* src = SMEM ? smem : a.x;  // the positions a step reads
  float* dst = SMEM ? smem + nd : a.work + E;  // and those it writes
  float* coef = SMEM ? smem + 2 * nd : a.work + E + nd;
  int* sample = reinterpret_cast<int*>(coef + E);
  int* active = sample + E;
  const size_t tid = thread_id(), stride = n_threads();
  if (SMEM) {
    for (size_t p = tid; p < nd; p += stride) src[p] = a.x[p];
  }
  for (size_t e = tid; e < E; e += stride) {
    a.work[e] = a.eps[e];
    sample[e] = 0;  // phase 2 reads an inactive edge's sample, and adds nothing
  }
  sync_all();
  for (int epoch = 0; epoch < a.n_epochs; ++epoch) {
    const float alpha = (float)__dmul_rn(
        a.initial_alpha, __dsub_rn(1.0, __ddiv_rn((double)epoch, (double)a.n_epochs)));
    const int n_active = list_active(a, (float)(epoch + 1), coef, active);
    sync_all();
    for (int r = -1; r < a.rounds; ++r) {  // -1: the attractive step
      if (r < 0) {
        edge_terms<true>(a, src, coef, sample, active, n_active, 0u);
      } else {
        edge_terms<false>(a, src, coef, sample, active, n_active,
                          round_key(a.seed, (uint32_t)epoch, (uint32_t)r));
      }
      sync_all();
      if (r < 0) {
        point_sums<true>(a, src, dst, coef, sample, alpha);
      } else {
        point_sums<false>(a, src, dst, coef, sample, alpha);
      }
      sync_all();
      float* t = src;
      src = dst;
      dst = t;
    }
  }
  if (src != a.x) {
    for (size_t p = tid; p < nd; p += stride) a.x[p] = src[p];
  }
}

}  // namespace

// The layout, on one stream. `packed` holds, as 32-bit words: heads, tails,
// by_tail, tail_heads (E each), head_ptr, tail_ptr (n + 1 each), eps (E floats) and the
// start (n x dim floats), which the kernel overwrites with the layout;
// `scratch` holds 4 E + n x dim + kMaxBlocks words. blocks: at most this many
// blocks of `threads` threads (a multiple of 32 up to 1024), and no more than
// the card holds at once; more than one run as a cooperative launch, under
// grid-wide barriers. shared: the positions and the tables in shared memory
// where one block runs and 2 n dim + 3 E words fit the block's opt-in limit,
// read from the device. Returns the launch's CUDA error (0 on success).
extern "C" int enstop_umap_layout(void* packed, void* scratch, long long n_edges, int n,
                                  int dim, int n_epochs, int rounds, double initial_alpha,
                                  float a, float b, float b_minus_1, float c_att, float c_rep,
                                  unsigned int seed, int shared, int blocks, int threads,
                                  void* stream) {
  if (n <= 0 || dim <= 0 || (long long)n * dim >= (1LL << 31) || n_edges <= 0 ||
      n_edges >= (1LL << 31) || n_epochs < 0 || rounds < 0 || blocks <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  int* words = static_cast<int*>(packed);
  const long long E = n_edges;
  Args args{words, words + E, words + 2 * E, words + 3 * E, words + 4 * E,
            words + 4 * E + n + 1, reinterpret_cast<const float*>(words + 4 * E + 2 * (n + 1)),
            reinterpret_cast<float*>(words + 5 * E + 2 * (n + 1)),
            static_cast<float*>(scratch), E, n, dim, n_epochs, rounds, initial_alpha, a, b,
            b_minus_1, c_att, c_rep, seed};
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaFuncAttributes smem_kernel;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layout<false>, threads, 0);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&smem_kernel, layout<true>);
  if (err != cudaSuccess) return (int)err;
  blocks = blocks < sms * per_sm ? blocks : sms * per_sm;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = sizeof(float) * (2 * (size_t)n * dim + 3 * (size_t)E);
  void* params[] = {&args};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared && blocks == 1 && bytes + smem_kernel.sharedSizeBytes <= (size_t)optin) {
    err = cudaFuncSetAttribute(layout<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess) {
      err = cudaLaunchCooperativeKernel((const void*)layout<true>, 1, threads, params, bytes, s);
    }
  } else {
    err = cudaLaunchCooperativeKernel((const void*)layout<false>, blocks, threads, params, 0, s);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
