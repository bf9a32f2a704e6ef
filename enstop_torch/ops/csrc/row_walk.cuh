// The dense row walk for Hopper (sm_90a), shared by em_dense.cu (em_accumulate,
// kernels #1-#7) and em_batch.cu (batch_rows, #10's B).
//
// One warp owns one document row i of a zero-padded dense count matrix X (n, m),
// bf16 or fp32, and computes for each run r (a run is one (zd, wz) pair; the
// dense kernel has one):
//   S = zd[r, i, :] . wzT[r, j, :],  den = max(S, 1e-30),  for every X[i, j] != 0
//   B[r, i, :] = sum_j R(x, den) * W(wzT[r, j, :])          (never weighted)
//   ll        += x * logf(den) * w[i]                        (COMPUTE_LL, one run)
// R(x, den) = lane_walk::ratio<RATIO>(x, den): x / den (RATIO 0) and W(v) = v,
// or with RATIO 6 (BF16R) bf16(bf16(x) / bf16(den)) and bf16(v), each bf16
// value widened to fp32 (precision="fast"); RATIO 1-5 are the other ratio
// modes of the divide experiment, with W(v) = v (lane_walk.cuh).
//
// Three stages, decoupled:
//   1. Stream. The row is cut into windows of `window` bytes (a multiple of
//      512; the last one ragged, masked). Each warp has a ring of `stages`
//      windows in shared memory and keeps stages - 1 windows in flight while it
//      scans the current one, so the X stream runs while the warp walks. A
//      window is one 1-D TMA bulk copy that one lane issues, with the L2
//      evict-first policy (the factor tables stay in L2), completing on the
//      stage's mbarrier: the copy costs the warp a few instructions a window.
//      (16-byte cp.async copies, an instruction a chunk, measured no faster
//      and faulted at the 20NG shape: scripts/torch_dense_sweep.py, PERF.md.)
//   2. Compact. Lane l scans chunks l, l + 32, ... of the window (16 bytes
//      each). A ballot skips a row of 32 chunks that holds no nonzero (the
//      test is an OR of the chunk's words); otherwise a warp prefix sum
//      of the lanes' nonzero counts appends each nonzero, as (column j, x), to
//      the warp's queue in shared memory, in column order. When the next 32
//      chunks' nonzeros would not fit, the queue is walked first and emptied:
//      a row may hold any number of nonzeros (a fully dense row is walked in
//      many pieces).
//   3. Walk. L lanes take one entry, E = 32 / L entries a warp at once; a
//      lane holds TPL topics of the row's zd, of the gathered wzT row and of
//      its slot's B accumulator in registers, as C = TPL / V chunks of V topics
//      (V = 4: 16-byte loads, with kp % 4 == 0; else V = 1). The next entry's
//      wzT row is gathered one step ahead; S is summed over the lane's chunks,
//      then over its L lanes by log2(L) xor shuffles; one division serves E
//      entries. (L, TPL) is cuda_sparse.walk_shape(kp), as for em_sparse.cu.
//
// THE ORDER INVARIANT (both kernels obey it; nothing is summed with atomics):
//   * the q-th nonzero of a row, counted in column order across all windows,
//     goes to entry slot q mod E;
//   * each slot sums its entries in order (fmaf chains); S is summed in the
//     same per-lane order and the same xor order for every entry;
//   * at the row's end the slots are summed by a fixed xor tree over the slot
//     bits, lowest slot bit first (steps that would add only slots that took
//     no entry, +0, are skipped, which changes no bit);
//   * the LL is summed per entry in the same order, by the first lane of its
//     slot, then over the warp by a fixed xor tree, then per block in warp
//     order (em_dense.cu).
// So B and the LL do not depend on the window size, the stage count or the
// queue length; repeat launches give the same bits, and a batched
// run's B equals a single run's bit for bit.
//
// All arithmetic is fp32 (IEEE division in RATIO 0 and 6, logf; built without
// --use_fast_math).
// kp is at most 256, m below 2^31 columns.

#pragma once

#include "lane_walk.cuh"

namespace row_walk {

using namespace lane_walk;

constexpr int kMaxWarps = 16;      // warps a block at most (one row each)
constexpr int kMaxStages = 8;      // windows in the ring at most
constexpr int kWindowAlign = 512;  // a window is a multiple of 32 chunks of 16 bytes
// The other shapes that scripts/torch_dense_sweep.py times at kp = 20, 24 and
// 104 (cuda_em.SWEEP_SHAPES): built for bf16 X, 16-byte chunks and the B-only
// mode only.
constexpr int kSweepShapes[][2] = {{1, 24}, {2, 12}, {8, 4}, {8, 16}, {32, 4}};
constexpr int kNumSweepShapes = sizeof(kSweepShapes) / sizeof(kSweepShapes[0]);

// Runtime layout of one launch: rows of X, R runs' tables, the stream's shape.
struct Args {
  const void* X;     // (n, m), bf16 or fp32, rows 16-byte aligned
  const float* zd;   // (runs, n, kp)
  const float* wzT;  // (runs, m, kp)
  const float* w;    // (n,) document weights of the LL, or null
  float* B;          // (runs, n, kp), or null without WITH_B
  int64_t n, m, runs;
  int kp;
  int warps, stages, window, queue;
};

// Bytes of dynamic shared memory a block needs: the mbarriers (8 bytes a stage
// a warp, rounded up to 128), then per warp its ring and its queue.
static __host__ __device__ inline size_t smem_bytes(int warps, int stages, int window, int queue) {
  const size_t bars = ((size_t)warps * stages * 8 + 127) / 128 * 128;
  return bars + (size_t)warps * ((size_t)stages * window + 8 * (size_t)queue);
}

// Blocks of a launch: one row a warp.
static inline int64_t blocks_of(int64_t n, int warps) { return (n + warps - 1) / warps; }

// What the kernels take (cudaErrorInvalidValue otherwise): 1 <= kp <= 256 and
// lanes * tpl >= kp; 1 <= warps <= kMaxWarps; 2 <= stages <= kMaxStages; a
// window of a positive multiple of 512 bytes; a queue of a multiple of 32
// entries that holds 32 chunks' nonzeros (32 * vec_elems); whole 16-byte rows
// below 2^31 columns; one or more runs; a grid of at most 2^31 - 1 blocks.
static inline cudaError_t check(const Args& a, int lanes, int tpl, int vec_elems) {
  const bool ok = a.kp > 0 && a.kp <= 256 && (int64_t)lanes * tpl >= a.kp && a.warps >= 1 &&
                  a.warps <= kMaxWarps && a.stages >= 2 && a.stages <= kMaxStages &&
                  a.window > 0 && a.window % kWindowAlign == 0 && a.queue % 32 == 0 &&
                  a.queue >= 32 * vec_elems && a.m >= 0 && a.m < ((int64_t)1 << 31) &&
                  a.m % vec_elems == 0 && a.runs >= 1 && a.n >= 0 &&
                  blocks_of(a.n, a.warps) < ((int64_t)1 << 31);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// 16-byte chunks of the factor tables (V = 4): kp and tpl multiples of 4 and
// the tables 16-byte aligned
static inline int vec_ok(const Args& a, int tpl) {
  return a.kp % 4 == 0 && tpl % 4 == 0 &&
         ((uintptr_t)a.zd | (uintptr_t)a.wzT | (uintptr_t)a.B) % 16 == 0;
}

// Elements of X in one 16-byte chunk: element e as fp32, whether any element
// is nonzero, and the mask of the nonzero elements (bit e; -0 counts as zero,
// as x != 0.f does).
template <typename XT>
struct XVec;

template <>
struct XVec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    const uint32_t word = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
    return __uint_as_float(word);
  }
  __device__ __forceinline__ static bool any(const uint4& v) {
    return ((v.x | v.y | v.z | v.w) & 0x7fffffffu) != 0u;
  }
  __device__ __forceinline__ static unsigned nonzero(const uint4& v) {
    return ((v.x << 1) != 0u) | ((v.y << 1) != 0u) << 1 | ((v.z << 1) != 0u) << 2 |
           ((v.w << 1) != 0u) << 3;
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
  __device__ __forceinline__ static bool any(const uint4& v) {
    return ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0u;
  }
  __device__ __forceinline__ static unsigned nonzero(const uint4& v) {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    unsigned mask = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mask |= (unsigned)((words[q] & 0x7fffu) != 0u) << (2 * q);
      mask |= (unsigned)((words[q] & 0x7fff0000u) != 0u) << (2 * q + 1);
    }
    return mask;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// -- stage 1: the X stream ----------------------------------------------------

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// the mbarriers by their shared-memory addresses
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one lane: a 1-D bulk copy of `bytes` into shared memory, completing on `bar`,
// evict-first in L2
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  const uint64_t policy = evict_first_policy();
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// One warp's ring of windows and queue of nonzeros, and the stream of its rows
// through them (stages 1 and 2). Window k of a row goes to stage (s0 + k) mod
// stages, s0 the stage that follows the warp's last row; stage s's mbarrier
// completes one phase a window, its parity kept in bit s of `phases`.
template <typename XT>
struct RowStream {
  static constexpr int VEC = XVec<XT>::kN;
  // few members: they stay live across the walk, whose registers are scarce
  char* ring;             // stages windows of cw 16-byte chunks, then the queue
  unsigned bar0;          // the shared address of stage 0's mbarrier (8 bytes a stage)
  int stages, cw, queue, ring_bytes;
  int next_in, next_out;  // the stage of the next window to scan, to fill
  unsigned phases;        // bit s: the parity of stage s's next phase

  __device__ RowStream(unsigned char* smem, const Args& a, int warp)
      : stages(a.stages), cw(a.window / 16), queue(a.queue), ring_bytes(a.stages * a.window),
        next_in(0), next_out(0), phases(0u) {
    const size_t bars_bytes = ((size_t)a.warps * a.stages * 8 + 127) / 128 * 128;
    bar0 = smem_u32(smem) + 8u * (unsigned)(warp * a.stages);
    ring = reinterpret_cast<char*>(smem) + bars_bytes +
           (size_t)warp * ((size_t)ring_bytes + 8 * (size_t)a.queue);
    if (lane() == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8u * s);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncwarp();
  }

  __device__ __forceinline__ static int lane() { return threadIdx.x & 31; }
  // the queue: the column of each nonzero, and its value
  __device__ __forceinline__ int* qj() const { return reinterpret_cast<int*>(ring + ring_bytes); }
  __device__ __forceinline__ float* qx() const {
    return reinterpret_cast<float*>(ring + ring_bytes + 4 * queue);
  }
  __device__ __forceinline__ int after(int s) const { return s + 1 == stages ? 0 : s + 1; }

  // start the copy of the window at chunk c0 of the row (past the row's end:
  // nothing)
  __device__ __forceinline__ void issue(const uint4* xrow, int n_chunks, int c0) {
    __syncwarp();  // every lane is done with the window this stage held
    if (c0 >= n_chunks) return;
    if (lane() == 0) {
      const int left = n_chunks - c0;
      bulk_copy(ring + next_out * 16 * cw, xrow + c0, 16u * (unsigned)(left < cw ? left : cw),
                bar0 + 8u * next_out);
    }
    next_out = after(next_out);
  }

  // Stream one row (n_chunks 16-byte chunks at xrow) through the ring and the
  // queue. `piece(count, q0)` walks the queue's first `count` entries, the
  // row's nonzeros q0 .. q0 + count - 1, whenever the queue would overflow.
  // Returns the row's nonzeros; `count` is left holding those still queued
  // (the last `count` of them).
  template <class Piece>
  __device__ __forceinline__ int run(const uint4* xrow, int n_chunks, int& count,
                                     Piece&& piece) {
    next_out = next_in;  // every window of the last row was scanned
    for (int p = 0; p < stages - 1; ++p) issue(xrow, n_chunks, p * cw);
    int total = 0;
    count = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += cw) {
      mbar_wait(bar0 + 8u * next_in, (phases >> next_in) & 1u);
      phases ^= 1u << next_in;
      const char* win = ring + next_in * 16 * cw;
      next_in = after(next_in);
      issue(xrow, n_chunks, c0 + (stages - 1) * cw);
      const int lane = RowStream::lane();
      for (int u = lane; u < cw; u += 32) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + u < n_chunks) v = *reinterpret_cast<const uint4*>(win + 16 * u);
        if (__ballot_sync(kFull, XVec<XT>::any(v)) == 0u) continue;
        // the lanes' nonzeros in column order: an inclusive prefix sum of the counts
        unsigned mask = XVec<XT>::nonzero(v);
        const int mine = __popc(mask);
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int up = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += up;
        }
        const int all = __shfl_sync(kFull, incl, 31);
        if (count + all > queue) {  // walk the queue first; `queue` holds >= 32 chunks' worth
          __syncwarp();
          piece(count, total - count);
          __syncwarp();
          count = 0;
        }
        int pos = count + incl - mine;
        const int j0 = (c0 + u) * VEC;
        while (mask) {
          const int e = __ffs(mask) - 1;
          mask &= mask - 1u;
          qj()[pos] = j0 + e;
          qx()[pos] = XVec<XT>::get(v, e);
          ++pos;
        }
        count += all;
        total += all;
      }
    }
    __syncwarp();  // the queue is visible to the whole warp
    return total;
  }
};

// -- stage 3: the walk ----------------------------------------------------------

// One run's walk over a row's queued nonzeros: lane groups of L lanes, E = 32 / L
// entry slots, TPL topics a lane in C = TPL / V chunks of V. Chunk c of the lane
// at place g in its group holds topics (c L + g) V .. (c L + g) V + V - 1.
template <int L, int TPL, int V, bool WITH_B, bool COMPUTE_LL, int RATIO>
struct Walk {
  static constexpr bool BF16R = RATIO == kBf16r;
  static constexpr int E = 32 / L;
  static constexpr int C = TPL / V;
  static constexpr int STRIDE = L * V;  // topics from one chunk of a lane to its next
  static_assert(32 % L == 0 && TPL % V == 0, "L divides the warp, V divides TPL");
  int slot, first;
  bool live[C];
  float zd_r[C][V], acc[C][V];
  float ll;                // the LL of the lane's entries (first lane of a slot)
  const char* wz_first;    // wzT's row 0 at the lane's first topic
  unsigned row_bytes;

  __device__ Walk(int lane, int kp) : slot(lane / L), first(lane % L * V), ll(0.f) {
    row_bytes = 4u * (unsigned)kp;
#pragma unroll
    for (int c = 0; c < C; ++c) live[c] = first + c * STRIDE < kp;
  }

  // a new row: its zd row (kp floats) and the run's wzT (m, kp)
  __device__ __forceinline__ void begin(const float* zd_row, const float* wzT) {
    wz_first = reinterpret_cast<const char*>(wzT + first);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (live[c]) {
        Chunk<V>::load(zd_row + first + c * STRIDE, zd_r[c]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) zd_r[c][v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
    }
  }

  // the gathered wzT row of queue entry idx, or zeros outside 0 .. count - 1
  __device__ __forceinline__ void gather(const int* qj, int idx, int count, float (&g)[C][V]) {
    const bool on = idx >= 0 && idx < count;
    const float* row = reinterpret_cast<const float*>(
        wz_first + (size_t)(unsigned)(on ? qj[idx] : 0) * row_bytes);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (on && live[c]) {
        Chunk<V>::load(row + c * STRIDE, g[c]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) g[c][v] = 0.f;
      }
    }
  }

  // Walk queue entries 0 .. count - 1, the row's nonzeros q0 .. q0 + count - 1:
  // slot s takes those with q mod E == s, in order. A slot with no entry in a
  // step adds +0, which changes no bit. With B, the next entry's row is
  // gathered one step ahead; the LL sweep gathers each row in its step, which
  // keeps it below 64 registers without a spill (ptxas caps it there).
  __device__ __forceinline__ void piece(const int* qj, const float* qx, int count, int q0,
                                        float wi) {
    constexpr bool kAhead = WITH_B;
    const int r0 = q0 & (E - 1);
    float next[C][V];
    if (kAhead) gather(qj, slot - r0, count, next);
    for (int base = -r0; base < count; base += E) {
      const int idx = base + slot;
      const bool on = idx >= 0 && idx < count;
      const float x = on ? qx[idx] : 0.f;
      float g[C][V];
      if (kAhead) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int v = 0; v < V; ++v) g[c][v] = next[c][v];
        }
        gather(qj, idx + E, count, next);
      } else {
        gather(qj, idx, count, g);
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) s = fmaf(zd_r[c][v], g[c][v], s);
      }
#pragma unroll
      for (int off = 1; off < L; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
      const float den = fmaxf(s, kTiny);
      if (WITH_B) {
        const float r = ratio<RATIO>(x, den);
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[c][v] = fmaf(r, BF16R ? bf16r(g[c][v]) : g[c][v],
                                                       acc[c][v]);
        }
      }
      if (COMPUTE_LL && on && first == 0) ll += x * logf(den) * wi;
    }
  }

  // the row's end: the slots summed over the slot bits, lowest first (after the
  // step at offset L 2^i, slot 0 holds slots 0 .. 2^(i+1) - 1), then slot 0's
  // lanes write the row of B
  __device__ __forceinline__ void finish(int total, float* B_row) {
    if (!WITH_B) return;
    const int used = total < E ? total : E;
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
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (live[c]) Chunk<V>::store(B_row + first + c * STRIDE, acc[c]);
      }
    }
  }
};

// The rows of one warp (row i = blockIdx.x * warps + warp, one a warp), every
// run's B in turn: the row is streamed and compacted once; each run walks the
// queue. Only a row whose nonzeros overflow the queue is streamed again for
// each further run, as the first run's walk had to start before the row's
// end. Returns the warp lane's LL (COMPUTE_LL: one run).
template <typename XT, int L, int TPL, int V, bool WITH_B, bool COMPUTE_LL, int RATIO>
__device__ float walk_rows(const Args& a, unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  RowStream<XT> stream(smem, a, warp);
  Walk<L, TPL, V, WITH_B, COMPUTE_LL, RATIO> walk(lane, a.kp);
  const int n_chunks = (int)(a.m / XVec<XT>::kN);
  const int64_t i = (int64_t)blockIdx.x * a.warps + warp;
  if (i >= a.n) return 0.f;
  const uint4* xrow = reinterpret_cast<const uint4*>(static_cast<const XT*>(a.X) + i * a.m);
  const float wi = COMPUTE_LL ? __ldg(a.w + i) : 0.f;
  int total = 0, count = 0;
  for (int64_t r = 0; r < a.runs; ++r) {
    const float* wzT = a.wzT + r * a.m * a.kp;
    walk.begin(a.zd + (r * a.n + i) * a.kp, wzT);
    auto piece = [&](int cnt, int q0) { walk.piece(stream.qj(), stream.qx(), cnt, q0, wi); };
    if (r == 0 || total > a.queue) {
      total = stream.run(xrow, n_chunks, count, piece);
    } else {
      count = total;  // the whole row is still queued
    }
    piece(count, total - count);
    walk.finish(total, WITH_B ? a.B + (r * a.n + i) * a.kp : nullptr);
  }
  return walk.ll;
}

}  // namespace row_walk
