// The random init drawn on the card for Hopper (sm_90a): numpy's RandomState
// stream, bit for bit.
//
// Replaces no TPU kernel. The JAX package (and the port's host path,
// ops/init.py plsa_init and ops/driver.py _refit_init) draws the initial
// factors on the host: rows = rng.rand(r, L), each row divided by its sum
// (numpy's ndarray.sum(axis=1)), then cast to float32. One chunk of whole rows
// of one factor is two launches:
//
//   mt_twist     one block. numpy's MT19937 (mt19937_gen, mt19937_next): the
//                624-word key and pos from device memory (or, for a draw's
//                first chunk, from the host, passed by value), the words left
//                in the key used first, a twist only when pos is 624 and
//                another word is needed, so the end state is numpy's. A twist,
//                x[j + 624] = x[j + 397] ^ f(x[j], x[j + 1]), has three
//                phases: words 0-226 (from the old key alone), 227-453 (new
//                word j from new word j - 227), 454-623 (likewise; the last
//                word's neighbour is the new word 0). Thread t makes words t,
//                t + 227 and t + 454, each from its own word of the phase
//                before (held in registers), so the phases need no barrier
//                between them: a twist reads the old key from one buffer,
//                writes the new one to the other and takes one barrier (the
//                thread of word 623 makes the new word 0 again). The words go
//                to the chunk's scratch untempered; key and pos go back.
//   uniform_rows a warp a row of at most kUnit values; uniform_long_rows a
//                block a longer row. numpy's legacy double from two tempered
//                words, ((a >> 5) * 2^26 + (b >> 6)) / 2^53, exact in float64;
//                the row's sum in numpy's order (below); each value divided by
//                it in float64 (by 1.0 where the sum is not above 0 and
//                `guard` is set, as utils.normalize does), rounded to float32
//                and written at the destination's row stride. Padding is never
//                written.
//
// The sum. numpy adds a row as acc = 0.0; acc += pairwise(piece) over pieces
// of `piece` values (the inner loop of its reduction: numpy up to 2.2 cuts a
// row at its buffer size, 8192; 2.3 does not; ops/init.py _row_sum_piece
// finds which by a probe, and 0 here means one piece), where
// DOUBLE_pairwise_sum of n values is: below 8 one running sum from 0.0; up to
// 128 eight accumulators over the multiples of 8, combined as ((r0 + r1) +
// (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the tail one by one; above 128
// pairwise(first n2) + pairwise(rest), n2 = n / 2 rounded down to a multiple
// of 8. A warp walks that tree in post order with an explicit stack, every
// lane the same walk: nodes of at most kUnit values are units; in a unit the
// lanes take its leaves (at most 32, each of 64-128 values) one a lane, and
// the walk of the unit's own tree fetches each leaf's sum from its lane with
// a shuffle. A longer row's units go to the block's warps in turn, and one
// warp walks the tree above them over their sums. Every sum is the same tree
// in the same order as numpy's, with no contraction (no multiply feeds an
// add in a sum) and IEEE division and rounding (no fast-math flag), so the
// factors are the host's bits.
//
// Sizes: at the nytimes-k1000 cell a draw is 805.3 M words, 1.29 M twists,
// one barrier each: the serial twist is the draw's cost (about 0.2 us a
// twist on an H100; tempering in the twist added a fifth, so the rows
// kernels temper).

#include <cuda_runtime.h>
#include <cstring>

namespace {

constexpr int kN = 624;                  // MT19937's words
constexpr int kM = 397;
constexpr int kHalf = kN - kM;           // 227 words a phase (170 in the third)
constexpr unsigned kUpper = 0x80000000u;
constexpr unsigned kLower = 0x7fffffffu;
constexpr unsigned kMatrixA = 0x9908b0dfu;
constexpr int kTwistThreads = 256;
constexpr int kRowThreads = 256;         // 8 rows a block, a row of at most kUnit values
constexpr int kLongWarps = 16;           // a longer row's block
constexpr int kLeaf = 128;               // numpy's PW_BLOCKSIZE
constexpr int kUnit = 2048;              // at most 32 leaves of at least 64 values

struct MtState {
  unsigned key[kN];
  int pos;
};

__device__ __forceinline__ unsigned mix(unsigned cur, unsigned next) {
  const unsigned y = (cur & kUpper) | (next & kLower);
  return (y >> 1) ^ ((0u - (y & 1u)) & kMatrixA);
}

__device__ __forceinline__ unsigned temper(unsigned y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  return y ^ (y >> 18);
}

// n_words words of the stream, untempered, into out; state holds key[624], pos.
__global__ void __launch_bounds__(kTwistThreads)
mt_twist(MtState init, int from_init, unsigned* __restrict__ state, unsigned* __restrict__ out,
         long long n_words) {
  __shared__ unsigned buf[2][kN];
  const int t = threadIdx.x;
  for (int i = t; i < kN; i += kTwistThreads) buf[0][i] = from_init ? init.key[i] : state[i];
  int pos = from_init ? init.pos : static_cast<int>(state[kN]);
  __syncthreads();
  unsigned* cur = buf[0];
  unsigned* nxt = buf[1];
  long long done = kN - pos < n_words ? kN - pos : n_words;
  for (int i = t; i < done; i += kTwistThreads) out[i] = cur[pos + i];
  pos += static_cast<int>(done);
  // this thread's words t, t + 227 and t + 454 of the key, held from twist to twist
  const bool third = t < kN - 2 * kHalf;
  unsigned w0 = t < kHalf ? cur[t] : 0u, w1 = t < kHalf ? cur[t + kHalf] : 0u;
  unsigned w2 = third ? cur[t + 2 * kHalf] : 0u;
  while (done < n_words) {
    const long long left = n_words - done;
    const int take = left < kN ? static_cast<int>(left) : kN;
    if (t < kHalf) {
      // each phase's word from this thread's word of the phase before and the
      // old key alone
      w0 = cur[t + kM] ^ mix(w0, cur[t + 1]);
      w1 = w0 ^ mix(w1, cur[t + kHalf + 1]);
      nxt[t] = w0;
      nxt[t + kHalf] = w1;
      if (t < take) out[done + t] = w0;
      if (t + kHalf < take) out[done + t + kHalf] = w1;
      if (third) {
        const int i = t + 2 * kHalf;
        // the last word's neighbour is the new word 0, made again here
        const unsigned next = i + 1 < kN ? cur[i + 1] : cur[kM] ^ mix(cur[0], cur[1]);
        w2 = w1 ^ mix(w2, next);
        nxt[i] = w2;
        if (i < take) out[done + i] = w2;
      }
    }
    __syncthreads();
    done += take;
    pos = take;
    unsigned* s = cur;
    cur = nxt;
    nxt = s;
  }
  for (int i = t; i < kN; i += kTwistThreads) state[i] = cur[i];
  if (t == 0) state[kN] = static_cast<unsigned>(pos);
}

// numpy's legacy double from two untempered words.
__device__ __forceinline__ double uniform(uint2 w) {
  return (static_cast<double>(temper(w.x) >> 5) * 67108864.0 +
          static_cast<double>(temper(w.y) >> 6)) / 9007199254740992.0;
}

// numpy's pairwise_sum of at most kLeaf values.
__device__ double leaf_sum(const uint2* v, int n) {
  if (n < 8) {
    double res = 0.;
    for (int i = 0; i < n; ++i) res += uniform(v[i]);
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = uniform(v[j]);
  int i = 8;
  for (; i < n - (n % 8); i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += uniform(v[i + j]);
  }
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += uniform(v[i]);
  return res;
}

// A frame of the walk below: a node whose left half is summed (has_left) or
// being summed, and where its right half lies.
struct Frame {
  double left;
  int right_off, right_n, has_left;
};

// The pairwise tree over [0, n): sum(node) = sum(left) + sum(right), split at
// n / 2 rounded down to a multiple of 8; nodes of at most `most` values are
// summed by part(offset, length), in order from the left. Every lane of a warp
// walks it alike, on one stack in shared memory: each lane writes what the
// others write, and a __syncwarp parts each phase that reads a frame from the
// next that may rewrite it, so no lane runs ahead into a frame another still
// reads. A level at least halves n to within 8, so n below 2^31 takes at most
// 21 frames above 2048 values and 6 from 2048 down to 128.
template <class Part>
__device__ double walk(Frame* stack, int n, int most, Part part) {
  int sp = 0, off = 0;
  for (;;) {
    while (n > most) {
      int h = n / 2;
      h -= h % 8;
      stack[sp].right_off = off + h;
      stack[sp].right_n = n - h;
      stack[sp].has_left = 0;
      ++sp;
      n = h;
    }
    __syncwarp();
    double s = part(off, n);
    while (sp > 0 && stack[sp - 1].has_left) {
      --sp;
      s = stack[sp].left + s;
    }
    __syncwarp();
    if (sp == 0) return s;
    stack[sp - 1].left = s;
    stack[sp - 1].has_left = 1;
    off = stack[sp - 1].right_off;
    n = stack[sp - 1].right_n;
  }
}

constexpr int kOuterDepth = 32;
constexpr int kInnerDepth = 8;

// pairwise_sum of a unit of at most kUnit values, by the whole warp.
__device__ double unit_sum(Frame* stack, const uint2* v, int n, int lane) {
  int my_off = 0, my_n = 0, j = 0;
  walk(stack, n, kLeaf, [&](int off, int len) {
    if (j == lane) {
      my_off = off;
      my_n = len;
    }
    ++j;
    return 0.;
  });
  const double mine = my_n > 0 ? leaf_sum(v + my_off, my_n) : 0.;
  __syncwarp();
  j = 0;
  return walk(stack, n, kLeaf, [&](int, int) {
    return __shfl_sync(0xffffffffu, mine, j++);
  });
}

// A row of len values of at most kUnit, a warp a row: rows x len values from
// the words, each row over its sum, into out (row stride).
__global__ void __launch_bounds__(kRowThreads)
uniform_rows(const uint2* __restrict__ words, long long rows, int len, int piece, int guard,
             float* __restrict__ out, long long stride) {
  __shared__ Frame outer[kRowThreads / 32][kOuterDepth];
  __shared__ Frame inner[kRowThreads / 32][kInnerDepth];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (kRowThreads / 32) + warp;
  if (row >= rows) return;  // the warp's lanes alike
  const uint2* v = words + row * len;
  double acc = 0.;
  for (int off = 0; off < len; off += piece) {
    const int n = len - off < piece ? len - off : piece;
    acc += walk(outer[warp], n, kUnit, [&](int o, int m) {
      return unit_sum(inner[warp], v + off + o, m, lane);
    });
  }
  const double d = guard && !(acc > 0.) ? 1. : acc;
  float* o = out + row * stride;
  for (int j = lane; j < len; j += 32) o[j] = static_cast<float>(uniform(v[j]) / d);
}

// A longer row, a block a row: the block's warps sum its units (unit u on
// warp u % kLongWarps) into `sums`, one warp adds them up the tree, and the
// block divides. sums: the row's units' sums, units a row apart.
__global__ void __launch_bounds__(kLongWarps * 32)
uniform_long_rows(const uint2* __restrict__ words, int len, int piece, int guard,
                  double* __restrict__ sums, int units, float* __restrict__ out,
                  long long stride) {
  __shared__ Frame outer[kLongWarps][kOuterDepth];
  __shared__ Frame inner[kLongWarps][kInnerDepth];
  __shared__ double divisor;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = blockIdx.x;
  const uint2* v = words + row * len;
  double* us = sums + row * units;
  int u = 0;
  for (int off = 0; off < len; off += piece) {
    const int n = len - off < piece ? len - off : piece;
    walk(outer[warp], n, kUnit, [&](int o, int m) {
      if (u % kLongWarps == warp) {  // the warp's lanes alike
        const double s = unit_sum(inner[warp], v + off + o, m, lane);
        if (lane == 0) us[u] = s;
      }
      ++u;
      return 0.;
    });
  }
  __syncthreads();
  if (warp == 0) {
    u = 0;
    double acc = 0.;
    for (int off = 0; off < len; off += piece) {
      const int n = len - off < piece ? len - off : piece;
      acc += walk(outer[0], n, kUnit, [&](int, int) { return us[u++]; });
    }
    if (lane == 0) divisor = guard && !(acc > 0.) ? 1. : acc;
  }
  __syncthreads();
  const double d = divisor;
  float* o = out + row * stride;
  for (int j = threadIdx.x; j < len; j += kLongWarps * 32) {
    o[j] = static_cast<float>(uniform(v[j]) / d);
  }
}

// The units of a piece of n values: the nodes of at most kUnit values the
// walk stops at.
long long units_of(long long n) {
  if (n <= kUnit) return 1;
  long long h = n / 2;
  h -= h % 8;
  return units_of(h) + units_of(n - h);
}

}  // namespace

// One chunk: rows x len values drawn from the stream into out (row stride
// `stride` floats). host_key (624 words) and host_pos start the stream where
// host_key is not null, else `state` (625 words: key, pos) does; `state`
// holds where the chunk leaves it. scratch: 2 rows len words. piece: the
// values numpy sums a row in, one after another (0: the whole row). guard:
// divide by 1.0 where a row's sum is not above 0. sums: room for `room`
// doubles, the units' sums of rows longer than kUnit.
extern "C" int enstop_mt_uniform(const unsigned* host_key, int host_pos, unsigned* state,
                                 unsigned* scratch, long long rows, long long len,
                                 long long piece, int guard, double* sums, long long room,
                                 float* out, long long stride, void* stream) {
  if (rows < 0 || len < 0 || len >= (1LL << 31) || stride < len || piece < 0 ||
      (host_key && (host_pos < 0 || host_pos > kN))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  piece = piece > 0 && piece < len ? piece : len;
  long long units = 0;
  if (len > kUnit) {
    for (long long off = 0; off < len; off += piece) {
      units += units_of(len - off < piece ? len - off : piece);
    }
    if (rows * units > room) return static_cast<int>(cudaErrorInvalidValue);
  }
  MtState init;
  std::memset(&init, 0, sizeof init);
  if (host_key) {
    std::memcpy(init.key, host_key, sizeof init.key);
    init.pos = host_pos;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mt_twist<<<1, kTwistThreads, 0, s>>>(init, host_key != nullptr, state, scratch,
                                       2 * rows * len);
  const uint2* words = reinterpret_cast<const uint2*>(scratch);
  if (rows > 0 && len > kUnit) {
    uniform_long_rows<<<static_cast<unsigned>(rows), kLongWarps * 32, 0, s>>>(
        words, static_cast<int>(len), static_cast<int>(piece), guard, sums,
        static_cast<int>(units), out, stride);
  } else if (rows > 0 && len > 0) {
    const long long blocks = (rows * 32 + kRowThreads - 1) / kRowThreads;
    uniform_rows<<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
        words, rows, static_cast<int>(len), static_cast<int>(piece), guard, out, stride);
  }
  return static_cast<int>(cudaGetLastError());
}
