// The register-resident NTT rounds: the one negacyclic NTT algorithm of
// csrc/, shared by the CGGI step (cggi_step.cuh) and the NTT kernels
// (ntt.cuh).
//
// Positions and tables (fhe_tpu/math/ntt.py forward_butterfly /
// inverse_butterfly): the forward (Cooley-Tukey) stages take natural COEFF
// order and leave bit-reversed EVAL order (position x holds slot brev(x));
// the inverse (Gentleman-Sande) stages take that order and leave natural
// COEFF order without the N^-1 scale.  The butterfly on position bit b of
// the pair at x takes entry (N + x) >> (b + 1) of its table (psi^br or
// psi^-br, with Shoup companions), in both directions.
//
// A transform of N = 2^LogN values has G = N/8 threads.  A round runs up to
// four stages on 8 or 16 values in a thread's registers (`ntt_round`), and
// rounds exchange through shared memory.  Rounds cover position bits
// {0,1,2} | 3..LogN-4 | {LogN-3,LogN-2,LogN-1}: the inverse low to high, the
// forward high to low.  The edge rounds are the callers' (they load or store
// global memory or registers there); the middle rounds are `mid_rounds`.
//
// Reduction.  Lazy (needs 4q < 2^32, q < 2^30): Harvey butterflies keep the
// forward in [0, 4q) and the inverse in [0, 2q), with Shoup twiddles that
// accept any 32-bit input.  Canonical (q < 2^31): every butterfly returns
// [0, q), two more minima each.
#pragma once

#include <cstdint>

namespace fhe {

// The NTT plan's tables and the monomial table: in shared memory (the whole
// scan, loaded once per block) or in global memory (the single step and the
// NTT kernels, read through L1).
struct Tables {
  const uint32_t* fwd_w;
  const uint32_t* fwd_ws;
  const uint32_t* inv_w;
  const uint32_t* inv_ws;
  const uint32_t* pw;
};

// x in [0, 2m) -> [0, m); also [0, 2^32) -> x or x - m, whichever is smaller.
__device__ __forceinline__ uint32_t reduce(uint32_t x, uint32_t m) { return min(x, x - m); }

// a * w mod q in [0, 2q) for any 32-bit a; ws = floor(w 2^32 / q), w < q.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w, uint32_t ws,
                                               uint32_t q) {
  return a * w - __umulhi(a, ws) * q;
}

// The run of n consecutive twiddles at p (n a power of two, a constant once
// unrolled; p 4n-byte aligned up to 16 bytes): one load, one 8-byte load or
// one 16-byte load per four.
template <int kMax>
__device__ __forceinline__ void load_run(const uint32_t* p, int n, uint32_t (&r)[kMax]) {
  if (n == 1) {
    r[0] = p[0];
  } else if (n == 2) {
    if constexpr (kMax >= 2) {
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      r[0] = a.x;
      r[1] = a.y;
    }
  } else if constexpr (kMax >= 4) {
#pragma unroll
    for (int m = 0; m < kMax; m += 4) {
      if (m < n) {
        const uint4 a = *reinterpret_cast<const uint4*>(p + m);
        r[m] = a.x;
        r[m + 1] = a.y;
        r[m + 2] = a.z;
        r[m + 3] = a.w;
      }
    }
  }
}

// W butterfly stages on v[k], the values at positions
// (hi << (B0 + W)) + (k << B0) + lo (k < 2^W, lo < 2^B0): the stages on
// position bits B0..B0+W-1, inverse low bit first, forward high bit first.
// Lazy: inverse [0, 2q) in and out; forward [0, 4q) in and out.  Canonical
// (kLazy false): [0, q) in and out.  A stage's twiddles are a run of
// consecutive table entries: with kVec (tables 16-byte aligned) the run is
// loaded with load_run, else entry by entry.
template <bool kFwd, int LogN, int B0, int W, bool kLazy = true, bool kVec = false>
__device__ __forceinline__ void ntt_round(uint32_t (&v)[1 << W], int hi, const Tables& t,
                                          uint32_t q) {
  const uint32_t two_q = 2 * q;
  const uint32_t* tw = kFwd ? t.fwd_w : t.inv_w;
  const uint32_t* tws = kFwd ? t.fwd_ws : t.inv_ws;
#pragma unroll
  for (int s = 0; s < W; ++s) {
    const int u = kFwd ? W - 1 - s : s;
    const int tb = ((1 << (LogN - B0 - W)) + hi) << (W - 1 - u);
    uint32_t wr[1 << (W - 1)], wsr[1 << (W - 1)];
    if constexpr (kVec) {
      load_run(tw + tb, 1 << (W - 1 - u), wr);
      load_run(tws + tb, 1 << (W - 1 - u), wsr);
    }
#pragma unroll
    for (int k = 0; k < (1 << W); ++k) {
      if (k & (1 << u)) continue;
      uint32_t w, ws;
      if constexpr (kVec) {
        w = wr[k >> (u + 1)];
        ws = wsr[k >> (u + 1)];
      } else {
        const int ti = tb + (k >> (u + 1));
        w = tw[ti];
        ws = tws[ti];
      }
      uint32_t& x = v[k];
      uint32_t& y = v[k | (1 << u)];
      if (kFwd) {
        if constexpr (kLazy) {
          const uint32_t a = reduce(x, two_q);
          const uint32_t t = shoup_lazy(y, w, ws, q);
          x = a + t;
          y = a - t + two_q;
        } else {
          const uint32_t t = reduce(shoup_lazy(y, w, ws, q), q);
          const uint32_t a = x;
          x = reduce(a + t, q);
          y = reduce(a - t + q, q);
        }
      } else {
        if constexpr (kLazy) {
          const uint32_t sum = x + y;
          const uint32_t diff = x - y + two_q;
          x = reduce(sum, two_q);
          y = shoup_lazy(diff, w, ws, q);
        } else {
          const uint32_t sum = x + y;
          const uint32_t diff = x - y + q;
          x = reduce(sum, q);
          y = reduce(shoup_lazy(diff, w, ws, q), q);
        }
      }
    }
  }
}

// Word of position x of row `row`, ciphertext lane c, in the step's exchange
// buffers: N-word rows with C ciphertexts interleaved word by word.  The
// swizzle XORs bank bits 0-2 with position bits kBeta..kBeta+2 and bank bits
// 3..kBeta-1 with position bits 7.., kBeta = log2(32 / C) bank bits per
// ciphertext: then the lanes of every round of the step hit distinct banks.
template <int LogN, int C>
__device__ __forceinline__ int word(int row, int x, int c) {
  constexpr int kBeta = C == 1 ? 5 : 4;
  const int sx = x ^ ((x >> kBeta) & 7) ^ (((x >> 7) & ((1 << (kBeta - 3)) - 1)) << 3);
  return ((row << LogN) + sx) * C + c;
}

// Word of position x of row `row` in the NTT kernels' exchange buffer (one
// N-word row per transform).  Across a warp the lanes vary position bits
// 0-4 (rounds on positions g + j N/8), bits 0-2 and 7-8 (middle rounds over
// bits 3.., item_base), bits 3-7 (positions 8g + k) and the top five bits
// (positions 8 brev(g) + k, the bit reversal folded into the thread map).
// The swizzle is the step's (bits 5-7 onto bank bits 0-2, bits 7-8 onto
// 3-4) with bit 8 also onto bank bit 3, bit 9 onto 3 and bits 10-12 onto
// 0-2: each of those lane sets then maps onto 32 distinct banks, for
// 9 <= LogN <= 13 (ntt_swizzled_top above).  The swizzle is linear in the bits of x, so where x =
// base | off with no bit in common, the word is ntt_word(row, base) XOR a
// constant of off: NttRounds::at computes the base's word once per item and
// one XOR per access.
__device__ __forceinline__ constexpr int ntt_swizzled(int x) {
  return x ^ ((x >> 5) & 7) ^ ((x >> 4) & 24) ^ (((x >> 5) ^ (x >> 6)) & 8) ^ ((x >> 10) & 7);
}

// From N = 2^14 the lanes vary position bits 0-4, bits 0-2 and 7-8, bits
// 3-7 and the top five bits LogN-5..LogN-1: bits 5-7 onto bank bits 0-2,
// bits 7-8 onto 3-4 and the top five bits onto 0-4 map each of those sets
// onto 32 distinct banks.  (ntt_swizzled sends no bit onto bank bit 4 from
// bit 13.)  At 2^15 the middle rounds' lanes vary bits 0-2 and 7-8 (the
// first, over bits 3-5) or bits 0-4 (the others), sets the same map takes.
template <int LogN>
__device__ __forceinline__ constexpr int ntt_swizzled_top(int x) {
  return x ^ ((x >> 5) & 7) ^ ((x >> 4) & 24) ^ ((x >> (LogN - 5)) & 31);
}

template <int LogN>
__device__ __forceinline__ constexpr int ntt_swizzle(int x) {
  if constexpr (LogN >= 14) {
    return ntt_swizzled_top<LogN>(x);
  } else {
    return ntt_swizzled(x);
  }
}

template <int LogN>
__device__ __forceinline__ int ntt_word(int row, int x) {
  static_assert(LogN >= 9 && LogN <= 15, "ntt_word: 9 <= LogN <= 15");
  return (row << LogN) + ntt_swizzle<LogN>(x);
}

// How a caller's middle rounds run: the arithmetic (kLazy), the twiddle
// loads (kVec), the threads that share the buffer's rows (kThreads) and the
// word of position base + off (off a compile-time multiple of a power of
// two above every bit of base).  The step's: lazy, G threads per
// ciphertext lane, its swizzle, and twiddles entry by entry (vector runs
// would change its code, whose registers and spills are tuned at the cap).
template <int LogN, int C>
struct StepRounds {
  static constexpr bool kLazy = true, kVec = false;
  static constexpr int kThreads = 1 << (LogN - 3);
  static __device__ __forceinline__ int at(int row, int base, int off, int c) {
    return word<LogN, C>(row, base + off, c);
  }
};

// The NTT kernels': vector twiddle runs, all the block's threads on its
// rows, one XOR a word.
template <int LogN, bool kLazyArith, int kBlockThreads>
struct NttRounds {
  static constexpr bool kLazy = kLazyArith, kVec = true;
  static constexpr int kThreads = kBlockThreads;
  static __device__ __forceinline__ int at(int row, int base, int off, int) {
    return ntt_word<LogN>(row, base) ^ ntt_swizzle<LogN>(off);
  }
};

// Item `it` of a middle round over bits [B0, B0 + W): returns its first
// position and sets hi, its position bits above the round.  The lanes of a
// warp take consecutive items; where B0 = 3 the item bits 3-4 (which vary
// across a warp) go to position bits 7-8, the bits the swizzle spreads.
template <int B0, int W>
__device__ __forceinline__ int item_base(int it, int& hi) {
  hi = it >> B0;
  if constexpr (B0 == 3 && B0 + W < 7) {
    constexpr int p0 = 7 - (B0 + W);
    const int lane = hi & 3, rest = hi >> 2;
    hi = (rest & ((1 << p0) - 1)) | (lane << p0) | ((rest >> p0) << (p0 + 2));
  }
  return (hi << (B0 + W)) | (it & ((1 << B0) - 1));
}

// One middle round over P rows of `buf`, in place: thread g (of R::kThreads
// sharing the rows; G in the step, one ciphertext lane c) takes items g,
// g + kThreads, ... of the P * N / 2^W items.  Where the items do not divide
// evenly (16-value rounds in the NTT kernels), the last threads take none.
template <bool kFwd, int LogN, int B0, int W, int P, int C, class R>
__device__ __forceinline__ void mid_round(uint32_t* buf, int g, int c, const Tables& t,
                                          uint32_t q) {
  constexpr int kPerRow = 1 << (LogN - W);
  constexpr int kTotal = P * kPerRow;
  constexpr int kItems = (kTotal + R::kThreads - 1) / R::kThreads;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int item = g + R::kThreads * m;
    if constexpr (kTotal % R::kThreads != 0) {
      if (item >= kTotal) break;
    }
    const int row = item / kPerRow;
    int hi;
    const int base = item_base<B0, W>(item % kPerRow, hi);
    uint32_t v[1 << W];
#pragma unroll
    for (int k = 0; k < (1 << W); ++k) v[k] = buf[R::at(row, base, k << B0, c)];
    ntt_round<kFwd, LogN, B0, W, R::kLazy, R::kVec>(v, hi, t, q);
#pragma unroll
    for (int k = 0; k < (1 << W); ++k) buf[R::at(row, base, k << B0, c)] = v[k];
  }
}

// The middle rounds (position bits 3 .. LogN-4: one round of LogN - 6
// bits, two where that is above 4, three 8-value rounds where it is 9, at
// N = 2^15: a 32-value round would not fit the 64 registers a thread of a
// 1024-thread block has), each ending in a barrier that every thread of
// the block reaches.
template <bool kFwd, int LogN, int P, int C, class R = StepRounds<LogN, C>>
__device__ __forceinline__ void mid_rounds(uint32_t* buf, int g, int c, bool valid,
                                           const Tables& t, uint32_t q) {
  constexpr int M = LogN - 6;
  static_assert(M >= 1 && M <= 9, "LogN out of range");
  if constexpr (M <= 4) {
    if (valid) mid_round<kFwd, LogN, 3, M, P, C, R>(buf, g, c, t, q);
    __syncthreads();
  } else if constexpr (M == 9) {
    // forward: bits 9-11, 6-8, 3-5; inverse: the other way round
    constexpr int B_first = kFwd ? 9 : 3, B_last = kFwd ? 3 : 9;
    if (valid) mid_round<kFwd, LogN, B_first, 3, P, C, R>(buf, g, c, t, q);
    __syncthreads();
    if (valid) mid_round<kFwd, LogN, 6, 3, P, C, R>(buf, g, c, t, q);
    __syncthreads();
    if (valid) mid_round<kFwd, LogN, B_last, 3, P, C, R>(buf, g, c, t, q);
    __syncthreads();
  } else {
    constexpr int W1 = (M + 1) / 2, W2 = M - W1;
    if constexpr (kFwd) {
      if (valid) mid_round<kFwd, LogN, 3 + W1, W2, P, C, R>(buf, g, c, t, q);
      __syncthreads();
      if (valid) mid_round<kFwd, LogN, 3, W1, P, C, R>(buf, g, c, t, q);
      __syncthreads();
    } else {
      if (valid) mid_round<kFwd, LogN, 3, W1, P, C, R>(buf, g, c, t, q);
      __syncthreads();
      if (valid) mid_round<kFwd, LogN, 3 + W1, W2, P, C, R>(buf, g, c, t, q);
      __syncthreads();
    }
  }
}

}  // namespace fhe
