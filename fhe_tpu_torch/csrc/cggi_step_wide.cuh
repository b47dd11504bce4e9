// One CGGI (GINX) accumulator step at a ring too wide for cggi_step.cuh:
// N >= 4096 (kWideLogN), TOY_RADIX's (N, dG2) = (8192, 10).  The device code
// of the wide whole-scan kernel, in both orders, and the wide single-step
// kernel (blind_rotate.cuh).
//
// It computes what cggi_step.cuh computes (fhe_tpu/tfhe/boot.py
// blind_rotate), byte for byte, in the same bit-reversed EVAL order and
// on the same rounds (ntt_rounds.cuh).  What changes is where the step's
// data lives.  cggi_step.cuh holds [2 + dG2, N] words of exchange buffers
// and the [6N] tables in shared memory, and the dG2 digit polys in
// registers: at (8192, 10) that is 576 KiB of shared memory (a block may
// have 227 KB) and 80 registers of digits (a block of N/8 = 1024 threads
// may have 64 a thread).  Here, one ciphertext a block (C = 1), 192 KiB of
// shared memory:
// - The accumulator [2, N] stays in shared memory for the whole scan
//   (plain layout): thread g owns positions 8g..8g+7 of both polys and is
//   the only thread that reads or writes them.
// - One exchange buffer [2, N] serves the inverse NTT of the accumulator
//   and then, one gadget digit t at a time, the forward NTT of the pair of
//   digit polys (digit t of poly 0 and of poly 1).
// - The coefficient form, as the signed value plus the digit offset u, is
//   kept in a third [2, N] buffer at the positions g + j N/8 that the last
//   inverse round leaves thread g: each pair's digits are a shift and a
//   mask of it.  (Held in 16 registers instead it spilled, and ran 2 %
//   slower at batch 4096.)
// - Each pair's external product is folded into the accumulator at once,
//   with the monomials: for column c and sign s, x_s = REDC(D_2t K_s,2t,c +
//   D_2t+1 K_s,2t+1,c) < 2Q, then acc_c += REDC(x_0 (X^idx_pos - 1) + x_1
//   (X^idx_neg - 1)) < 2Q, reduced to [0, Q).  Every intermediate is exact
//   mod Q and the accumulator is canonical after every pair, so the bytes
//   are those of the plain version.
// - The NTT and monomial tables are read from global memory through L1,
//   as the single-step kernel reads them.
// - Registers: every phase derives its addresses from fresh(g0), as
//   cggi_step.cuh does where registers are capped; hoisted out of the
//   digit and step loops they spilled about 1 KB a thread, and the scan ran
//   1.9 times slower.  The external product takes four positions at a time
//   in a loop that is not unrolled, so that only one column's key words
//   are in flight.
// The key's L2 traffic is the cost of one ciphertext a block: a step's
// [2, dG2, 2, N] slice (1.25 MiB at (8192, 10)) is read once per
// ciphertext, and the whole key (80 MiB) is above the 50 MB L2.
#pragma once

#include <cstdint>

#include "cggi_step.cuh"

namespace fhe {
namespace cggi {

template <int LogN>
constexpr int kWideThreads = 1 << (LogN - 3);

// One step for the block's ciphertext, thread g0.  acc [2, N] and work
// [4, N] (the exchange buffer, then u) in shared memory; bsk_step the
// step's [2, dG2, 2, N] key in global memory.  Ends without a barrier: the
// next step's first writes to work are to the positions this thread read
// last.
template <int LogN, int Dg2>
__device__ __forceinline__ void step_wide(uint32_t* acc, uint32_t* work, const Tables& t,
                                          const uint32_t* __restrict__ bsk_step,
                                          uint32_t idx_pos, uint32_t idx_neg,
                                          const StepConsts& k, int g0) {
  constexpr int N = 1 << LogN, kG = N / 8, kDg = Dg2 / 2;
  static_assert(Dg2 % 2 == 0, "dG2 must be even");
  static_assert(LogN >= kWideLogN, "the wide step is for N >= 2^kWideLogN");
  const uint32_t Q = k.Q;

  // first inverse round (bits 0-2) on the accumulator's positions 8g..8g+7
  int g = fresh<true>(g0);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = acc[p * N + 8 * g + j];
    ntt_round<false, LogN, 0, 3>(v, g, t, Q);
#pragma unroll
    for (int j = 0; j < 8; ++j) work[word<LogN, 1>(p, 8 * g + j, 0)] = v[j];
  }
  __syncthreads();
  mid_rounds<false, LogN, 2, 1>(work, fresh<true>(g0), 0, true, t, Q);
  g = fresh<true>(g0);

  // last inverse round (bits L-3..L-1) on positions g + j N/8, N^-1, and
  // u, the signed value plus the digit offset
  int32_t* u = reinterpret_cast<int32_t*>(work + 2 * N);   // [2, N]
  const uint32_t q_half = Q >> 1;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = work[word<LogN, 1>(p, g + j * kG, 0)];
    ntt_round<false, LogN, LogN - 3, 3>(v, 0, t, Q);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t x = reduce(shoup_lazy(v[j], k.ninv, k.ninv_s, Q), Q);
      u[p * N + g + j * kG] =
          static_cast<int32_t>(x) - (x >= q_half ? static_cast<int32_t>(Q) : 0) + k.offset;
    }
  }

  const int32_t bg_mask = (1 << k.g_bits) - 1;
  const uint32_t lift = Q - (1u << (k.g_bits - 1));   // digit - Bg/2 + Q, in [0, 2Q)
  const uint32_t mask = 2 * N - 1;
#pragma unroll 1
  for (int d = 1; d <= kDg; ++d) {
    // digit d of both polys and its first forward round, on the positions
    // g + j N/8 this thread read last
    const int sh = k.g_bits * d;
    g = fresh<true>(g0);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = static_cast<uint32_t>((u[p * N + g + j * kG] >> sh) & bg_mask) + lift;
      }
      ntt_round<true, LogN, LogN - 3, 3>(v, 0, t, Q);
#pragma unroll
      for (int j = 0; j < 8; ++j) work[word<LogN, 1>(p, g + j * kG, 0)] = v[j];
    }
    __syncthreads();
    mid_rounds<true, LogN, 2, 1>(work, fresh<true>(g0), 0, true, t, Q);
    g = fresh<true>(g0);

    // last forward round (bits 2-0) on positions 8g..8g+7: the pair's
    // digits D_2t+p, reduced to [0, Q)
    uint32_t D[2][8];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) D[p][j] = work[word<LogN, 1>(p, 8 * g + j, 0)];
      ntt_round<true, LogN, 0, 3>(D[p], g, t, Q);
#pragma unroll
      for (int j = 0; j < 8; ++j) D[p][j] = reduce(reduce(D[p][j], 2 * Q), Q);
    }

    // the pair's external product, times the monomials, into the
    // accumulator; four positions at a time
    const int r0 = 2 * (d - 1);
    const uint32_t* kp = bsk_step + 8 * g;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        uint4 kv[2][2];   // [sign][row of the pair]
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            kv[s][r] = __ldg(reinterpret_cast<const uint4*>(
                kp + ((s * Dg2 + r0 + r) * 2 + col) * N + 4 * h));
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * h + jj;
          uint32_t x[2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const uint64_t sum = static_cast<uint64_t>(D[0][j]) * lane_word(kv[s][0], jj) +
                                 static_cast<uint64_t>(D[1][j]) * lane_word(kv[s][1], jj);
            x[s] = redc(sum, Q, k.qinv_neg);
          }
          const uint32_t odd = 2 * (__brev(static_cast<uint32_t>(8 * g + j)) >> (32 - LogN)) + 1;
          const uint32_t mp = reduce(t.pw[(odd * idx_pos) & mask] - k.r1 + Q, Q);
          const uint32_t mn = reduce(t.pw[(odd * idx_neg) & mask] - k.r1 + Q, Q);
          const uint64_t upd = static_cast<uint64_t>(x[0]) * mp + static_cast<uint64_t>(x[1]) * mn;
          uint32_t& a = acc[col * N + 8 * g + j];
          a = reduce(reduce(a + redc(upd, Q, k.qinv_neg), 2 * Q), Q);
        }
      }
    }
    // the next pair's first round writes positions other threads read above
    if (d < kDg) __syncthreads();
  }
}

}  // namespace cggi
}  // namespace fhe
