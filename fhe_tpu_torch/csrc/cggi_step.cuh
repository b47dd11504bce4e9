// One CGGI (GINX) accumulator step, the device code shared by the
// whole-scan kernel in both orders and the single-step kernel
// (blind_rotate.cuh).
//
// What it computes (fhe_tpu/tfhe/boot.py blind_rotate; rgsw.py
// signed_digit_decompose / external_product), per ciphertext:
//   c    = INTT(acc)                                [2, N] COEFF
//   d_r  = balanced base-Bg digits 1..dG-1 of c, r = 2t + poly, in [0, Q)
//   D_r  = NTT(d_r)                                 [dG2, N] EVAL
//   ep_s = sum_r D_r * bsk[s, r, :, :] * 2^-32      s = 0 (+), 1 (-)
//   acc += ep_0 (X^idx_pos - 1) + ep_1 (X^idx_neg - 1)
// with X^e at slot j = psi^((2j+1) e mod 2N), looked up in the [2N]
// Montgomery table `pw`.  The step works in bit-reversed EVAL order
// (position x holds slot brev(x)): the inverse stages take that order and
// the forward stages leave it, so no permutation runs inside the step.
//
// What bounds it on the H100 is integer issue: 32-bit add, shift, logic,
// compare and multiply all run at 64 per clock per SM on compute
// capability 9.0.  The design spends as few of those, and as few barriers
// and shared-memory passes, as it can:
// - Compile-time shapes.  LogN, dG2 and C are template parameters: every
//   stage, digit and external-product loop unrolls and every index is a
//   constant or one add from a per-thread base.
// - Register-resident rounds (ntt_rounds.cuh, shared with the NTT
//   kernels).  A ciphertext has G = N/8 threads.  Each NTT is three or four
//   rounds; a round runs up to 4 butterfly stages on 8 or 16 values in a
//   thread's registers, and rounds exchange through shared memory.  Rounds
//   cover position bits {0,1,2} | 3..L-4 | {L-3,L-2,L-1}
//   (the inverse low to high, the forward high to low), so a step has 4
//   barriers at N <= 1024 and 6 at N = 2048, against 23 before.
// - The accumulator in registers.  Thread g owns positions 8g..8g+7 of
//   both accumulator polys for the whole scan: the first inverse round and
//   the last forward round work on exactly those positions, so the
//   accumulate, the next step's first inverse round and the external
//   product between them never touch shared memory.
// - The digit split in registers.  The last inverse round and the first
//   forward round both pair positions at strides N/2, N/4, N/8: thread g
//   takes positions g + j N/8 through the last inverse round, the N^-1
//   scale, the signed digits and the first forward round of each digit
//   poly, and stores only the forward round's output.
// - Lazy reduction (Q < 2^30, so 4Q < 2^32).  Harvey butterflies keep the
//   forward NTT in [0, 4Q) and the inverse in [0, 2Q), with Shoup twiddles
//   that accept any 32-bit input; the external product sums dG2 64-bit
//   products and reduces each sum once (REDC), and so does the monomial
//   multiply-add.  The accumulator is canonical between steps, so every
//   result is byte-identical to the plain versions.
// - Twiddles.  A round's twiddles come from the tables once per round and
//   item (shared memory in the whole scan, loaded once per block; global
//   memory, through L1, in the single step).
// - Key reuse.  A block holds C ciphertexts in adjacent lanes (thread
//   C g + c): the C lanes of one position group load the same key words in
//   one instruction, so each key sector fetched from L2 serves C
//   ciphertexts and the key's L2 traffic per gate falls by C.
// - Bank conflicts.  The exchange buffers interleave the C ciphertexts word
//   by word and XOR-swizzle each N-word row (`word`), so that every
//   exchange is free of bank conflicts.
#pragma once

#include <cstdint>

#include "cggi_launch.h"
#include "ntt_rounds.cuh"

namespace fhe {
namespace cggi {

// t * 2^-32 mod q in [0, t / 2^32 + q) (Montgomery REDC of a 64-bit value).
__device__ __forceinline__ uint32_t redc(uint64_t t, uint32_t q, uint32_t qinv_neg) {
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t m = lo * qinv_neg;
  return static_cast<uint32_t>(t >> 32) + __umulhi(m, q) + (lo != 0u);
}

// Threads of a block, and at least two blocks per SM where a block has 256
// threads or fewer: registers are then capped at 128 a thread where
// threads x blocks >= 512.
template <int LogN, int C>
constexpr int kThreads = C << (LogN - 3);
template <int LogN, int C>
constexpr int kMinBlocks = kThreads<LogN, C> <= 256 ? 2 : 1;
template <int LogN, int C>
constexpr bool kCapped = kThreads<LogN, C> * kMinBlocks<LogN, C> >= 512;

// g, hidden from the compiler where registers are capped.  The
// shared-memory addresses of a thread's positions are the same in every
// step; hoisted out of the scan's step loop they would hold some 80
// registers and spill.  Each phase of the step derives them from fresh(g),
// so they are recomputed (one or two integer operations each) and live for
// one phase only.  Uncapped (C = 1 at N <= 1024), hoisting them pays.
template <bool kLaunder>
__device__ __forceinline__ int fresh(int g) {
  if constexpr (kLaunder) asm volatile("" : "+r"(g));
  return g;
}

__device__ __forceinline__ uint32_t lane_word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One step for the ciphertext of lane c, position group g0.  acc: its
// positions 8g..8g+7 of both polys, canonical, in and out.  buf_a [2, N]
// and buf_b [dG2, N] (C-interleaved) in shared memory; bsk_step the step's
// [2, dG2, 2, N] key in global memory.  Lanes with valid = false (the tail
// of the last block) compute and store nothing but reach every barrier.
template <int LogN, int Dg2, int C>
__device__ __forceinline__ void step(uint32_t (&acc)[2][8], uint32_t* buf_a, uint32_t* buf_b,
                                     const Tables& t, const uint32_t* __restrict__ bsk_step,
                                     uint32_t idx_pos, uint32_t idx_neg, const StepConsts& k,
                                     int g0, int c, bool valid) {
  constexpr int N = 1 << LogN, kG = N / 8, kDg = Dg2 / 2;
  static_assert(Dg2 % 2 == 0 && Dg2 <= 8, "dG2 must be even and at most 8");
  const uint32_t Q = k.Q;

  // first inverse round (bits 0-2) on the accumulator
  if (valid) {
    const int g = fresh<kCapped<LogN, C>>(g0);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = acc[p][j];
      ntt_round<false, LogN, 0, 3>(v, g, t, Q);
#pragma unroll
      for (int j = 0; j < 8; ++j) buf_a[word<LogN, C>(p, 8 * g + j, c)] = v[j];
    }
  }
  __syncthreads();
  mid_rounds<false, LogN, 2, C>(buf_a, fresh<kCapped<LogN, C>>(g0), c, valid, t, Q);

  // last inverse round (bits L-3..L-1), N^-1, signed digits, first forward
  // round of each digit poly, on positions g + j N/8
  if (valid) {
    const int g = fresh<kCapped<LogN, C>>(g0);
    int32_t u[2][8];
    const uint32_t q_half = Q >> 1;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = buf_a[word<LogN, C>(p, g + j * kG, c)];
      ntt_round<false, LogN, LogN - 3, 3>(v, 0, t, Q);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t x = reduce(shoup_lazy(v[j], k.ninv, k.ninv_s, Q), Q);
        u[p][j] = static_cast<int32_t>(x) - (x >= q_half ? static_cast<int32_t>(Q) : 0) +
                  k.offset;
      }
    }
    const int32_t bg_mask = (1 << k.g_bits) - 1;
    const uint32_t lift = Q - (1u << (k.g_bits - 1));   // digit - Bg/2 + Q, in [0, 2Q)
#pragma unroll
    for (int d = 1; d <= kDg; ++d) {
      const int sh = k.g_bits * d;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = static_cast<uint32_t>((u[p][j] >> sh) & bg_mask) + lift;
        ntt_round<true, LogN, LogN - 3, 3>(v, 0, t, Q);
#pragma unroll
        for (int j = 0; j < 8; ++j) buf_b[word<LogN, C>(2 * (d - 1) + p, g + j * kG, c)] = v[j];
      }
    }
  }
  __syncthreads();
  mid_rounds<true, LogN, Dg2, C>(buf_b, fresh<kCapped<LogN, C>>(g0), c, valid, t, Q);
  if (!valid) return;
  const int g = fresh<kCapped<LogN, C>>(g0);

  // last forward round (bits 2-0): the digits at positions 8g..8g+7, in
  // [0, 2Q) (dG2 <= 4) or [0, Q), so that dG2 products sum below 8 Q^2
  uint32_t D[Dg2][8];
#pragma unroll
  for (int r = 0; r < Dg2; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) D[r][j] = buf_b[word<LogN, C>(r, 8 * g + j, c)];
    ntt_round<true, LogN, 0, 3>(D[r], g, t, Q);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      D[r][j] = reduce(D[r][j], 2 * Q);
      if constexpr (Dg2 > 4) D[r][j] = reduce(D[r][j], Q);
    }
  }

  // external product, monomials, accumulate; four positions at a time.
  // e < 3Q; e0 mp + e1 mn < 6Q^2, its REDC < 2.5Q; acc + that < 3.5Q.
  const uint32_t mask = 2 * N - 1;
  const uint32_t* kp = bsk_step + 8 * g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t e[2][2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint4 kv[Dg2][2];
#pragma unroll
      for (int r = 0; r < Dg2; ++r) {
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          kv[r][col] = __ldg(reinterpret_cast<const uint4*>(
              kp + ((s * Dg2 + r) * 2 + col) * N + 4 * h));
        }
      }
#pragma unroll
      for (int col = 0; col < 2; ++col) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint64_t sum = 0;
#pragma unroll
          for (int r = 0; r < Dg2; ++r) {
            sum += static_cast<uint64_t>(D[r][4 * h + jj]) * lane_word(kv[r][col], jj);
          }
          e[s][col][jj] = redc(sum, Q, k.qinv_neg);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * h + jj;
      const uint32_t odd = 2 * (__brev(static_cast<uint32_t>(8 * g + j)) >> (32 - LogN)) + 1;
      const uint32_t mp = reduce(t.pw[(odd * idx_pos) & mask] - k.r1 + Q, Q);
      const uint32_t mn = reduce(t.pw[(odd * idx_neg) & mask] - k.r1 + Q, Q);
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const uint64_t upd = static_cast<uint64_t>(e[0][col][jj]) * mp +
                             static_cast<uint64_t>(e[1][col][jj]) * mn;
        const uint32_t a = acc[col][j] + redc(upd, Q, k.qinv_neg);
        acc[col][j] = reduce(reduce(a, 2 * Q), Q);
      }
    }
  }
}

}  // namespace cggi
}  // namespace fhe
