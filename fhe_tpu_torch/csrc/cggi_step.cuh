// One CGGI (GINX) accumulator step for one ciphertext, run by a whole
// block: the device function shared by the three blind-rotation kernels
// (blind_rotate.cu: the natural-order whole scan; blind_rotate_br.cu: the
// bit-reversed whole scan and the bit-reversed single step).
//
// What it computes (fhe_tpu/tfhe/boot.py blind_rotate; rgsw.py
// signed_digit_decompose / external_product):
//   c      = INTT(acc)                               [2, N] COEFF
//   d_r    = balanced base-Bg digits 1..dG-1 of c, r = 2t + poly, in [0, Q)
//   D_r    = NTT(d_r)                                [dG2, N] EVAL
//   ep_s   = sum_r mont_mul(D_r, bsk[s, r, :, :])    s = 0 (+), 1 (-)
//   acc   += mont_mul(ep_0, X^idx_pos - 1) + mont_mul(ep_1, X^idx_neg - 1)
// with idx_neg = 2N - idx_pos mod 2N.  X^e in EVAL form at the natural slot
// j is psi^((2j+1) e mod 2N), looked up in the [2N] Montgomery table `pw`.
//
// Orders.  kBitReversed = false: acc and the key are in natural EVAL order
// (fhe_tpu boot_mxu); position k holds slot k.  kBitReversed = true: both
// are in bit-reversed EVAL order (fhe_tpu boot_pallas); position k holds
// slot brev(k).  The inverse stages take bit-reversed input and the forward
// stages leave bit-reversed output (ntt.cuh), so in bit-reversed order the
// accumulator goes into the inverse NTT as it is and the digits come out in
// the key's order; in natural order both sides go through brev.
#pragma once

#include "ntt.cuh"

namespace fhe {

struct CggiParams {
  int N, logN, dg2, dg, g_bits, offset;
  uint32_t Q, qinv_neg, ninv, ninv_s, r1;
};

// acc [2, N], work [dG2, N] and pw [2N] in shared memory; bsk_step the
// step's [2, dG2, 2, N] Montgomery key in global memory.  Starts and ends
// synchronised.
template <bool kBitReversed>
__device__ __forceinline__ void cggi_step(uint32_t* acc, uint32_t* work,
                                          const uint32_t* pw,
                                          const uint32_t* __restrict__ bsk_step,
                                          uint32_t idx_pos, uint32_t idx_neg,
                                          const uint32_t* __restrict__ fwd_w,
                                          const uint32_t* __restrict__ fwd_ws,
                                          const uint32_t* __restrict__ inv_w,
                                          const uint32_t* __restrict__ inv_ws,
                                          const CggiParams& p) {
  const int N = p.N;
  const uint32_t Q = p.Q;
  const uint32_t two_n_mask = 2 * N - 1;

  // acc -> work[0..1] in bit-reversed order, then the inverse NTT
  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
    const int poly = k >> p.logN;
    const int kk = k & (N - 1);
    work[poly * N + (kBitReversed ? kk : brev(kk, p.logN))] = acc[k];
  }
  __syncthreads();
  ntt_inv_stages(work, 2, N, p.logN, inv_w, inv_ws, Q);

  // N^-1 scale + signed digit decomposition, in place: each thread owns
  // its coefficient positions, reading both polys before writing rows
  const int32_t half_bg = 1 << (p.g_bits - 1);
  const int32_t bg_mask = (1 << p.g_bits) - 1;
  const int32_t q_half = static_cast<int32_t>(Q >> 1);
  for (int kk = threadIdx.x; kk < N; kk += blockDim.x) {
    const uint32_t c0 = shoup_mul(work[kk], p.ninv, p.ninv_s, Q);
    const uint32_t c1 = shoup_mul(work[N + kk], p.ninv, p.ninv_s, Q);
#pragma unroll
    for (int poly = 0; poly < 2; ++poly) {
      int32_t d = static_cast<int32_t>(poly == 0 ? c0 : c1);
      if (d >= q_half) d -= static_cast<int32_t>(Q);
      const int32_t u = d + p.offset;
      for (int t = 1; t <= p.dg; ++t) {
        const int32_t dig = ((u >> (p.g_bits * t)) & bg_mask) - half_bg;
        work[(2 * (t - 1) + poly) * N + kk] =
            dig < 0 ? static_cast<uint32_t>(dig + static_cast<int32_t>(Q))
                    : static_cast<uint32_t>(dig);
      }
    }
  }
  __syncthreads();
  ntt_fwd_stages(work, p.dg2, N, p.logN, fwd_w, fwd_ws, Q);

  // external products, monomials and the accumulate; work is in
  // bit-reversed EVAL order
  for (int kk = threadIdx.x; kk < N; kk += blockDim.x) {
    const int slot = kBitReversed ? brev(kk, p.logN) : kk;   // natural slot of position kk
    const int wk = kBitReversed ? kk : brev(kk, p.logN);     // its digits in work
    const uint32_t odd = static_cast<uint32_t>(2 * slot + 1);
    const uint32_t mono_p = sub_mod(pw[(odd * idx_pos) & two_n_mask], p.r1, Q);
    const uint32_t mono_n = sub_mod(pw[(odd * idx_neg) & two_n_mask], p.r1, Q);
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      uint32_t ep = 0, en = 0;
      for (int r = 0; r < p.dg2; ++r) {
        const uint32_t d = work[r * N + wk];
        const uint32_t kp = __ldg(bsk_step + ((0 * p.dg2 + r) * 2 + col) * N + kk);
        const uint32_t kn = __ldg(bsk_step + ((1 * p.dg2 + r) * 2 + col) * N + kk);
        ep = add_mod(ep, mont_mul(d, kp, Q, p.qinv_neg), Q);
        en = add_mod(en, mont_mul(d, kn, Q, p.qinv_neg), Q);
      }
      const uint32_t upd = add_mod(mont_mul(ep, mono_p, Q, p.qinv_neg),
                                   mont_mul(en, mono_n, Q, p.qinv_neg), Q);
      acc[col * N + kk] = add_mod(acc[col * N + kk], upd, Q);
    }
  }
  __syncthreads();
}

// Dynamic shared memory of a blind-rotation block: acc [2N], work [dG2 N],
// pw [2N].
inline size_t cggi_smem_bytes(int N, int dg2) {
  return static_cast<size_t>(2 * N + dg2 * N + 2 * N) * sizeof(uint32_t);
}

}  // namespace fhe
