// CGGI (GINX) blind rotation: all n steps of the accumulator update in one
// kernel launch.
//
// Replaces: fhe_tpu/tfhe/boot_mxu.py `_mega_kernel` + `_step_body`
// (blind_rotate_mega2), the TPU megakernel whose grid is (batch tiles, n)
// with the accumulator resident in VMEM across the n steps.
//
// What it computes, per ciphertext b and step i (fhe_tpu/tfhe/boot.py
// blind_rotate; rgsw.signed_digit_decompose / external_product):
//   c      = INTT(acc)                               [2, N] COEFF
//   d_r    = balanced base-Bg digits 1..dG-1 of c, r = 2t + poly, in [0, Q)
//   D_r    = NTT(d_r)                                [dG2, N] EVAL
//   ep_s   = sum_r mont_mul(D_r, bsk[i, s, r, :, :])   s = 0 (+), 1 (-)
//   acc   += mont_mul(ep_0, X^idx - 1) + mont_mul(ep_1, X^-idx - 1)
// with idx = ((q - a[b, i]) mod q) * (2N / q) mod 2N.  X^idx in EVAL form
// is a table lookup: psi^((2k+1) idx) in Montgomery form at slot k, and
// X^-idx is the same table at slot ((2N - (2k+1) idx) mod 2N).
//
// What bounds it on the H100: integer multiply throughput (about 22k
// modular products per step per ciphertext: 2 + 4 polynomial NTTs, the
// 16 external-product rows, the monomials) and the L2 bandwidth of the
// 64 KiB-per-step BSK stream (the whole Montgomery-only key, 31.4 MiB at
// STD128, stays in the 50 MB L2; every block reads it once per gate).
//
// What this first version does about that: nothing yet.  One block per
// ciphertext keeps the accumulator [2, N], a [dG2, N] work area and the
// [2N] monomial table in shared memory for all n steps (the loop over
// steps inside the block replaces the TPU grid's sequential axis); the
// BSK step is read straight from global memory.  wgmma and TMA do not
// apply to 32-bit modular arithmetic; cross-block BSK reuse (several
// ciphertexts per block) and register-resident stages are for a later
// change.
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

struct RotateParams {
  int n_steps, N, logN, dg2, dg, g_bits, offset;
  uint32_t Q, qinv_neg, ninv, ninv_s, r1, q_lwe, m_by;
};

__global__ void blind_rotate_kernel(const uint32_t* __restrict__ acc_in,
                                    uint32_t* __restrict__ acc_out,
                                    const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ bsk,
                                    const uint32_t* __restrict__ pows,
                                    const uint32_t* __restrict__ fwd_w,
                                    const uint32_t* __restrict__ fwd_ws,
                                    const uint32_t* __restrict__ inv_w,
                                    const uint32_t* __restrict__ inv_ws, RotateParams p) {
  extern __shared__ uint32_t smem[];
  const int N = p.N;
  const uint32_t Q = p.Q;
  uint32_t* acc = smem;                 // [2, N] EVAL, plain form
  uint32_t* work = smem + 2 * N;        // [dG2, N]
  uint32_t* pw = work + p.dg2 * N;      // [2N] psi^e * R mod Q
  const size_t b = blockIdx.x;
  const int two_n_mask = 2 * N - 1;

  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
    acc[k] = acc_in[b * 2 * N + k];
    pw[k] = pows[k];
  }
  __syncthreads();

  const int32_t half_bg = 1 << (p.g_bits - 1);
  const int32_t bg_mask = (1 << p.g_bits) - 1;
  const int32_t q_half = static_cast<int32_t>(Q >> 1);
  const size_t step_words = static_cast<size_t>(2) * p.dg2 * 2 * N;

  for (int i = 0; i < p.n_steps; ++i) {
    // acc -> work[0..1] in bit-reversed order, then the inverse NTT
    for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
      const int poly = k >> p.logN;
      const int kk = k & (N - 1);
      work[poly * N + fhe::brev(kk, p.logN)] = acc[k];
    }
    __syncthreads();
    fhe::ntt_inv_stages(work, 2, N, p.logN, inv_w, inv_ws, Q);

    // N^-1 scale + signed digit decomposition, in place: each thread owns
    // its coefficient positions, reading both polys before writing rows
    for (int kk = threadIdx.x; kk < N; kk += blockDim.x) {
      const uint32_t c0 = fhe::shoup_mul(work[kk], p.ninv, p.ninv_s, Q);
      const uint32_t c1 = fhe::shoup_mul(work[N + kk], p.ninv, p.ninv_s, Q);
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
    fhe::ntt_fwd_stages(work, p.dg2, N, p.logN, fwd_w, fwd_ws, Q);

    // external products, monomials and the accumulate (work is in
    // bit-reversed EVAL order; acc and the BSK are natural order)
    const uint32_t av = a[b * p.n_steps + i];
    const uint32_t idx = ((av == 0u ? 0u : p.q_lwe - av) * p.m_by) & two_n_mask;
    const uint32_t* bi = bsk + static_cast<size_t>(i) * step_words;
    for (int kk = threadIdx.x; kk < N; kk += blockDim.x) {
      const int bk = fhe::brev(kk, p.logN);
      const uint32_t e = (static_cast<uint32_t>(2 * kk + 1) * idx) & two_n_mask;
      const uint32_t mono_p = fhe::sub_mod(pw[e], p.r1, Q);
      const uint32_t mono_n = fhe::sub_mod(pw[(2 * N - e) & two_n_mask], p.r1, Q);
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        uint32_t ep = 0, en = 0;
        for (int r = 0; r < p.dg2; ++r) {
          const uint32_t d = work[r * N + bk];
          const uint32_t kp = __ldg(bi + ((0 * p.dg2 + r) * 2 + col) * N + kk);
          const uint32_t kn = __ldg(bi + ((1 * p.dg2 + r) * 2 + col) * N + kk);
          ep = fhe::add_mod(ep, fhe::mont_mul(d, kp, Q, p.qinv_neg), Q);
          en = fhe::add_mod(en, fhe::mont_mul(d, kn, Q, p.qinv_neg), Q);
        }
        const uint32_t upd = fhe::add_mod(fhe::mont_mul(ep, mono_p, Q, p.qinv_neg),
                                          fhe::mont_mul(en, mono_n, Q, p.qinv_neg), Q);
        acc[col * N + kk] = fhe::add_mod(acc[col * N + kk], upd, Q);
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) acc_out[b * 2 * N + k] = acc[k];
}

}  // namespace

extern "C" int fhe_blind_rotate(const void* acc_in, void* acc_out, const void* a,
                                const void* bsk, const void* pows, const void* fwd_w,
                                const void* fwd_ws, const void* inv_w, const void* inv_ws,
                                int B, int n_steps, int N, int dg2, int dg, int g_bits,
                                int offset, uint32_t Q, uint32_t qinv_neg, uint32_t ninv,
                                uint32_t ninv_s, uint32_t r1, uint32_t q_lwe, uint32_t m_by,
                                void* stream) {
  RotateParams p{n_steps, N, fhe::log2_int(N), dg2, dg, g_bits, offset,
                 Q, qinv_neg, ninv, ninv_s, r1, q_lwe, m_by};
  const size_t smem = static_cast<size_t>(2 * N + dg2 * N + 2 * N) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0) {
    blind_rotate_kernel<<<B, fhe::ntt_threads(N), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc_in), static_cast<uint32_t*>(acc_out),
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(bsk),
        static_cast<const uint32_t*>(pows), static_cast<const uint32_t*>(fwd_w),
        static_cast<const uint32_t*>(fwd_ws), static_cast<const uint32_t*>(inv_w),
        static_cast<const uint32_t*>(inv_ws), p);
  }
  return static_cast<int>(cudaGetLastError());
}
