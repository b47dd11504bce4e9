// CGGI (GINX) blind rotation: all n steps of the accumulator update in one
// kernel launch, in natural EVAL order.
//
// Replaces: fhe_tpu/tfhe/boot_mxu.py `_mega_kernel` + `_step_body`
// (blind_rotate_mega2), the TPU megakernel whose grid is (batch tiles, n)
// with the accumulator resident in VMEM across the n steps.
//
// What it computes: n steps of fhe::cggi_step<false> (cggi_step.cuh), with
// idx = ((q - a[b, i]) mod q) * (2N / q) mod 2N computed from the mask.
//
// What bounds it on the H100: integer multiply throughput (about 180k
// 32-bit multiplies per step per ciphertext: 2 + 4 polynomial NTTs, the
// N^-1 scale, the 16 external-product rows, the monomials) and the L2
// bandwidth of the 64 KiB-per-step BSK stream (the whole Montgomery-only
// key, 31.4 MiB at STD128, stays in the 50 MB L2; every block reads it
// once per gate).
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

#include "cggi_step.cuh"

namespace {

__global__ void blind_rotate_kernel(const uint32_t* __restrict__ acc_in,
                                    uint32_t* __restrict__ acc_out,
                                    const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ bsk,
                                    const uint32_t* __restrict__ pows,
                                    const uint32_t* __restrict__ fwd_w,
                                    const uint32_t* __restrict__ fwd_ws,
                                    const uint32_t* __restrict__ inv_w,
                                    const uint32_t* __restrict__ inv_ws, int n_steps,
                                    uint32_t q_lwe, uint32_t m_by, fhe::CggiParams p) {
  extern __shared__ uint32_t smem[];
  const int N = p.N;
  uint32_t* acc = smem;                 // [2, N] EVAL, plain form
  uint32_t* work = smem + 2 * N;        // [dG2, N]
  uint32_t* pw = work + p.dg2 * N;      // [2N] psi^e * R mod Q
  const size_t b = blockIdx.x;
  const uint32_t two_n_mask = 2 * N - 1;

  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
    acc[k] = acc_in[b * 2 * N + k];
    pw[k] = pows[k];
  }
  __syncthreads();

  const size_t step_words = static_cast<size_t>(2) * p.dg2 * 2 * N;
  for (int i = 0; i < n_steps; ++i) {
    const uint32_t av = a[b * n_steps + i];
    const uint32_t idx = ((av == 0u ? 0u : q_lwe - av) * m_by) & two_n_mask;
    fhe::cggi_step<false>(acc, work, pw, bsk + static_cast<size_t>(i) * step_words, idx,
                          (2 * N - idx) & two_n_mask, fwd_w, fwd_ws, inv_w, inv_ws, p);
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
  const fhe::CggiParams p{N, fhe::log2_int(N), dg2, dg, g_bits, offset,
                          Q, qinv_neg, ninv, ninv_s, r1};
  const size_t smem = fhe::cggi_smem_bytes(N, dg2);
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
        static_cast<const uint32_t*>(inv_ws), n_steps, q_lwe, m_by, p);
  }
  return static_cast<int>(cudaGetLastError());
}
