// CGGI (GINX) blind rotation in bit-reversed EVAL order: the whole n-step
// scan in one launch (kernel 4) and one step per launch (kernel 5).
//
// Replaces: fhe_tpu/tfhe/boot_pallas.py
//   `_mega_kernel` (blind_rotate_mega, impl "mega"): grid (batch tiles, n),
//     the accumulator resident in VMEM across the n steps, the per-step key
//     block streamed -> blind_rotate_mega_kernel;
//   `_step_kernel` (blind_rotate_fused, impl "fused"): one pallas_call per
//     step under a lax.scan, the accumulator through HBM between steps ->
//     rotate_step_br_kernel.
// Both keep the accumulator and the key in bit-reversed EVAL order, so no
// permutation runs in the step (fhe::cggi_step<true>, cggi_step.cuh).
//
// What bounds them on the H100: integer multiply throughput, as kernel 3
// (about 180k 32-bit multiplies per step per ciphertext); the single step
// also moves the [B, 2, N] accumulator through device memory and pays one
// launch per step, which at batch 1 is host time, not device time.
//
// What this first version does about that: nothing yet.  One block per
// ciphertext, the accumulator, a [dG2, N] work area and the [2N] monomial
// table in shared memory (for all n steps in kernel 4, for the one step in
// kernel 5), the key read from global memory (L2).  Several ciphertexts
// per block and a CUDA graph around kernel 5's n launches are for a later
// change.
#include <cuda_runtime.h>

#include "cggi_step.cuh"

namespace {

struct BrTables {
  const uint32_t* pows;    // [2N] psi^e * R mod Q
  const uint32_t* fwd_w;
  const uint32_t* fwd_ws;
  const uint32_t* inv_w;
  const uint32_t* inv_ws;
};

__device__ __forceinline__ uint32_t* load_block(const uint32_t* __restrict__ acc_in,
                                                const BrTables& t, const fhe::CggiParams& p) {
  extern __shared__ uint32_t smem[];
  const int N = p.N;
  const size_t b = blockIdx.x;
  uint32_t* pw = smem + 2 * N + p.dg2 * N;
  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
    smem[k] = acc_in[b * 2 * N + k];
    pw[k] = t.pows[k];
  }
  __syncthreads();
  return smem;
}

__device__ __forceinline__ void store_block(const uint32_t* acc, uint32_t* __restrict__ acc_out,
                                            int N) {
  const size_t b = blockIdx.x;
  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) acc_out[b * 2 * N + k] = acc[k];
}

// idx_pos/idx_neg: [B, n_steps]; bsk: [n_steps, 2, dG2, 2, N].
__global__ void blind_rotate_mega_kernel(const uint32_t* __restrict__ acc_in,
                                         uint32_t* __restrict__ acc_out,
                                         const uint32_t* __restrict__ idx_pos,
                                         const uint32_t* __restrict__ idx_neg,
                                         const uint32_t* __restrict__ bsk, int n_steps,
                                         BrTables t, fhe::CggiParams p) {
  uint32_t* acc = load_block(acc_in, t, p);
  uint32_t* work = acc + 2 * p.N;
  const uint32_t* pw = work + p.dg2 * p.N;
  const size_t b = blockIdx.x;
  const size_t step_words = static_cast<size_t>(2) * p.dg2 * 2 * p.N;
  for (int i = 0; i < n_steps; ++i) {
    fhe::cggi_step<true>(acc, work, pw, bsk + static_cast<size_t>(i) * step_words,
                         idx_pos[b * n_steps + i], idx_neg[b * n_steps + i], t.fwd_w,
                         t.fwd_ws, t.inv_w, t.inv_ws, p);
  }
  store_block(acc, acc_out, p.N);
}

// One step: idx_pos/idx_neg [B, stride], column `step`; bsk_step
// [2, dG2, 2, N].
__global__ void rotate_step_br_kernel(const uint32_t* __restrict__ acc_in,
                                      uint32_t* __restrict__ acc_out,
                                      const uint32_t* __restrict__ idx_pos,
                                      const uint32_t* __restrict__ idx_neg,
                                      const uint32_t* __restrict__ bsk_step, int stride,
                                      int step, BrTables t, fhe::CggiParams p) {
  uint32_t* acc = load_block(acc_in, t, p);
  uint32_t* work = acc + 2 * p.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * stride + step;
  fhe::cggi_step<true>(acc, work, work + p.dg2 * p.N, bsk_step, idx_pos[i], idx_neg[i],
                       t.fwd_w, t.fwd_ws, t.inv_w, t.inv_ws, p);
  store_block(acc, acc_out, p.N);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" {

int fhe_blind_rotate_mega(const void* acc_in, void* acc_out, const void* idx_pos,
                          const void* idx_neg, const void* bsk, const void* pows,
                          const void* fwd_w, const void* fwd_ws, const void* inv_w,
                          const void* inv_ws, int B, int n_steps, int N, int dg2, int dg,
                          int g_bits, int offset, uint32_t Q, uint32_t qinv_neg, uint32_t ninv,
                          uint32_t ninv_s, uint32_t r1, void* stream) {
  const fhe::CggiParams p{N, fhe::log2_int(N), dg2, dg, g_bits, offset,
                          Q, qinv_neg, ninv, ninv_s, r1};
  const BrTables t{static_cast<const uint32_t*>(pows), static_cast<const uint32_t*>(fwd_w),
                   static_cast<const uint32_t*>(fwd_ws), static_cast<const uint32_t*>(inv_w),
                   static_cast<const uint32_t*>(inv_ws)};
  const size_t smem = fhe::cggi_smem_bytes(N, dg2);
  const int rc = allow_smem(blind_rotate_mega_kernel, smem);
  if (rc != 0) return rc;
  if (B > 0) {
    blind_rotate_mega_kernel<<<B, fhe::ntt_threads(N), smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc_in), static_cast<uint32_t*>(acc_out),
        static_cast<const uint32_t*>(idx_pos), static_cast<const uint32_t*>(idx_neg),
        static_cast<const uint32_t*>(bsk), n_steps, t, p);
  }
  return static_cast<int>(cudaGetLastError());
}

int fhe_rotate_step_br(const void* acc_in, void* acc_out, const void* idx_pos,
                       const void* idx_neg, const void* bsk_step, const void* pows,
                       const void* fwd_w, const void* fwd_ws, const void* inv_w,
                       const void* inv_ws, int B, int stride, int step, int N, int dg2, int dg,
                       int g_bits, int offset, uint32_t Q, uint32_t qinv_neg, uint32_t ninv,
                       uint32_t ninv_s, uint32_t r1, void* stream) {
  const fhe::CggiParams p{N, fhe::log2_int(N), dg2, dg, g_bits, offset,
                          Q, qinv_neg, ninv, ninv_s, r1};
  const BrTables t{static_cast<const uint32_t*>(pows), static_cast<const uint32_t*>(fwd_w),
                   static_cast<const uint32_t*>(fwd_ws), static_cast<const uint32_t*>(inv_w),
                   static_cast<const uint32_t*>(inv_ws)};
  const size_t smem = fhe::cggi_smem_bytes(N, dg2);
  const int rc = allow_smem(rotate_step_br_kernel, smem);
  if (rc != 0) return rc;
  if (B > 0) {
    rotate_step_br_kernel<<<B, fhe::ntt_threads(N), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc_in), static_cast<uint32_t*>(acc_out),
        static_cast<const uint32_t*>(idx_pos), static_cast<const uint32_t*>(idx_neg),
        static_cast<const uint32_t*>(bsk_step), stride, step, t, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
