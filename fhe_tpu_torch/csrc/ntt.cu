// Batched negacyclic NTT / inverse NTT, natural order in and out (the
// forward NTT can also leave its native bit-reversed order: `out_br`).
//
// Replaces: fhe_tpu/math/ntt_pallas.py `_fwd_kernel` (forward_pallas) and
// `_inv_kernel` (inverse_pallas), the TPU kernels that keep a [tile, N]
// block in VMEM for all log N stages.
//
// What bounds it on the H100: the stages are 32-bit modular multiplies
// (two __umulhi-class IMADs and a conditional subtract per butterfly), so
// integer multiply throughput and the __syncthreads() between stages, not
// memory: each row is read and written once.
//
// What this first version does about that: nothing yet.  One block per
// row holds the [N] row in shared memory for all stages (the role VMEM
// played), with the bit-reversal folded into the store (forward) or the
// load (inverse) and N^-1 (Shoup) folded into the inverse's store; with
// `out_br` the forward stores the stages' bit-reversed order as it is
// (ntt_pallas.forward_pallas(out_br=True), the input of kernels 4 and 5).
// wgmma and TMA do not apply to 32-bit modular arithmetic; register-
// resident stages and several rows per block are for a later change.
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

__global__ void ntt_forward_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                   const uint32_t* __restrict__ w,
                                   const uint32_t* __restrict__ ws, int N, int logN,
                                   uint32_t q, int out_br) {
  extern __shared__ uint32_t s[];
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int k = threadIdx.x; k < N; k += blockDim.x) s[k] = x[base + k];
  __syncthreads();
  fhe::ntt_fwd_stages(s, 1, N, logN, w, ws, q);
  for (int k = threadIdx.x; k < N; k += blockDim.x)
    y[base + k] = s[out_br ? k : fhe::brev(k, logN)];
}

__global__ void ntt_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                   const uint32_t* __restrict__ w,
                                   const uint32_t* __restrict__ ws, int N, int logN,
                                   uint32_t q, uint32_t ninv, uint32_t ninv_s) {
  extern __shared__ uint32_t s[];
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int k = threadIdx.x; k < N; k += blockDim.x) s[fhe::brev(k, logN)] = x[base + k];
  __syncthreads();
  fhe::ntt_inv_stages(s, 1, N, logN, w, ws, q);
  for (int k = threadIdx.x; k < N; k += blockDim.x)
    y[base + k] = fhe::shoup_mul(s[k], ninv, ninv_s, q);
}

}  // namespace

extern "C" {

int fhe_ntt_forward(const void* x, void* y, const void* w, const void* ws, int rows, int N,
                    uint32_t q, int out_br, void* stream) {
  if (rows > 0) {
    ntt_forward_kernel<<<rows, fhe::ntt_threads(N), N * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
        static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(ws), N,
        fhe::log2_int(N), q, out_br);
  }
  return static_cast<int>(cudaGetLastError());
}

int fhe_ntt_inverse(const void* x, void* y, const void* w, const void* ws, int rows, int N,
                    uint32_t q, uint32_t ninv, uint32_t ninv_s, void* stream) {
  if (rows > 0) {
    ntt_inverse_kernel<<<rows, fhe::ntt_threads(N), N * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
        static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(ws), N,
        fhe::log2_int(N), q, ninv, ninv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fhe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
