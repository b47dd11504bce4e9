// C entry points of the blind-rotation kernels (blind_rotate.cuh): each
// dispatches on (N, dG2) over the shapes of cggi_shapes.h and on C, the
// ciphertexts per block (1 or 2), to the instantiation compiled from
// blind_rotate_inst.cu.  A shape or C with no instantiation returns
// cudaErrorInvalidValue without launching; the Python wrappers
// (kernels/blind_rotate.py) raise before they get here.
#include <cuda_runtime.h>

#include "cggi_launch.h"
#include "cggi_shapes.h"
#include "ntt_launch.h"

namespace {

using fhe::log2_int;
using fhe::cggi::ScanArgs;

ScanArgs make_args(const void* acc_in, void* acc_out, const void* a, const void* bsk,
                   const void* pows, const void* fwd_w, const void* fwd_ws, const void* inv_w,
                   const void* inv_ws, int B, int n_steps, int g_bits, int offset, uint32_t Q,
                   uint32_t qinv_neg, uint32_t ninv, uint32_t ninv_s, uint32_t r1,
                   uint32_t q_lwe, uint32_t m_by) {
  return ScanArgs{static_cast<const uint32_t*>(acc_in), static_cast<uint32_t*>(acc_out),
                  static_cast<const uint32_t*>(a),      static_cast<const uint32_t*>(bsk),
                  static_cast<const uint32_t*>(pows),   static_cast<const uint32_t*>(fwd_w),
                  static_cast<const uint32_t*>(fwd_ws), static_cast<const uint32_t*>(inv_w),
                  static_cast<const uint32_t*>(inv_ws), B, n_steps, q_lwe, m_by,
                  fhe::cggi::StepConsts{Q, qinv_neg, ninv, ninv_s, r1, g_bits, offset}};
}

}  // namespace

extern "C" {

// The whole scan (kernel 3 with natural != 0, kernel 4 otherwise).
int fhe_cggi_scan(const void* acc_in, void* acc_out, const void* a, const void* bsk,
                  const void* pows, const void* fwd_w, const void* fwd_ws, const void* inv_w,
                  const void* inv_ws, int B, int n_steps, int N, int dg2, int C, int natural,
                  int g_bits, int offset, uint32_t Q, uint32_t qinv_neg, uint32_t ninv,
                  uint32_t ninv_s, uint32_t r1, uint32_t q_lwe, uint32_t m_by, void* stream) {
  const ScanArgs args = make_args(acc_in, acc_out, a, bsk, pows, fwd_w, fwd_ws, inv_w, inv_ws,
                                  B, n_steps, g_bits, offset, Q, qinv_neg, ninv, ninv_s, r1,
                                  q_lwe, m_by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int logN = log2_int(N);
#define FHE_SCAN_CASE(L, D)                                                           \
  if (logN == L && dg2 == D) {                                                        \
    if (C == 1) {                                                                     \
      return natural ? fhe::cggi::launch_scan<L, D, 1, true>(args, s)                 \
                     : fhe::cggi::launch_scan<L, D, 1, false>(args, s);               \
    }                                                                                 \
    if (C == 2) {                                                                     \
      return natural ? fhe::cggi::launch_scan<L, D, 2, true>(args, s)                 \
                     : fhe::cggi::launch_scan<L, D, 2, false>(args, s);               \
    }                                                                                 \
  }
  FHE_CGGI_SHAPES(FHE_SCAN_CASE)
#undef FHE_SCAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// n_steps launches of the one-step kernel (kernel 5) on the caller's
// stream, step i reading acc_in (i = 0) or buf[(i - 1) % 2] and writing
// buf[i % 2].
int fhe_cggi_steps(const void* acc_in, void* buf0, void* buf1, const void* a, const void* bsk,
                   const void* pows, const void* fwd_w, const void* fwd_ws, const void* inv_w,
                   const void* inv_ws, int B, int n_steps, int N, int dg2, int C, int g_bits,
                   int offset, uint32_t Q, uint32_t qinv_neg, uint32_t ninv, uint32_t ninv_s,
                   uint32_t r1, uint32_t q_lwe, uint32_t m_by, void* stream) {
  const ScanArgs args = make_args(acc_in, nullptr, a, bsk, pows, fwd_w, fwd_ws, inv_w, inv_ws,
                                  B, n_steps, g_bits, offset, Q, qinv_neg, ninv, ninv_s, r1,
                                  q_lwe, m_by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b0 = static_cast<uint32_t*>(buf0);
  uint32_t* b1 = static_cast<uint32_t*>(buf1);
  const int logN = log2_int(N);
#define FHE_STEPS_CASE(L, D)                                                     \
  if (logN == L && dg2 == D) {                                                   \
    if (C == 1) return fhe::cggi::launch_steps<L, D, 1>(args, b0, b1, s);        \
    if (C == 2) return fhe::cggi::launch_steps<L, D, 2>(args, b0, b1, s);        \
  }
  FHE_CGGI_SHAPES(FHE_STEPS_CASE)
#undef FHE_STEPS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of kind 0 (scan, natural), 1 (scan, bit-reversed)
// or 2 (one step) at (N, dG2, C), into *blocks.
int fhe_cggi_occupancy(int N, int dg2, int C, int kind, int* blocks) {
  const int logN = log2_int(N);
#define FHE_OCC_CASE(L, D)                                                       \
  if (logN == L && dg2 == D) {                                                   \
    if (C == 1) return fhe::cggi::occupancy<L, D, 1>(kind, blocks);              \
    if (C == 2) return fhe::cggi::occupancy<L, D, 2>(kind, blocks);              \
  }
  FHE_CGGI_SHAPES(FHE_OCC_CASE)
#undef FHE_OCC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
