// Arguments and launchers of the blind-rotation kernels, declared for the
// dispatcher (blind_rotate.cu) without their definitions: those are in
// blind_rotate.cuh, instantiated once per shape by blind_rotate_inst.cu.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace fhe {
namespace cggi {

// Constants of the parameter set, the same for every step.
struct StepConsts {
  uint32_t Q, qinv_neg, ninv, ninv_s, r1;  // r1 = 2^32 mod Q
  int g_bits;                              // log2 of the gadget base Bg
  int32_t offset;                          // sum_t (Bg/2) Bg^t (signed digits)
};

// One rotation of B accumulators [B, 2, N] by the mask a [B, n_steps] with
// the key [n_steps, 2, dG2, 2, N] (bit-reversed EVAL order, Montgomery form).
struct ScanArgs {
  const uint32_t* acc_in;
  uint32_t* acc_out;
  const uint32_t* a;
  const uint32_t* bsk;
  const uint32_t* pows;    // [2N] psi^e * 2^32 mod Q
  const uint32_t* fwd_w;   // the NTT plan's tables, [N] each
  const uint32_t* fwd_ws;
  const uint32_t* inv_w;
  const uint32_t* inv_ws;
  int B, n_steps;
  uint32_t q_lwe, m_by;    // idx = ((q_lwe - a) mod q_lwe) * m_by mod 2N
  StepConsts k;
};

// Kernel kinds, for occupancy queries.
enum Kind { kScanNatural = 0, kScanBitReversed = 1, kStep = 2 };

// From N = 2^kWideLogN on, the kernels run the wide step (cggi_step_wide.cuh,
// one ciphertext a block, C = 1): cggi_step.cuh's buffers and registers do
// not fit a block there.
constexpr int kWideLogN = 12;
template <int LogN>
constexpr bool kWide = LogN >= kWideLogN;

// Dynamic shared memory of one block: the whole scan holds the four NTT
// tables and the [2N] monomial table besides the exchange buffers
// ([2, N] and [dG2, N] per ciphertext); the single step reads the tables
// from global memory.  The wide step holds the accumulator, one exchange
// buffer and the digits' source u ([2, N] each) and reads the tables from
// global memory.
inline size_t smem_bytes(int kind, int N, int dg2, int C) {
  if (N >= (1 << kWideLogN)) return static_cast<size_t>(6) * N * sizeof(uint32_t);
  const size_t bufs = static_cast<size_t>(2 + dg2) * N * C;
  const size_t tables = kind == kStep ? 0 : static_cast<size_t>(6) * N;
  return (bufs + tables) * sizeof(uint32_t);
}

// The whole scan in one launch (kernels 3 and 4).
template <int LogN, int Dg2, int C, bool kNatural>
int launch_scan(const ScanArgs& args, cudaStream_t stream);

// n_steps launches of the one-step kernel (kernel 5) on `stream`, the
// accumulator alternating between buf0 and buf1 (the last step writes
// buf[(n_steps - 1) % 2]); args.acc_out is unused.
template <int LogN, int Dg2, int C>
int launch_steps(const ScanArgs& args, uint32_t* buf0, uint32_t* buf1, cudaStream_t stream);

// Resident blocks per SM of one kernel kind (cudaOccupancy...).
template <int LogN, int Dg2, int C>
int occupancy(int kind, int* blocks);

}  // namespace cggi
}  // namespace fhe
