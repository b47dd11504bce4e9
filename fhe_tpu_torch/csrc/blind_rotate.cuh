// CGGI (GINX) blind rotation: the whole-scan kernel, templated on the
// order, and the one-step kernel, both on the step of cggi_step.cuh.
//
// Replaces:
//   fhe_tpu/tfhe/boot_mxu.py `_mega_kernel` + `_step_body` (ntt_impl None):
//     scan_kernel<..., kNatural = true>  (kernel 3);
//   fhe_tpu/tfhe/boot_pallas.py `_mega_kernel` ("mega"):
//     scan_kernel<..., kNatural = false> (kernel 4);
//   fhe_tpu/tfhe/boot_pallas.py `_step_kernel` ("fused"): step_kernel, one
//     launch per step, n launches per rotation from launch_steps (kernel 5).
// The TPU kernels keep the accumulator in VMEM across a sequential grid
// axis of n steps; here one block runs the n steps in a loop with the
// accumulator in registers (the scan) or in device memory between launches
// (the single step).
//
// Orders.  Inside the step everything is in bit-reversed EVAL order.  The
// natural-order instantiation permutes only where it loads and stores the
// accumulator, once per rotation; both orders read the bit-reversed key
// (made once per key and cached by the caller, rgsw.BootstrapKey.bsk_br).
//
// What bounds the rotation on the H100: integer issue (about 154k 32-bit
// multiplies per step per ciphertext at STD128, counted as in chip_smoke.py
// step_multiplies, and the adds, shifts and compares around them at the
// same rate), then the key's L2 traffic (64 KiB per
// step at STD128, over C ciphertexts).  What the design does about it is
// in cggi_step.cuh; here: a block is C ciphertexts x N/8 threads; the
// scan copies the NTT and monomial tables into shared memory once per
// block; both kernels index the mask word of each step themselves
// (idx = ((q - a) mod q) * 2N/q mod 2N).  The single step pays, per
// launch, the accumulator's trip through device memory and the launch
// itself; its n launches are issued by one C loop (launch_steps), not from
// Python, with programmatic dependent launch: a step's blocks are launched
// behind the previous step and wait before their first global read.  No
// CUDA graph.
//
// From N = 2^kWideLogN on (TOY_RADIX's (8192, 10)) the same three kernels
// are wide_scan_kernel in both orders and wide_step_kernel, on the step of
// cggi_step_wide.cuh: one ciphertext a block of N/8 threads, the
// accumulator in shared memory (192 KiB a block in all), the tables read
// from global memory.  The
// launchers pick them at compile time (scan_of, step_of), so the kernels
// of the narrower shapes are compiled as before.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "cggi_launch.h"
#include "cggi_step.cuh"
#include "cggi_step_wide.cuh"

namespace fhe {
namespace cggi {


__device__ __forceinline__ void load8(const uint32_t* p, uint32_t (&v)[8]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4*>(p + 4) = make_uint4(v[4], v[5], v[6], v[7]);
}

// X^idx_pos and X^idx_neg of mask word av (boot.py _rotation_indices).
template <int LogN>
__device__ __forceinline__ void indices(const ScanArgs& args, uint32_t av, uint32_t& idx_pos,
                                        uint32_t& idx_neg) {
  constexpr uint32_t kMask = (2u << LogN) - 1;
  idx_pos = ((av == 0u ? 0u : args.q_lwe - av) * args.m_by) & kMask;
  idx_neg = (kMask + 1 - idx_pos) & kMask;
}

template <int LogN, int Dg2, int C, bool kNatural>
__global__ void __launch_bounds__(kThreads<LogN, C>, kMinBlocks<LogN, C>)
scan_kernel(const ScanArgs args) {
  constexpr int N = 1 << LogN;
  constexpr size_t kStepWords = static_cast<size_t>(4) * Dg2 * N;
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;                   // fwd_w | fwd_ws | inv_w | inv_ws | pw [2N]
  uint32_t* buf_a = smem + 6 * N;         // [2, N] x C
  uint32_t* buf_b = buf_a + 2 * N * C;    // [dG2, N] x C
  for (int i = threadIdx.x; i < N; i += kThreads<LogN, C>) {
    tab[i] = args.fwd_w[i];
    tab[N + i] = args.fwd_ws[i];
    tab[2 * N + i] = args.inv_w[i];
    tab[3 * N + i] = args.inv_ws[i];
    tab[4 * N + i] = args.pows[i];
    tab[5 * N + i] = args.pows[N + i];
  }
  const int c = threadIdx.x % C, g = threadIdx.x / C;
  const size_t b = static_cast<size_t>(blockIdx.x) * C + c;
  const bool valid = b < static_cast<size_t>(args.B);
  uint32_t acc[2][8];
  if (valid) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t* src = args.acc_in + (b * 2 + p) * N;
      if (kNatural) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = src[__brev(8 * g + j) >> (32 - LogN)];
      } else {
        load8(src + 8 * g, acc[p]);
      }
    }
  }
  __syncthreads();
  const Tables t{tab, tab + N, tab + 2 * N, tab + 3 * N, tab + 4 * N};
  const uint32_t* a = args.a + b * args.n_steps;
  for (int i = 0; i < args.n_steps; ++i) {
    uint32_t idx_pos = 0, idx_neg = 0;
    if (valid) indices<LogN>(args, a[i], idx_pos, idx_neg);
    step<LogN, Dg2, C>(acc, buf_a, buf_b, t, args.bsk + i * kStepWords, idx_pos, idx_neg,
                       args.k, g, c, valid);
  }
  if (valid) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t* dst = args.acc_out + (b * 2 + p) * N;
      if (kNatural) {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[__brev(8 * g + j) >> (32 - LogN)] = acc[p][j];
      } else {
        store8(dst + 8 * g, acc[p]);
      }
    }
  }
}

// Step i of the rotation: acc_in -> acc_out, bit-reversed order.
template <int LogN, int Dg2, int C>
__global__ void __launch_bounds__(kThreads<LogN, C>, kMinBlocks<LogN, C>)
step_kernel(const ScanArgs args, const uint32_t* __restrict__ acc_in,
            uint32_t* __restrict__ acc_out, int i) {
  constexpr int N = 1 << LogN;
  constexpr size_t kStepWords = static_cast<size_t>(4) * Dg2 * N;
  extern __shared__ uint32_t smem[];
  uint32_t* buf_a = smem;
  uint32_t* buf_b = smem + 2 * N * C;
  const int c = threadIdx.x % C, g = threadIdx.x / C;
  const size_t b = static_cast<size_t>(blockIdx.x) * C + c;
  const bool valid = b < static_cast<size_t>(args.B);
  // Launched early behind the kernel before it in the stream (programmatic
  // dependent launch, launch_steps): wait for that kernel to complete before
  // reading any global memory it may have written (the accumulator; for the
  // first step also the mask).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint32_t acc[2][8];
  uint32_t idx_pos = 0, idx_neg = 0;
  if (valid) {
    load8(acc_in + (b * 2) * N + 8 * g, acc[0]);
    load8(acc_in + (b * 2 + 1) * N + 8 * g, acc[1]);
    indices<LogN>(args, args.a[b * args.n_steps + i], idx_pos, idx_neg);
  }
  const Tables t{args.fwd_w, args.fwd_ws, args.inv_w, args.inv_ws, args.pows};
  step<LogN, Dg2, C>(acc, buf_a, buf_b, t, args.bsk + i * kStepWords, idx_pos, idx_neg, args.k,
                     g, c, valid);
  if (valid) {
    store8(acc_out + (b * 2) * N + 8 * g, acc[0]);
    store8(acc_out + (b * 2 + 1) * N + 8 * g, acc[1]);
  }
}

// The wide whole scan (N >= 2^kWideLogN): one ciphertext a block, its
// accumulator in shared memory for the n steps (cggi_step_wide.cuh).
template <int LogN, int Dg2, bool kNatural>
__global__ void __launch_bounds__(kWideThreads<LogN>, 1)
wide_scan_kernel(const ScanArgs args) {
  constexpr int N = 1 << LogN;
  constexpr size_t kStepWords = static_cast<size_t>(4) * Dg2 * N;
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;          // [2, N], bit-reversed EVAL order
  uint32_t* work = smem + 2 * N;  // [4, N]: the exchange buffer, then u
  const int g = threadIdx.x;
  const size_t b = blockIdx.x;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t* src = args.acc_in + (b * 2 + p) * N;
    uint32_t v[8];
    if (kNatural) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = src[__brev(8 * g + j) >> (32 - LogN)];
    } else {
      load8(src + 8 * g, v);
    }
    store8(acc + p * N + 8 * g, v);
  }
  const Tables t{args.fwd_w, args.fwd_ws, args.inv_w, args.inv_ws, args.pows};
  const uint32_t* a = args.a + b * args.n_steps;
  for (int i = 0; i < args.n_steps; ++i) {
    uint32_t idx_pos, idx_neg;
    indices<LogN>(args, a[i], idx_pos, idx_neg);
    step_wide<LogN, Dg2>(acc, work, t, args.bsk + i * kStepWords, idx_pos, idx_neg, args.k, g);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t* dst = args.acc_out + (b * 2 + p) * N;
    uint32_t v[8];
    load8(acc + p * N + 8 * g, v);
    if (kNatural) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[__brev(8 * g + j) >> (32 - LogN)] = v[j];
    } else {
      store8(dst + 8 * g, v);
    }
  }
}

// Step i of the wide rotation: acc_in -> acc_out, bit-reversed order.
template <int LogN, int Dg2>
__global__ void __launch_bounds__(kWideThreads<LogN>, 1)
wide_step_kernel(const ScanArgs args, const uint32_t* __restrict__ acc_in,
                 uint32_t* __restrict__ acc_out, int i) {
  constexpr int N = 1 << LogN;
  constexpr size_t kStepWords = static_cast<size_t>(4) * Dg2 * N;
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;
  uint32_t* work = smem + 2 * N;
  const int g = threadIdx.x;
  const size_t b = blockIdx.x;
  // as step_kernel: wait for the kernel before it before any global read
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint32_t v[8];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    load8(acc_in + (b * 2 + p) * N + 8 * g, v);
    store8(acc + p * N + 8 * g, v);
  }
  uint32_t idx_pos, idx_neg;
  indices<LogN>(args, args.a[b * args.n_steps + i], idx_pos, idx_neg);
  const Tables t{args.fwd_w, args.fwd_ws, args.inv_w, args.inv_ws, args.pows};
  step_wide<LogN, Dg2>(acc, work, t, args.bsk + i * kStepWords, idx_pos, idx_neg, args.k, g);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    load8(acc + p * N + 8 * g, v);
    store8(acc_out + (b * 2 + p) * N + 8 * g, v);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The kernels, threads and blocks of a launch at one shape and C: the wide
// kernels from N = 2^kWideLogN on (one ciphertext a block), else the
// others.  The wide kernels take C = 1 only.
template <int LogN, int Dg2, int C, bool kNatural>
constexpr auto scan_of() {
  if constexpr (kWide<LogN>) {
    return wide_scan_kernel<LogN, Dg2, kNatural>;
  } else {
    return scan_kernel<LogN, Dg2, C, kNatural>;
  }
}

template <int LogN, int Dg2, int C>
constexpr auto step_of() {
  if constexpr (kWide<LogN>) {
    return wide_step_kernel<LogN, Dg2>;
  } else {
    return step_kernel<LogN, Dg2, C>;
  }
}

template <int LogN, int C>
constexpr int kBlockThreads = kWide<LogN> ? kWideThreads<LogN> : kThreads<LogN, C>;

template <int LogN, int C>
constexpr bool kTakesC = !kWide<LogN> || C == 1;

template <int LogN, int Dg2, int C, bool kNatural>
int launch_scan(const ScanArgs& args, cudaStream_t stream) {
  if (!kTakesC<LogN, C>) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = scan_of<LogN, Dg2, C, kNatural>();
  const size_t smem = smem_bytes(kNatural ? kScanNatural : kScanBitReversed, 1 << LogN, Dg2, C);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args.B + C - 1) / C;
  if (blocks > 0) kernel<<<blocks, kBlockThreads<LogN, C>, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int LogN, int Dg2, int C>
int launch_steps(const ScanArgs& args, uint32_t* buf0, uint32_t* buf1, cudaStream_t stream) {
  if (!kTakesC<LogN, C>) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = step_of<LogN, Dg2, C>();
  const size_t smem = smem_bytes(kStep, 1 << LogN, Dg2, C);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args.B + C - 1) / C;
  if (blocks == 0) return 0;
  // Programmatic dependent launch: each step's blocks may be launched
  // before the previous step has finished and wait in the kernel
  // (griddepcontrol.wait) before their first global read; the launch gap
  // overlaps the tail of the step before.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBlockThreads<LogN, C>);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const uint32_t* cur = args.acc_in;
  for (int i = 0; i < args.n_steps; ++i) {
    uint32_t* nxt = (i & 1) ? buf1 : buf0;
    err = cudaLaunchKernelEx(&cfg, kernel, args, cur, nxt, i);
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, size_t smem, int* blocks) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  }
  return static_cast<int>(err);
}

template <int LogN, int Dg2, int C>
int occupancy(int kind, int* blocks) {
  if (!kTakesC<LogN, C>) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(kind, 1 << LogN, Dg2, C);
  constexpr int kT = kBlockThreads<LogN, C>;
  if (kind == kScanNatural) {
    return occupancy_of(scan_of<LogN, Dg2, C, true>(), kT, smem, blocks);
  }
  if (kind == kScanBitReversed) {
    return occupancy_of(scan_of<LogN, Dg2, C, false>(), kT, smem, blocks);
  }
  return occupancy_of(step_of<LogN, Dg2, C>(), kT, smem, blocks);
}

}  // namespace cggi
}  // namespace fhe
