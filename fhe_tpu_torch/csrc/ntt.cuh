// The batched negacyclic NTT kernels (kernels 1 and 2), one compile-time N
// each, on the rounds of ntt_rounds.cuh; ntt_inst.cu instantiates them once
// per N of ntt_shapes.h.
//
// Replaces: fhe_tpu/math/ntt_pallas.py `_fwd_kernel` (forward_pallas,
// natural order or `out_br`) and `_inv_kernel` (inverse_pallas), the TPU
// kernels that keep a [tile, N] block in VMEM for all log N stages.
//
// What bounds them on the H100: bytes and integer issue, about equally.
// Each row is read and written once: 10 us at [4096, 1024] (33.5 MB at
// 3.35 TB/s).  At N = 1024 a thread issues about 680 instructions
// (profile_ntt's SASS count of the lazy forward), 275 IMAD on the
// multiply-add pipe and 280 adds, minima, shifts and logic on the integer
// pipe, each pipe 16 lanes a clock per SM quarter: 9-11 us of issue for
// [4096, 1024] on 132 SMs.  So the design spends as few instructions as it
// can and keeps the loads and stores under the arithmetic:
// - G = N/8 threads a row, P rows a block (about 256 threads where
//   N <= 2048) and several blocks a SM, so one block's loads overlap
//   another's rounds; rows past the end are masked lanes that load zeros,
//   store nothing and reach every barrier.
// - Register-resident rounds: an edge round straight from global memory
//   into registers, the middle rounds through the swizzled exchange buffer
//   (ntt_word: one XOR an access), an edge round from registers to global
//   memory: 2 barriers at N <= 1024, 3 at N >= 2048 (was
//   log N + 1), and no bank conflict in any exchange.
// - The bit reversal folded into the thread map, with no extra pass: on the
//   natural-order edge (the forward's last round, the inverse's first)
//   thread g works on positions 8 brev(g) + k, whose slots are
//   brev3(k) N/8 + g, so a warp's global accesses are consecutive words for
//   each k.  With out_br the forward stores positions 8g..8g+7 as they
//   stand, two 16-byte stores.
// - Lazy Harvey butterflies where q < 2^30 (4q < 2^32), canonical ones for
//   2^30 <= q < 2^31 (the wrapper picks from the plan's q); outputs are
//   canonical either way, byte-equal to the plain versions.  The N^-1
//   scale is folded into the inverse's last stage: (x + y) N^-1 and
//   (x - y) w_1 N^-1, one Shoup product each.
// - A round's twiddles are read once per item, through L1, a stage's run
//   of consecutive entries in as few vector loads as it takes.
//
// - N = 2^14 (CKKS bench config 3) and 2^15 (BFV bench config 4): a block
//   holds 1024 threads, so each takes two (four at 2^15) of the row's N/8
//   edge-round threads, one after the other; the middle rounds are two
//   16-value rounds at 2^14 (one item a thread) and three 8-value rounds
//   at 2^15 (four items a thread: a 32-value round would spill, a thread of
//   a 1024-thread block has 64 registers).  The 64 (128) KiB exchange
//   buffer is dynamic shared memory (static shared memory stops at 48 KiB,
//   a block may have 227 KiB), and ntt_word has its own swizzle for the
//   top bits of these N.  At 2^15 the one-block row was kept over a
//   two-pass four-step transform: it reads and writes each row once, as at
//   the smaller N, needs no second launch or transpose, and builds with 64
//   registers and no spill; its cost is one resident block a SM (128 KiB
//   of shared memory), so a short batch fills the card only through its
//   rows times limbs.  The smaller N compile to the kernels they were.
// - N = 2^16 (the 128-bit bootstrapping set): a row (256 KiB) is more than
//   a block's 227 KiB of shared memory, so after its first stage it runs
//   as two independent 2^15 transforms, each half a block on the 2^15
//   rounds with its own sub-table (ntt_launch.h kSplitLogN).  Of the two
//   designs (a cluster of two blocks exchanging the stage through
//   distributed shared memory, or the stage as its own pass over global
//   memory) this is the second, nearly: the forward folds the stage into
//   its first-round loads (each half block reads both halves of the row,
//   one launch, no extra pass) and stores its half's slots at stride 2;
//   the inverse loads its half's slots at stride 2 and leaves the stage,
//   with N^-1 folded in, to a second launch in place (inverse_stage_kernel:
//   one more read and write of the row).  It reuses the 2^15 code as it
//   stands; the cluster would save the inverse's extra pass.
//
// The limb-stacked kernels (forward_limbs_kernel, inverse_limbs_kernel) run
// the same rows on an RNS ring element [rows, L, N] (fhe_tpu/lattice/rns.py
// ntt_forward / ntt_inverse, XLA there; fhe_tpu_torch/lattice/rns.py): one
// launch for every limb, block (b, l) on P rows of limb l, with limb l's
// modulus and scale from the argument struct and its table from the
// stacked [L, N] tables.  The layout stays fhe_tpu's [..., L, N]: no
// transpose to limb-major, whose copy would double the traffic.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "ntt_launch.h"
#include "ntt_rounds.cuh"

namespace fhe {
namespace ntt {

template <int LogN>
constexpr int kThreads = kRows<LogN> * kRowThreads<LogN>;

// Edge-round threads each thread runs (2 at N = 2^14, 4 at 2^15, else 1).
template <int LogN>
constexpr int kEach = kG<LogN> / kRowThreads<LogN>;

// The exchange buffer's bytes, and whether they pass the 48 KiB of static
// shared memory a block may have (then the launcher allows them as
// dynamic shared memory).
template <int LogN>
constexpr int kBufBytes = (kRows<LogN> << LogN) * 4;
template <int LogN>
constexpr bool kDynamicBuf = kBufBytes<LogN> > 48 * 1024;

template <int LogN>
__device__ __forceinline__ uint32_t* exchange_buffer() {
  if constexpr (kDynamicBuf<LogN>) {
    extern __shared__ uint4 ntt_dynamic_buf[];
    return reinterpret_cast<uint32_t*>(ntt_dynamic_buf);
  } else {
    __shared__ uint32_t buf[kRows<LogN> << LogN];
    return buf;
  }
}

// Four blocks of 256 threads a SM (two of 512 at N = 4096, one of 1024 at
// N = 8192): registers capped at 64 a thread.  (Three blocks at about 70
// registers ran slower.)
template <int LogN>
constexpr int kMinBlocks = kThreads<LogN> >= 1024 ? 1 : 1024 / kThreads<LogN>;

// x reversed over its low Bits bits.
template <int Bits>
__device__ __forceinline__ int brev_bits(int x) {
  return static_cast<int>(__brev(static_cast<uint32_t>(x)) >> (32 - Bits));
}

// The inverse's N^-1 scale: N^-1 and w_1 N^-1, each with its Shoup companion.
struct Scale {
  uint32_t ninv, ninv_s, w1_ninv, w1_ninv_s;
};

// Half h of a 2N-point row (kSplit; ntt_launch.h kSplitLogN): the split
// stage's twiddle W[1] and its Shoup companion.
struct Half {
  int h;
  uint32_t w, ws;
};

// The forward transform of the block's P rows: this thread's row starts at
// x (input) and y (output); rows past the end (valid false) load zeros,
// store nothing and reach every barrier.  With kSplit the row is half h of
// a 2N-point row starting at x and y: the split stage runs as the first
// round loads (x[i] +- W[1] x[i + N], both halves read), and the output
// goes to positions hN + i, slots 2 brev(i) + h of the 2N-point row.
template <int LogN, bool kLazy, bool kOutBr, bool kSplit = false>
__device__ __forceinline__ void forward_rows(const uint32_t* x, uint32_t* y, bool valid,
                                             uint32_t* buf, const Tables& t, uint32_t q,
                                             const Half& half = Half{}) {
  constexpr int G = kG<LogN>, P = kRows<LogN>, T = kRowThreads<LogN>;
  using R = NttRounds<LogN, kLazy, kThreads<LogN>>;
  const int r = threadIdx.x / T, g0 = threadIdx.x % T;

  // first round (bits L-1..L-3) on positions g + j N/8, from global memory
#pragma unroll
  for (int e = 0; e < kEach<LogN>; ++e) {
    const int g = g0 + e * T;
    const uint32_t* src = x + g;
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kSplit) {
        // the split stage, values in [0, 4q) (lazy) or [0, q)
        const uint32_t a = src[j * G], b = src[j * G + (1 << LogN)];
        if constexpr (kLazy) {
          const uint32_t wb = shoup_lazy(b, half.w, half.ws, q);
          v[j] = half.h ? a - wb + 2 * q : a + wb;
        } else {
          const uint32_t wb = reduce(shoup_lazy(b, half.w, half.ws, q), q);
          v[j] = half.h ? reduce(a - wb + q, q) : reduce(a + wb, q);
        }
      } else {
        v[j] = valid ? src[j * G] : 0u;
      }
    }
    ntt_round<true, LogN, LogN - 3, 3, kLazy, true>(v, 0, t, q);
#pragma unroll
    for (int j = 0; j < 8; ++j) buf[R::at(r, g, j * G, 0)] = v[j];
  }
  __syncthreads();
  mid_rounds<true, LogN, P, 1, R>(buf, threadIdx.x, 0, true, t, q);
  if (!valid) return;

  // last round (bits 2-0) on positions 8h..8h+7, to global memory
#pragma unroll
  for (int e = 0; e < kEach<LogN>; ++e) {
    const int g = g0 + e * T;
    const int h = kOutBr ? g : brev_bits<LogN - 3>(g);
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = buf[R::at(r, 8 * h, k, 0)];
    ntt_round<true, LogN, 0, 3, kLazy, true>(v, h, t, q);
    if constexpr (kLazy) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = reduce(reduce(v[k], 2 * q), q);
    }
    if constexpr (kOutBr) {
      uint32_t* const dst = kSplit ? y + (half.h << LogN) : y;
      *reinterpret_cast<uint4*>(dst + 8 * g) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(dst + 8 * g + 4) = make_uint4(v[4], v[5], v[6], v[7]);
    } else if constexpr (kSplit) {
#pragma unroll
      for (int k = 0; k < 8; ++k) y[2 * (brev_bits<3>(k) * G + g) + half.h] = v[k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) y[brev_bits<3>(k) * G + g] = v[k];
    }
  }
}

// The inverse transform of the block's P rows, as forward_rows.  With
// kSplit the row is half `half` of a 2N-point row starting at x: its input
// is slots 2i + half, its output (positions half N + i, at y) in [0, q)
// without the scale, and the split stage is inverse_stage_kernel's.
template <int LogN, bool kLazy, bool kSplit = false>
__device__ __forceinline__ void inverse_rows(const uint32_t* x, uint32_t* y, bool valid,
                                             uint32_t* buf, const Tables& t, uint32_t q,
                                             const Scale& scale, int half = 0) {
  constexpr int G = kG<LogN>, P = kRows<LogN>, T = kRowThreads<LogN>;
  using R = NttRounds<LogN, kLazy, kThreads<LogN>>;
  const int r = threadIdx.x / T, g0 = threadIdx.x % T;

  // first round (bits 0-2) on positions 8h..8h+7, h = brev(g): position
  // 8h + k holds slot brev3(k) N/8 + g of the natural-order input
#pragma unroll
  for (int e = 0; e < kEach<LogN>; ++e) {
    const int g = g0 + e * T;
    const int h = brev_bits<LogN - 3>(g);
    const uint32_t* src = x + g;
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = kSplit ? x[2 * (brev_bits<3>(k) * G + g) + half]
                    : (valid ? src[brev_bits<3>(k) * G] : 0u);
    }
    ntt_round<false, LogN, 0, 3, kLazy, true>(v, h, t, q);
#pragma unroll
    for (int k = 0; k < 8; ++k) buf[R::at(r, 8 * h, k, 0)] = v[k];
  }
  __syncthreads();
  mid_rounds<false, LogN, P, 1, R>(buf, threadIdx.x, 0, true, t, q);
  if (!valid) return;

  // last round on positions g + j N/8, to global memory: the stages on bits
  // L-3 and L-2 (lo and hi: bit L-1 clear and set), then the stage on bit
  // L-1 with N^-1 folded in, (x + y) N^-1 and (x - y) w_1 N^-1
#pragma unroll
  for (int e = 0; e < kEach<LogN>; ++e) {
    const int g = g0 + e * T;
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = buf[R::at(r, g, j * G, 0)];
      hi[j] = buf[R::at(r, g, (j + 4) * G, 0)];
    }
    ntt_round<false, LogN, LogN - 3, 2, kLazy, true>(lo, 0, t, q);
    ntt_round<false, LogN, LogN - 3, 2, kLazy, true>(hi, 1, t, q);
    const uint32_t lift = kLazy ? 2 * q : q;     // x - y + lift > 0
    uint32_t* dst = y + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[j * G] = kSplit ? reduce(reduce(lo[j] + hi[j], 2 * q), q)
                          : reduce(shoup_lazy(lo[j] + hi[j], scale.ninv, scale.ninv_s, q), q);
      dst[(j + 4) * G] =
          reduce(shoup_lazy(lo[j] - hi[j] + lift, scale.w1_ninv, scale.w1_ninv_s, q), q);
    }
  }
}

template <int LogN, bool kLazy, bool kOutBr>
__global__ void __launch_bounds__(kThreads<LogN>, kMinBlocks<LogN>)
forward_kernel(const Args args) {
  constexpr int N = 1 << LogN;
  uint32_t* const buf = exchange_buffer<LogN>();
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kRows<LogN> + threadIdx.x / kRowThreads<LogN>;
  const Tables t{args.w, args.ws, args.w, args.ws, nullptr};
  forward_rows<LogN, kLazy, kOutBr>(args.x + row * N, args.y + row * N,
                                    row < static_cast<size_t>(args.rows), buf, t, args.q);
}

template <int LogN, bool kLazy>
__global__ void __launch_bounds__(kThreads<LogN>, kMinBlocks<LogN>)
inverse_kernel(const Args args) {
  constexpr int N = 1 << LogN;
  uint32_t* const buf = exchange_buffer<LogN>();
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kRows<LogN> + threadIdx.x / kRowThreads<LogN>;
  const Tables t{args.w, args.ws, args.w, args.ws, nullptr};
  inverse_rows<LogN, kLazy>(args.x + row * N, args.y + row * N,
                            row < static_cast<size_t>(args.rows), buf, t, args.q,
                            Scale{args.ninv, args.ninv_s, args.w1_ninv, args.w1_ninv_s});
}

// The limb-stacked kernels: block (b, l) transforms rows bP..bP+P-1 of limb
// l, each at (row * limbs + l) N, with limb l's table, modulus and scale.
// Only how a block finds its rows, modulus and tables differs from the
// kernels above.
template <int LogN, bool kLazy>
__global__ void __launch_bounds__(kThreads<LogN>, kMinBlocks<LogN>)
forward_limbs_kernel(const __grid_constant__ LimbArgs args) {
  constexpr int N = 1 << LogN;
  uint32_t* const buf = exchange_buffer<LogN>();
  const int l = blockIdx.y;
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kRows<LogN> + threadIdx.x / kRowThreads<LogN>;
  const size_t at = (row * args.limbs + l) * N;
  const Tables t{args.w + l * N, args.ws + l * N, args.w + l * N, args.ws + l * N, nullptr};
  forward_rows<LogN, kLazy, false>(args.x + at, args.y + at,
                                   row < static_cast<size_t>(args.rows), buf, t, args.q[l]);
}

template <int LogN, bool kLazy>
__global__ void __launch_bounds__(kThreads<LogN>, kMinBlocks<LogN>)
inverse_limbs_kernel(const __grid_constant__ LimbArgs args) {
  constexpr int N = 1 << LogN;
  uint32_t* const buf = exchange_buffer<LogN>();
  const int l = blockIdx.y;
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kRows<LogN> + threadIdx.x / kRowThreads<LogN>;
  const size_t at = (row * args.limbs + l) * N;
  const Tables t{args.w + l * N, args.ws + l * N, args.w + l * N, args.ws + l * N, nullptr};
  inverse_rows<LogN, kLazy>(args.x + at, args.y + at, row < static_cast<size_t>(args.rows), buf,
                            t, args.q[l],
                            Scale{args.ninv[l], args.ninv_s[l], args.w1_ninv[l],
                                  args.w1_ninv_s[l]});
}

// N = 2^kSplitLogN (ntt_launch.h): block (r, l, h) runs half h of row r of
// limb l as a transform of H = N/2 on the rounds of LogN - 1, with the
// half's table T_h from the split tables.  The forward is one launch (each
// half reads the whole row: the split stage needs both halves, the second
// read mostly from L2); the inverse writes each half's transform to y and
// inverse_stage_kernel runs the split stage in place, with N^-1 folded in.
// The single-modulus entry points run as one limb.
constexpr int kHalfLogN = kSplitLogN - 1;

template <bool kLazy, bool kOutBr>
__global__ void __launch_bounds__(kThreads<kHalfLogN>, 1)
forward_half_kernel(const __grid_constant__ LimbArgs args) {
  constexpr int N = 1 << kSplitLogN, H = N / 2;
  uint32_t* const buf = exchange_buffer<kHalfLogN>();
  const int l = blockIdx.y, h = blockIdx.z;
  const size_t at = (static_cast<size_t>(blockIdx.x) * args.limbs + l) * N;
  const uint32_t* w = args.w + static_cast<size_t>(l) * N + h * H;
  const uint32_t* ws = args.ws + static_cast<size_t>(l) * N + h * H;
  const Tables t{w, ws, w, ws, nullptr};
  forward_rows<kHalfLogN, kLazy, kOutBr, true>(args.x + at, args.y + at, true, buf, t,
                                               args.q[l], Half{h, w[0], ws[0]});
}

template <bool kLazy>
__global__ void __launch_bounds__(kThreads<kHalfLogN>, 1)
inverse_half_kernel(const __grid_constant__ LimbArgs args) {
  constexpr int N = 1 << kSplitLogN, H = N / 2;
  uint32_t* const buf = exchange_buffer<kHalfLogN>();
  const int l = blockIdx.y, h = blockIdx.z;
  const size_t at = (static_cast<size_t>(blockIdx.x) * args.limbs + l) * N;
  const uint32_t* w = args.w + static_cast<size_t>(l) * N + h * H;
  const uint32_t* ws = args.ws + static_cast<size_t>(l) * N + h * H;
  const Tables t{w, ws, w, ws, nullptr};
  // the half's last stage takes T_h[1], unscaled
  inverse_rows<kHalfLogN, kLazy, true>(args.x + at, args.y + at + h * H, true, buf, t,
                                       args.q[l], Scale{0, 0, w[1], ws[1]}, h);
}

// The inverse's split stage on y in place, (a + b) N^-1 and (a - b) W[1]
// N^-1 (W the inverse table) from the halves' outputs a = y[i], b = y[i +
// N/2], both in [0, q): block (rl, c) takes row-limb rl, four pairs a
// thread from 4 (256 c + thread).  (A template, as every kernel here: each
// N's unit includes this file.)
constexpr int kStageThreads = 256;

template <int LogN>
__global__ void __launch_bounds__(kStageThreads)
inverse_stage_kernel(const __grid_constant__ LimbArgs args) {
  constexpr int N = 1 << LogN, H = N / 2;
  const int l = blockIdx.x % args.limbs;
  uint32_t* const p =
      args.y + static_cast<size_t>(blockIdx.x) * N + 4 * (blockIdx.y * kStageThreads + threadIdx.x);
  const uint32_t q = args.q[l];
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + H);
  auto lo = [&](uint32_t x, uint32_t y) {
    return reduce(shoup_lazy(x + y, args.ninv[l], args.ninv_s[l], q), q);
  };
  auto hi = [&](uint32_t x, uint32_t y) {
    return reduce(shoup_lazy(x - y + q, args.w1_ninv[l], args.w1_ninv_s[l], q), q);
  };
  *reinterpret_cast<uint4*>(p) = make_uint4(lo(a.x, b.x), lo(a.y, b.y), lo(a.z, b.z), lo(a.w, b.w));
  *reinterpret_cast<uint4*>(p + H) =
      make_uint4(hi(a.x, b.x), hi(a.y, b.y), hi(a.z, b.z), hi(a.w, b.w));
}

// The launch of a kernel of N = 2^LogN on `blocks` blocks: where the
// exchange buffer is dynamic shared memory, the kernel's cap is raised to
// it at its first launch on each device (the attribute belongs to the
// device's copy of the kernel), not at every launch.
template <int LogN, auto Kernel, typename A>
int launch(dim3 blocks, const A& args, cudaStream_t stream) {
  if (blocks.x == 0) return static_cast<int>(cudaGetLastError());
  if constexpr (kDynamicBuf<LogN>) {
    static std::atomic<uint64_t> raised{0};  // one bit a device, devices 0-63
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (bit == 0 || !(raised.load(std::memory_order_acquire) & bit)) {
      rc = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kBufBytes<LogN>);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      raised.fetch_or(bit, std::memory_order_release);
    }
  }
  Kernel<<<blocks, kThreads<LogN>, kDynamicBuf<LogN> ? kBufBytes<LogN> : 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int LogN>
unsigned row_blocks(int rows) {
  return static_cast<unsigned>((rows + kRows<LogN> - 1) / kRows<LogN>);
}

// The split transforms at N = 2^kSplitLogN (LimbArgs; one limb for Args).
inline LimbArgs one_limb(const Args& a) {
  LimbArgs out{a.x, a.y, a.w, a.ws, a.rows, 1, {}, {}, {}, {}, {}};
  out.q[0] = a.q;
  out.ninv[0] = a.ninv;
  out.ninv_s[0] = a.ninv_s;
  out.w1_ninv[0] = a.w1_ninv;
  out.w1_ninv_s[0] = a.w1_ninv_s;
  return out;
}

template <bool kLazy, bool kOutBr>
int launch_forward_split(const LimbArgs& args, cudaStream_t stream) {
  return launch<kHalfLogN, forward_half_kernel<kLazy, kOutBr>>(
      dim3(static_cast<unsigned>(args.rows), args.limbs, 2), args, stream);
}

template <bool kLazy>
int launch_inverse_split(const LimbArgs& args, cudaStream_t stream) {
  const int rc = launch<kHalfLogN, inverse_half_kernel<kLazy>>(
      dim3(static_cast<unsigned>(args.rows), args.limbs, 2), args, stream);
  if (rc != 0 || args.rows == 0) return rc;
  constexpr unsigned kChunks = (1u << kSplitLogN) / 2 / 4 / kStageThreads;
  inverse_stage_kernel<kSplitLogN><<<dim3(static_cast<unsigned>(args.rows) * args.limbs, kChunks),
                         kStageThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int LogN, bool kLazy, bool kOutBr>
int launch_forward(const Args& args, cudaStream_t stream) {
  if constexpr (LogN == kSplitLogN) {
    return launch_forward_split<kLazy, kOutBr>(one_limb(args), stream);
  } else {
    return launch<LogN, forward_kernel<LogN, kLazy, kOutBr>>(dim3(row_blocks<LogN>(args.rows)),
                                                             args, stream);
  }
}

template <int LogN, bool kLazy>
int launch_inverse(const Args& args, cudaStream_t stream) {
  if constexpr (LogN == kSplitLogN) {
    return launch_inverse_split<kLazy>(one_limb(args), stream);
  } else {
    return launch<LogN, inverse_kernel<LogN, kLazy>>(dim3(row_blocks<LogN>(args.rows)), args,
                                                     stream);
  }
}

template <int LogN, bool kLazy>
int launch_forward_limbs(const LimbArgs& args, cudaStream_t stream) {
  if constexpr (LogN == kSplitLogN) {
    return launch_forward_split<kLazy, false>(args, stream);
  } else {
    return launch<LogN, forward_limbs_kernel<LogN, kLazy>>(
        dim3(row_blocks<LogN>(args.rows), args.limbs), args, stream);
  }
}

template <int LogN, bool kLazy>
int launch_inverse_limbs(const LimbArgs& args, cudaStream_t stream) {
  if constexpr (LogN == kSplitLogN) {
    return launch_inverse_split<kLazy>(args, stream);
  } else {
    return launch<LogN, inverse_limbs_kernel<LogN, kLazy>>(
        dim3(row_blocks<LogN>(args.rows), args.limbs), args, stream);
  }
}

}  // namespace ntt
}  // namespace fhe
