// Kernels 1 and 2 at small N: the batched negacyclic forward and inverse
// NTT for N = 2^3..2^8 (ntt_shapes.h FHE_NTT_SMALL_SHAPES), natural order
// (the forward also in the stages' bit-reversed order), single modulus.
//
// Replaces: fhe_tpu/math/ntt_pallas.py `_fwd_kernel` / `_inv_kernel` at the
// N that ntt.cuh's design cannot take: its register rounds and swizzled
// exchange buffer (ntt_rounds.cuh ntt_word, mid_rounds) need log2 N >= 9.
// fhe_tpu runs every power of two from 8 (math/ntt.py make_plan); these
// rings carry the trapdoor's products at small N (lattice/trapdoor.py) and
// the Bluestein transforms' padded convolutions (math/ntt_arb.py
// _exact_linconv, 2^5 to 2^7 at fhe_tpu's test lengths).
//
// What bounds them on the H100: launch and latency.  A row is 32 B to
// 1 KiB; the callers launch a handful of rows (a few KiB, under a
// microsecond of memory traffic at 3.35 TB/s), so the time is the launch
// and the log N dependent stages.  The design is the simple one:
// - kSmallThreads = 256 threads a block, N/2 on each row, so
//   kSmallRows = 512 / N rows a block (64 at N = 8, 2 at N = 256); the
//   block's rows are one contiguous run of 512 words, loaded and stored
//   with consecutive threads on consecutive words; words past the last row
//   load zeros, store nothing, and every thread reaches every barrier;
// - each row in shared memory, one butterfly a thread a stage, one
//   __syncthreads a stage (log N of them);
// - the plan's tables (fwd_w / fwd_ws, inv_w / inv_ws: psi^br with Shoup
//   companions) read through L1, the stage's entry as
//   math/ntt.py forward_butterfly / inverse_butterfly index it;
// - canonical arithmetic for every q < 2^31: a Shoup product then one
//   minimum, sums and differences reduced at once, so each value stays in
//   [0, q) and the outputs are byte-equal to the plain versions; the
//   inverse's N^-1 is one more Shoup product a value on the way out;
// - the bit reversal of the natural order is an index on the shared row:
//   the forward stores position brev(p) at slot p, the inverse loads slot
//   p into position brev(p).
#include <cstdint>

#include <cuda_runtime.h>

#include "ntt_launch.h"
#include "ntt_rounds.cuh"
#include "ntt_shapes.h"

namespace fhe {
namespace ntt {

// p reversed over its low LogN bits.
template <int LogN>
__device__ __forceinline__ int brev_small(int p) {
  return static_cast<int>(__brev(static_cast<uint32_t>(p)) >> (32 - LogN));
}

template <int LogN>
constexpr int kSmallWords = kSmallRows<LogN> << LogN;

// [rows, N] COEFFICIENT -> EVALUATION, natural order or (kOutBr) the
// stages' bit-reversed order.
template <int LogN, bool kOutBr>
__global__ void __launch_bounds__(kSmallThreads) forward_small_kernel(const Args args) {
  constexpr int N = 1 << LogN, H = N / 2, W = kSmallWords<LogN>;
  __shared__ uint32_t buf[W];
  const size_t base = static_cast<size_t>(blockIdx.x) * W;
  const size_t total = static_cast<size_t>(args.rows) * N;
  for (int i = threadIdx.x; i < W; i += kSmallThreads) {
    buf[i] = base + i < total ? args.x[base + i] : 0u;
  }
  __syncthreads();
  const uint32_t q = args.q;
  uint32_t* const row = buf + (threadIdx.x / H) * N;
  const int j = threadIdx.x % H;
#pragma unroll
  for (int s = 0; s < LogN; ++s) {
    // stage s: groups of 2t positions, t = N / 2^(s+1); the pair (x, x + t)
    // of group i takes entry 2^s + i (forward_butterfly's w_all[m + i])
    const int t = H >> s;
    const int i = j / t;
    const int x = 2 * t * i + j % t;
    const uint32_t w = args.w[(1 << s) + i], ws = args.ws[(1 << s) + i];
    const uint32_t a = row[x];
    const uint32_t b = reduce(shoup_lazy(row[x + t], w, ws, q), q);
    row[x] = reduce(a + b, q);
    row[x + t] = reduce(a - b + q, q);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < W; i += kSmallThreads) {
    if (base + i < total) {
      const int p = i & (N - 1);
      args.y[base + i] = buf[kOutBr ? i : i - p + brev_small<LogN>(p)];
    }
  }
}

// [rows, N] natural-order EVALUATION -> COEFFICIENT with the N^-1 scale.
template <int LogN>
__global__ void __launch_bounds__(kSmallThreads) inverse_small_kernel(const Args args) {
  constexpr int N = 1 << LogN, H = N / 2, W = kSmallWords<LogN>;
  __shared__ uint32_t buf[W];
  const size_t base = static_cast<size_t>(blockIdx.x) * W;
  const size_t total = static_cast<size_t>(args.rows) * N;
  for (int i = threadIdx.x; i < W; i += kSmallThreads) {
    const int p = i & (N - 1);
    buf[i - p + brev_small<LogN>(p)] = base + i < total ? args.x[base + i] : 0u;
  }
  __syncthreads();
  const uint32_t q = args.q;
  uint32_t* const row = buf + (threadIdx.x / H) * N;
  const int j = threadIdx.x % H;
#pragma unroll
  for (int s = 0; s < LogN; ++s) {
    // stage s: groups of 2t positions, t = 2^s; group i takes entry
    // N / 2^(s+1) + i (inverse_butterfly's w_all[h + i])
    const int t = 1 << s;
    const int i = j >> s;
    const int x = 2 * t * i + (j & (t - 1));
    const uint32_t w = args.w[(H >> s) + i], ws = args.ws[(H >> s) + i];
    const uint32_t u = row[x], v = row[x + t];
    row[x] = reduce(u + v, q);
    row[x + t] = reduce(shoup_lazy(u - v + q, w, ws, q), q);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < W; i += kSmallThreads) {
    if (base + i < total) {
      args.y[base + i] = reduce(shoup_lazy(buf[i], args.ninv, args.ninv_s, q), q);
    }
  }
}

template <int LogN>
unsigned small_blocks(int rows) {
  return static_cast<unsigned>((rows + kSmallRows<LogN> - 1) / kSmallRows<LogN>);
}

template <int LogN, bool kOutBr>
int launch_forward_small(const Args& args, cudaStream_t stream) {
  const unsigned blocks = small_blocks<LogN>(args.rows);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  forward_small_kernel<LogN, kOutBr><<<blocks, kSmallThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int LogN>
int launch_inverse_small(const Args& args, cudaStream_t stream) {
  const unsigned blocks = small_blocks<LogN>(args.rows);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  inverse_small_kernel<LogN><<<blocks, kSmallThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

#define FHE_NTT_SMALL_INST(L)                                                  \
  static_assert(3 <= L && L <= 8, "the small-N kernels take N = 2^3..2^8");    \
  template int launch_forward_small<L, false>(const Args&, cudaStream_t);      \
  template int launch_forward_small<L, true>(const Args&, cudaStream_t);       \
  template int launch_inverse_small<L>(const Args&, cudaStream_t);

FHE_NTT_SMALL_SHAPES(FHE_NTT_SMALL_INST)

#undef FHE_NTT_SMALL_INST

}  // namespace ntt
}  // namespace fhe
