// Arguments and launchers of the NTT kernels, declared for the dispatcher
// (ntt.cu) without their definitions: those are in ntt.cuh, instantiated
// once per N by ntt_inst.cu.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace fhe {

// log2 of a power of two (host; the NTT and blind-rotation entry points).
inline int log2_int(int N) {
  int l = 0;
  while ((1 << l) < N) ++l;
  return l;
}

namespace ntt {

// One transform of `rows` rows of N residues, x -> y (both [rows, N]), with
// the plan's table for the direction (fwd_w / fwd_ws or inv_w / inv_ws,
// 16-byte aligned).  The inverse's scale: N^-1 and w_1 N^-1 (w_1 = inv_w[1],
// the last stage's twiddle), each with its Shoup companion.  At N =
// 2^kSplitLogN, w/ws are the plan's split tables instead (see kSplitLogN).
struct Args {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* w;
  const uint32_t* ws;
  int rows;
  uint32_t q, ninv, ninv_s, w1_ninv, w1_ninv_s;
};

// A row's edge-round threads (N/8, each on 8 values) and rows per block:
// about 256 threads a block where N <= 2048, one row a block above.  A
// block has at most 1024 threads, so at N = 2^14 each of a row's 1024
// threads takes two of its N/8 edge-round threads, at 2^15 four
// (kRowThreads).
//
// N = 2^kSplitLogN runs as two transforms of N/2 (whose row does not fit one
// block's shared memory): the stage on the top position bit splits a row
// into two halves whose remaining stages are independent N/2-point
// transforms.  A half's stage on bit b at position x (< N/2) takes entry
// (N + h N/2 + x) >> (b + 1) of the N-point table, which is entry
// u = (N/2 + x) >> (b + 1) of the half's own table T_h:
//   T_h[u] = W[u + (1 + h) 2^k] for 2^k <= u < 2^(k+1),
// the h-th half of each level of W.  The split tables (kernels/ntt.py
// `split_tables`) are [T_0 | T_1] per limb, [limbs, N], with T_h[0], which
// no stage reads, holding the split stage's twiddle W[1].
constexpr int kSplitLogN = 16;

template <int LogN>
constexpr int kG = 1 << (LogN - 3);
template <int LogN>
constexpr int kRows = kG<LogN> >= 256 ? 1 : 256 / kG<LogN>;
template <int LogN>
constexpr int kRowThreads = kG<LogN> > 1024 ? 1024 : kG<LogN>;

// Forward NTT, natural COEFF -> natural EVAL (or, with kOutBr, the stages'
// bit-reversed EVAL order); kLazy needs q < 2^30.
template <int LogN, bool kLazy, bool kOutBr>
int launch_forward(const Args& args, cudaStream_t stream);

// Inverse NTT with the N^-1 scale, natural EVAL -> natural COEFF.
template <int LogN, bool kLazy>
int launch_inverse(const Args& args, cudaStream_t stream);

// The limb-stacked transforms, x -> y (both [rows, limbs, N]): row r of
// limb l is a residue mod q[l], transformed with that limb's table (w and
// ws are the limbs' tables stacked [limbs, N], 16-byte aligned) and, for
// the inverse, its scale (as Args's).  A block takes P rows of one limb.
// The kernels take the struct as a __grid_constant__ parameter and read
// limb l's scalars by index (one constant-bank load each): five arrays of
// kMaxLimbs words, 1,280 bytes of the 4 KiB a kernel's parameters may take.
constexpr int kMaxLimbs = 64;  // kernels/ntt.py reads this line

struct LimbArgs {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* w;
  const uint32_t* ws;
  int rows, limbs;
  uint32_t q[kMaxLimbs], ninv[kMaxLimbs], ninv_s[kMaxLimbs], w1_ninv[kMaxLimbs],
      w1_ninv_s[kMaxLimbs];
};

// kLazy needs every limb below 2^30.
template <int LogN, bool kLazy>
int launch_forward_limbs(const LimbArgs& args, cudaStream_t stream);

template <int LogN, bool kLazy>
int launch_inverse_limbs(const LimbArgs& args, cudaStream_t stream);

// The small-N kernels (ntt_small.cu) for N = 2^3..2^8 (ntt_shapes.h
// FHE_NTT_SMALL_SHAPES), single-modulus only: kSmallThreads threads a block,
// N/2 on each row (one butterfly a stage each), so kSmallRows rows a block.
// Canonical arithmetic at every q < 2^31 (the lazy flag is not read).
constexpr int kSmallThreads = 256;
template <int LogN>
constexpr int kSmallRows = 2 * kSmallThreads >> LogN;

template <int LogN, bool kOutBr>
int launch_forward_small(const Args& args, cudaStream_t stream);

template <int LogN>
int launch_inverse_small(const Args& args, cudaStream_t stream);

}  // namespace ntt
}  // namespace fhe
