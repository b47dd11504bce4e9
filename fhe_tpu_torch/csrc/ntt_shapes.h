// The log2 N the NTT kernels (ntt.cuh) are instantiated for: every ring
// dimension of the parameter sets (tfhe/params.py), TOY's 2^9 to
// TOY_RADIX's 2^13, 2^12 (CKKS bench config 5's threshold decrypt,
// pke/multiparty.py), CKKS bench config 3's 2^14 (pke/ckks.py), BFV
// bench config 4's 2^15 (pke/bfv.py) and the 128-bit bootstrapping set's
// 2^16 (pke/bootstrap.py).  One list for the build (kernels/_build.py
// compiles ntt_inst.cu once per entry), the dispatch (ntt.cu) and the
// Python wrappers' check (kernels/ntt.py parses it).  2^15 is the largest
// row one block holds (ntt_word's swizzles, the three middle rounds of
// mid_rounds, 128 KiB of dynamic shared memory); 2^16 runs as two 2^15
// halves after its first stage (ntt_launch.h kSplitLogN), and is the
// largest the design takes.  Below 2^9 the exchange-buffer swizzles do not
// apply: those N are FHE_NTT_SMALL_SHAPES' kernels.
#pragma once

#define FHE_NTT_SHAPES(X) \
  X(9)                    \
  X(10)                   \
  X(11)                   \
  X(12)                   \
  X(13)                   \
  X(14)                   \
  X(15)                   \
  X(16)

// The log2 N of the small-N kernels (ntt_small.cu: one shared-memory row
// per N/2 threads, several rows a block), for fhe_tpu's smallest rings:
// 2^3 (the least N fhe_tpu's make_plan takes) to 2^8, the trapdoor's and
// the Bluestein transforms' padded lengths (math/ntt_arb.py
// _exact_linconv: 2^5 to 2^7 at fhe_tpu's test lengths).  The same three
// readers as FHE_NTT_SHAPES; the build compiles ntt_small.cu once for all.
#define FHE_NTT_SMALL_SHAPES(X) \
  X(3)                          \
  X(4)                          \
  X(5)                          \
  X(6)                          \
  X(7)                          \
  X(8)
