// The log2 N the NTT kernels (ntt.cuh) are instantiated for: every ring
// dimension of the parameter sets (tfhe/params.py), TOY's 2^9 to
// TOY_RADIX's 2^13, and 2^12, which no set uses but callers of the NTT
// itself had before the kernels were specialised.  One list for the build
// (kernels/_build.py compiles ntt_inst.cu once per entry), the dispatch
// (ntt.cu) and the Python wrappers' check (kernels/ntt.py parses it).
// N >= 2^14 would need more than 48 KB of shared memory a block.
#pragma once

#define FHE_NTT_SHAPES(X) \
  X(9)                    \
  X(10)                   \
  X(11)                   \
  X(12)                   \
  X(13)
