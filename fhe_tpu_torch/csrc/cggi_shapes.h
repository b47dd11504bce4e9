// The (log2 N, dG2) shapes the blind-rotation kernels are instantiated for:
// every (N, dG2) of the single-word parameter sets (Q < 2^30) with N <= 2048,
// and TOY_RADIX's (8192, 10) on the wide step (tfhe/params.py).  One list
// for the build (kernels/_build.py compiles blind_rotate_inst.cu once per
// entry), the dispatch (blind_rotate.cu) and the Python wrappers' shape
// check (kernels/blind_rotate.py parses it).
#pragma once

#define FHE_CGGI_SHAPES(X) \
  X(9, 4)                  \
  X(10, 4)                 \
  X(10, 6)                 \
  X(11, 4)                 \
  X(11, 6)                 \
  X(11, 8)                 \
  X(13, 10)
