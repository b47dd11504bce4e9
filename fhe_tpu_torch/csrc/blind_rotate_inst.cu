// Instantiations of the blind-rotation kernels for one (log2 N, dG2) of
// cggi_shapes.h, with C = 1 and 2 ciphertexts per block: kernels/_build.py
// compiles this file once per shape, with -DFHE_INST_LOGN=.. and
// -DFHE_INST_DG2=.., in parallel.
#include "blind_rotate.cuh"

#if !defined(FHE_INST_LOGN) || !defined(FHE_INST_DG2)
#error "compile with -DFHE_INST_LOGN=<log2 N> -DFHE_INST_DG2=<dG2>"
#endif

namespace fhe {
namespace cggi {

#define FHE_INST(L, D, C)                                                            \
  template int launch_scan<L, D, C, true>(const ScanArgs&, cudaStream_t);            \
  template int launch_scan<L, D, C, false>(const ScanArgs&, cudaStream_t);           \
  template int launch_steps<L, D, C>(const ScanArgs&, uint32_t*, uint32_t*, cudaStream_t); \
  template int occupancy<L, D, C>(int, int*);

FHE_INST(FHE_INST_LOGN, FHE_INST_DG2, 1)
FHE_INST(FHE_INST_LOGN, FHE_INST_DG2, 2)

}  // namespace cggi
}  // namespace fhe
