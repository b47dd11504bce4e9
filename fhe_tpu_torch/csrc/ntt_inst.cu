// Instantiations of the NTT kernels for one log2 N of ntt_shapes.h, lazy
// and canonical, forward in both output orders, inverse, and the
// limb-stacked forward and inverse:
// kernels/_build.py compiles this file once per N, with -DFHE_NTT_LOGN=..,
// in parallel.
#include "ntt.cuh"

#if !defined(FHE_NTT_LOGN)
#error "compile with -DFHE_NTT_LOGN=<log2 N>"
#endif

namespace fhe {
namespace ntt {

#define FHE_NTT_INST(L, LAZY)                                                \
  template int launch_forward<L, LAZY, false>(const Args&, cudaStream_t);    \
  template int launch_forward<L, LAZY, true>(const Args&, cudaStream_t);     \
  template int launch_inverse<L, LAZY>(const Args&, cudaStream_t);           \
  template int launch_forward_limbs<L, LAZY>(const LimbArgs&, cudaStream_t); \
  template int launch_inverse_limbs<L, LAZY>(const LimbArgs&, cudaStream_t);

FHE_NTT_INST(FHE_NTT_LOGN, true)
FHE_NTT_INST(FHE_NTT_LOGN, false)

}  // namespace ntt
}  // namespace fhe
