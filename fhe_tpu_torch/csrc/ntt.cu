// C entry points of the NTT kernels (ntt.cuh), single-modulus and
// limb-stacked: each dispatches on N over the shapes of ntt_shapes.h and on
// the arithmetic (lazy where every q < 2^30, chosen by the caller) to the
// instantiation compiled from ntt_inst.cu; the single-modulus ones also
// over FHE_NTT_SMALL_SHAPES to the small-N kernels of ntt_small.cu.
// An N with no instantiation returns cudaErrorInvalidValue without
// launching; the Python wrappers (kernels/ntt.py) raise before they get
// here.  Also the library's error strings.
#include <cuda_runtime.h>

#include "ntt_launch.h"
#include "ntt_shapes.h"

namespace {

using fhe::ntt::Args;

Args make_args(const void* x, void* y, const void* w, const void* ws, int rows, uint32_t q,
               uint32_t ninv, uint32_t ninv_s, uint32_t w1_ninv, uint32_t w1_ninv_s) {
  return Args{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
              static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(ws), rows, q,
              ninv, ninv_s, w1_ninv, w1_ninv_s};
}

}  // namespace

extern "C" {

// [rows, N] COEFFICIENT -> EVALUATION, natural order or (out_br) the
// stages' bit-reversed order; w/ws the plan's fwd_w/fwd_ws.
int fhe_ntt_forward(const void* x, void* y, const void* w, const void* ws, int rows, int N,
                    uint32_t q, int out_br, int lazy, void* stream) {
  const Args args = make_args(x, y, w, ws, rows, q, 0, 0, 0, 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FHE_FWD_CASE(L)                                                             \
  if (N == (1 << L)) {                                                              \
    if (lazy) {                                                                     \
      return out_br ? fhe::ntt::launch_forward<L, true, true>(args, s)              \
                    : fhe::ntt::launch_forward<L, true, false>(args, s);            \
    }                                                                               \
    return out_br ? fhe::ntt::launch_forward<L, false, true>(args, s)               \
                  : fhe::ntt::launch_forward<L, false, false>(args, s);             \
  }
  FHE_NTT_SHAPES(FHE_FWD_CASE)
#undef FHE_FWD_CASE
#define FHE_FWD_SMALL_CASE(L)                                                       \
  if (N == (1 << L)) {                                                              \
    return out_br ? fhe::ntt::launch_forward_small<L, true>(args, s)                \
                  : fhe::ntt::launch_forward_small<L, false>(args, s);              \
  }
  FHE_NTT_SMALL_SHAPES(FHE_FWD_SMALL_CASE)
#undef FHE_FWD_SMALL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// [rows, N] natural-order EVALUATION -> COEFFICIENT with the N^-1 scale;
// w/ws the plan's inv_w/inv_ws; ninv = N^-1 and w1_ninv = inv_w[1] N^-1 mod
// q, each with its Shoup companion.
int fhe_ntt_inverse(const void* x, void* y, const void* w, const void* ws, int rows, int N,
                    uint32_t q, uint32_t ninv, uint32_t ninv_s, uint32_t w1_ninv,
                    uint32_t w1_ninv_s, int lazy, void* stream) {
  const Args args = make_args(x, y, w, ws, rows, q, ninv, ninv_s, w1_ninv, w1_ninv_s);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FHE_INV_CASE(L)                                                             \
  if (N == (1 << L)) {                                                              \
    return lazy ? fhe::ntt::launch_inverse<L, true>(args, s)                        \
                : fhe::ntt::launch_inverse<L, false>(args, s);                      \
  }
  FHE_NTT_SHAPES(FHE_INV_CASE)
#undef FHE_INV_CASE
#define FHE_INV_SMALL_CASE(L) \
  if (N == (1 << L)) return fhe::ntt::launch_inverse_small<L>(args, s);
  FHE_NTT_SMALL_SHAPES(FHE_INV_SMALL_CASE)
#undef FHE_INV_SMALL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// The limb-stacked transforms of [rows, limbs, N] (w/ws the limbs' tables
// stacked [limbs, N]).  scalars holds limbs entries each of q, then, for
// the inverse, N^-1, its Shoup companion, w_1 N^-1 and its companion (as
// fhe_ntt_inverse's), row by row: [1 or 5, limbs].  A limb count outside
// 1..kMaxLimbs returns cudaErrorInvalidValue without launching.
namespace {

int limb_args(fhe::ntt::LimbArgs* args, const void* x, void* y, const void* w, const void* ws,
              int rows, int limbs, const uint32_t* scalars, bool scale) {
  if (limbs < 1 || limbs > fhe::ntt::kMaxLimbs) return static_cast<int>(cudaErrorInvalidValue);
  *args = fhe::ntt::LimbArgs{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
                             static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(ws),
                             rows, limbs, {}, {}, {}, {}, {}};
  uint32_t* rows_of[] = {args->q, args->ninv, args->ninv_s, args->w1_ninv, args->w1_ninv_s};
  for (int k = 0; k < (scale ? 5 : 1); ++k) {
    for (int l = 0; l < limbs; ++l) rows_of[k][l] = scalars[k * limbs + l];
  }
  return 0;
}

}  // namespace

extern "C" {

int fhe_ntt_forward_limbs(const void* x, void* y, const void* w, const void* ws, int rows,
                          int limbs, int N, const uint32_t* scalars, int lazy, void* stream) {
  fhe::ntt::LimbArgs args;
  if (const int rc = limb_args(&args, x, y, w, ws, rows, limbs, scalars, false)) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FHE_FWD_LIMBS_CASE(L)                                                       \
  if (N == (1 << L)) {                                                              \
    return lazy ? fhe::ntt::launch_forward_limbs<L, true>(args, s)                  \
                : fhe::ntt::launch_forward_limbs<L, false>(args, s);                \
  }
  FHE_NTT_SHAPES(FHE_FWD_LIMBS_CASE)
#undef FHE_FWD_LIMBS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int fhe_ntt_inverse_limbs(const void* x, void* y, const void* w, const void* ws, int rows,
                          int limbs, int N, const uint32_t* scalars, int lazy, void* stream) {
  fhe::ntt::LimbArgs args;
  if (const int rc = limb_args(&args, x, y, w, ws, rows, limbs, scalars, true)) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FHE_INV_LIMBS_CASE(L)                                                       \
  if (N == (1 << L)) {                                                              \
    return lazy ? fhe::ntt::launch_inverse_limbs<L, true>(args, s)                  \
                : fhe::ntt::launch_inverse_limbs<L, false>(args, s);                \
  }
  FHE_NTT_SHAPES(FHE_INV_LIMBS_CASE)
#undef FHE_INV_LIMBS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rows a block of the N-point kernels holds (0 for an N with no kernel).
int fhe_ntt_rows_per_block(int N) {
#define FHE_ROWS_CASE(L) \
  if (N == (1 << L)) return fhe::ntt::kRows<L>;
  FHE_NTT_SHAPES(FHE_ROWS_CASE)
#undef FHE_ROWS_CASE
#define FHE_SMALL_ROWS_CASE(L) \
  if (N == (1 << L)) return fhe::ntt::kSmallRows<L>;
  FHE_NTT_SMALL_SHAPES(FHE_SMALL_ROWS_CASE)
#undef FHE_SMALL_ROWS_CASE
  return 0;
}

const char* fhe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
