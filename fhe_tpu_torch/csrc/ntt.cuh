// Device functions of the NTT kernels (ntt.cu).  The blind-rotation step
// (cggi_step.cuh) has its own register-resident rounds.
//
// Residues are uint32 words in [0, q) with q < 2^31 an NTT prime.  The
// twiddle products are the reference's Shoup products (w, w' = floor(w
// 2^32 / q); fhe_tpu/math/modmath.py shoup_mul) and return canonical
// residues, so results are byte-identical to the plain PyTorch versions and
// to fhe_tpu.
//
// Ordering convention (fhe_tpu/math/ntt.py): EVAL is natural order,
// eval[k] = a(psi^(2k+1)).  The stages below work in place in shared
// memory: the forward (Cooley-Tukey) stages take natural COEFF order and
// leave bit-reversed EVAL order; the inverse (Gentleman-Sande) stages take
// bit-reversed EVAL order and leave natural COEFF order without the N^-1
// scale.  Callers fix the order on load or store with `brev`.
#pragma once

#include <cstdint>

namespace fhe {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t t = a + b;
  return t >= q ? t - q : t;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// a * w mod q for any uint32 a, with ws = floor(w * 2^32 / q), w < q < 2^31.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t ws,
                                              uint32_t q) {
  const uint32_t qt = __umulhi(a, ws);
  const uint32_t r = a * w - qt * q;  // in [0, 2q)
  return r >= q ? r - q : r;
}

__device__ __forceinline__ int brev(int k, int logN) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logN));
}

// Forward stages over `npolys` polynomials stored back to back (stride N)
// in shared memory.  w/ws: the plan's fwd_w/fwd_ws tables, psi^br(j).
// Stage s pairs (i*2t + j, i*2t + j + t), t = N >> (s+1), with twiddle
// w[2^s + i]: fhe_tpu/math/ntt.py forward_butterfly.  Ends synchronised.
__device__ __forceinline__ void ntt_fwd_stages(uint32_t* s, int npolys, int N, int logN,
                                               const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ ws,
                                               uint32_t q) {
  const int half_log = logN - 1;
  const int total = npolys << half_log;
  for (int st = 0; st < logN; ++st) {
    const int tlog = logN - st - 1;
    const int m = 1 << st;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int p = k >> half_log;
      const int kk = k & ((1 << half_log) - 1);
      const int i = kk >> tlog;
      const int j = kk & ((1 << tlog) - 1);
      const int i0 = p * N + (i << (tlog + 1)) + j;
      const int i1 = i0 + (1 << tlog);
      const uint32_t u = s[i0];
      const uint32_t v = shoup_mul(s[i1], __ldg(w + m + i), __ldg(ws + m + i), q);
      s[i0] = add_mod(u, v, q);
      s[i1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse stages (no N^-1 scale).  w/ws: the plan's inv_w/inv_ws tables.
// Stage s pairs (i*2t + j, i*2t + j + t), t = 2^s, with twiddle
// w[(N >> (s+1)) + i]: fhe_tpu/math/ntt.py inverse_butterfly.
__device__ __forceinline__ void ntt_inv_stages(uint32_t* s, int npolys, int N, int logN,
                                               const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ ws,
                                               uint32_t q) {
  const int half_log = logN - 1;
  const int total = npolys << half_log;
  for (int st = 0; st < logN; ++st) {
    const int h = N >> (st + 1);
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int p = k >> half_log;
      const int kk = k & ((1 << half_log) - 1);
      const int i = kk >> st;
      const int j = kk & ((1 << st) - 1);
      const int i0 = p * N + (i << (st + 1)) + j;
      const int i1 = i0 + (1 << st);
      const uint32_t u = s[i0];
      const uint32_t v = s[i1];
      s[i0] = add_mod(u, v, q);
      s[i1] = shoup_mul(sub_mod(u, v, q), __ldg(w + h + i), __ldg(ws + h + i), q);
    }
    __syncthreads();
  }
}

// Threads per block for an N-point transform: one butterfly per thread
// per stage, at most 512 threads (larger N loop).
inline int ntt_threads(int N) { return N / 2 < 512 ? N / 2 : 512; }

// log2 of a power of two (host; the NTT and blind-rotation entry points).
inline int log2_int(int N) {
  int l = 0;
  while ((1 << l) < N) ++l;
  return l;
}

}  // namespace fhe
