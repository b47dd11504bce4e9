"""Dense matrices over Z_q with Strassen multiplication, on the host.

Port of fhe_tpu/math/matrix.py (reference semantics: the C++ reference's
Matrix<T> and its Strassen recursion).  Matrices are numpy uint64 arrays
over Z_q, q < 2^32, with exact modular arithmetic; Strassen recurses on
power-of-2 blocks above a cutoff and is exact (operands reduced mod q
before every level).  These stay on the host: CUDA has no 64-bit integer
matrix product, a 32-bit one would overflow at q^2, and fhe_tpu runs no
device work here either."""

from __future__ import annotations

import numpy as np

STRASSEN_CUTOFF = 64


def mat_mul_mod(A: np.ndarray, B: np.ndarray, q: int) -> np.ndarray:
    """Schoolbook A @ B mod q, exact for q < 2^32 (uint64 chunked sums)."""
    A = np.asarray(A, dtype=np.uint64) % np.uint64(q)
    B = np.asarray(B, dtype=np.uint64) % np.uint64(q)
    n, k = A.shape
    k2, m = B.shape
    if k != k2:
        raise ValueError(f"mat_mul_mod of [{n}, {k}] by [{k2}, {m}]")
    out = np.zeros((n, m), dtype=np.uint64)
    step = max(1, (1 << 63) // (q * q))     # terms before overflow risk
    for lo in range(0, k, step):
        part = (A[:, lo:lo + step] @ B[lo:lo + step, :])
        out = (out + part) % np.uint64(q)
    return out


def strassen_mul_mod(A: np.ndarray, B: np.ndarray, q: int) -> np.ndarray:
    """Strassen multiply mod q (matrixstrassen-impl.h): 7 recursive
    products on padded power-of-2 halves."""
    A = np.asarray(A, dtype=np.uint64) % np.uint64(q)
    B = np.asarray(B, dtype=np.uint64) % np.uint64(q)
    n, k = A.shape
    _, m = B.shape
    size = 1
    while size < max(n, k, m):
        size *= 2
    Ap = np.zeros((size, size), dtype=np.uint64)
    Bp = np.zeros((size, size), dtype=np.uint64)
    Ap[:n, :k] = A
    Bp[:k, :m] = B
    return _strassen(Ap, Bp, q)[:n, :m]


def _strassen(A, B, q):
    n = A.shape[0]
    if n <= STRASSEN_CUTOFF:
        return mat_mul_mod(A, B, q)
    h = n // 2
    qq = np.uint64(q)
    a11, a12, a21, a22 = A[:h, :h], A[:h, h:], A[h:, :h], A[h:, h:]
    b11, b12, b21, b22 = B[:h, :h], B[:h, h:], B[h:, :h], B[h:, h:]
    add = lambda x, y: (x + y) % qq
    sub = lambda x, y: (x + qq - y) % qq
    m1 = _strassen(add(a11, a22), add(b11, b22), q)
    m2 = _strassen(add(a21, a22), b11, q)
    m3 = _strassen(a11, sub(b12, b22), q)
    m4 = _strassen(a22, sub(b21, b11), q)
    m5 = _strassen(add(a11, a12), b22, q)
    m6 = _strassen(sub(a21, a11), add(b11, b12), q)
    m7 = _strassen(sub(a12, a22), add(b21, b22), q)
    C = np.zeros_like(A)
    C[:h, :h] = add(sub(add(m1, m4), m5), m7)
    C[:h, h:] = add(m3, m5)
    C[h:, :h] = add(m2, m4)
    C[h:, h:] = add(add(sub(m1, m2), m3), m6)
    return C
