"""Modular arithmetic on integer tensors (plain PyTorch versions).

Ports the function set of `fhe_tpu/math/modmath.py` that the gate path
uses.  Every modulus is below 2^31, so int64 holds any product of two
residues exactly: the functions here upcast to int64 and return int64
residues in [0, q).  Montgomery (R = 2^32) and Shoup products return the
canonical residue, which is the same value the uint32 word arithmetic of
the reference and of the CUDA kernels (`csrc/ntt.cuh`) produces, so any of
them gives byte-identical results.

Host-side constant helpers (`mont_constants`, `shoup_precompute`) use
Python ints and are exact.
"""

from __future__ import annotations

import torch

R_BITS = 32


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def add_mod(a, b, q: int) -> torch.Tensor:
    t = _i64(a) + _i64(b)
    return torch.where(t >= q, t - q, t)


def sub_mod(a, b, q: int) -> torch.Tensor:
    t = _i64(a) - _i64(b)
    return torch.where(t < 0, t + q, t)


def neg_mod(a, q: int) -> torch.Tensor:
    a = _i64(a)
    return torch.where(a == 0, a, q - a)


def mont_constants(q: int):
    """Host: (qinv_neg, r1, r2) = (-q^-1 mod 2^32, R mod q, R^2 mod q)."""
    q = int(q)
    if not (q % 2 == 1 and 2 < q < 2**31):
        raise ValueError(f"Montgomery modulus must be odd and < 2^31, got {q}")
    qinv = pow(q, -1, 1 << 32)
    qinv_neg = ((1 << 32) - qinv) & 0xFFFFFFFF
    r1 = (1 << 32) % q
    r2 = pow(1 << 32, 2, q)
    return qinv_neg, r1, r2


def mont_mul(a, b, q: int) -> torch.Tensor:
    """(a * b * R^-1) mod q with R = 2^32, for a, b in [0, q).

    If b is in Montgomery form (b = x*R mod q) the result is a*x mod q in
    plain form: keys are kept in Montgomery form and ciphertext data in
    plain form, so one REDC per EVAL-domain product suffices."""
    rinv = pow(1 << R_BITS, -1, q)
    return (_i64(a) * _i64(b)) % q * rinv % q


def to_mont(a, q: int) -> torch.Tensor:
    return _i64(a) * ((1 << R_BITS) % q) % q


def from_mont(a, q: int) -> torch.Tensor:
    return mont_mul(a, 1, q)


def shoup_precompute(w: int, q: int) -> int:
    """Host: w' = floor(w * 2^32 / q) for a Shoup product. Requires w < q < 2^31."""
    if not 0 <= w < q < 2**31:
        raise ValueError(f"Shoup constant needs 0 <= w < q < 2^31 (w={w}, q={q})")
    return (w << 32) // q


def shoup_mul(a, w, q: int) -> torch.Tensor:
    """a * w mod q, the value a Shoup product with (w, w') computes."""
    return _i64(a) * _i64(w) % q


def sum_mod(x, dim: int, q: int) -> torch.Tensor:
    """Sum of residues in [0, q) along `dim`, mod q (exact below 2^32 terms)."""
    return _i64(x).sum(dim=dim) % q


def round_scale_mod(v, num: int, den: int, out_mod: int) -> torch.Tensor:
    """floor(0.5 + v * num / den) mod out_mod, exactly.

    RoundqQ of the reference: v in [0, den), num < 2^31, den < 2^31, and
    floor(0.5 + x/den) == floor((2x + den) / (2 den)) for odd den too."""
    k = (2 * _i64(v) * num + den) // (2 * den)
    return torch.where(k >= out_mod, k - out_mod, k)
