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


def barrett_reduce_u32(x, q) -> torch.Tensor:
    """x mod q for any uint32 word x (int32 bit patterns read as unsigned):
    the value fhe_tpu's Barrett reduction (mu = floor(2^32 / q)) returns.
    q an int or a tensor of moduli broadcast against x."""
    return (_i64(x) & 0xFFFFFFFF) % q


_MASK31 = (1 << 31) - 1


def fraction_round_v(y, mods: tuple, centered: bool = False) -> torch.Tensor:
    """v = floor(sum_i y[..., i, :] / q_i) (centered=False, lifting the
    representative in [0, Q)) or its round (centered=True, lifting the
    one in [-Q/2, Q/2)): the HPS correction of the exact CRT basis switch,
    int64 [..., N].

    The same integers as fhe_tpu's 96-bit accumulation: 1/q_i is the
    truncated reciprocal mu_i = floor(2^62 / q_i), v = floor((sum_i y_i
    mu_i [+ 2^61]) / 2^62).  A float estimate, or the true floor of
    sum y_i / q_i, differs where the sum lies near a half.  Here mu_i is
    split at bit 31 (mu_i = a_i 2^31 + b_i), each y_i b_i < 2^62 at bit 31
    again, and the sum is carried as hi 2^31 + lo, both far from 2^63 for
    up to 2^31 limbs of y_i < 2^31."""
    y = _i64(y)
    hi = torch.zeros(y.shape[:-2] + y.shape[-1:], dtype=torch.int64, device=y.device)
    lo = torch.zeros_like(hi)
    for i, q in enumerate(mods):
        mu = (1 << 62) // int(q)
        yi = y[..., i, :]
        p = yi * (mu & _MASK31)
        lo += p & _MASK31
        hi += (p >> 31) + yi * (mu >> 31)
    if centered:
        hi += 1 << 30                 # 2^61 = 2^30 * 2^31
    return (hi + (lo >> 31)) >> 31
