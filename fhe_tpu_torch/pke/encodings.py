"""Coefficient-packed and string plaintext encodings: a copy of
fhe_tpu/pke/encodings.py (host numpy code; the port imports nothing of
fhe_tpu).

Reference semantics: src/pke/include/encoding/coefpackedencoding.h
(integers placed directly into polynomial coefficients, signed values
balanced around 0 mod t) and encoding/stringencoding.h (one byte per
coefficient, t = 256).  The packed/CKKS encodings live with their
schemes (bgv.encode slot packing, ckks canonical embedding); these two
are scheme-agnostic coefficient encoders usable with BGV and BFV
contexts via make_plaintext(..., encoding=...).

Coefficient packing supports homomorphic add/sub slot-wise on
coefficients; multiplication acts as negacyclic convolution (the
reference documents the same restriction).
"""

from __future__ import annotations

import numpy as np


def encode_coef_packed(values, t: int, N: int) -> np.ndarray:
    """Signed/unsigned ints -> coefficient vector mod t (zero-padded)."""
    v = np.asarray(values, dtype=np.int64).reshape(-1)
    if v.size > N:
        raise ValueError(f"{v.size} values exceed ring dimension {N}")
    half = t // 2
    if v.min(initial=0) < -half or v.max(initial=0) >= t:
        raise ValueError("values out of plaintext range")
    out = np.zeros(N, dtype=np.int64)
    out[: v.size] = v % t
    return out


def decode_coef_packed(coeffs, t: int, length: int | None = None,
                       signed: bool = True) -> np.ndarray:
    """Coefficient vector mod t -> ints; balanced lift when signed."""
    c = np.asarray(coeffs, dtype=np.int64) % t
    if signed:
        c = np.where(c > t // 2, c - t, c)
    return c[:length] if length is not None else c


def encode_string(s: str | bytes, N: int, t: int = 256) -> np.ndarray:
    """One byte per coefficient (stringencoding.h; requires t = 256)."""
    if t != 256:
        raise ValueError("string encoding requires plaintext modulus 256")
    raw = s.encode("utf-8") if isinstance(s, str) else bytes(s)
    if len(raw) > N:
        raise ValueError(f"string of {len(raw)} bytes exceeds ring dim {N}")
    out = np.zeros(N, dtype=np.int64)
    out[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return out


def decode_string(coeffs, t: int = 256) -> str:
    if t != 256:
        raise ValueError("string encoding requires plaintext modulus 256")
    c = (np.asarray(coeffs, dtype=np.int64) % t).astype(np.uint8)
    raw = bytes(c.tobytes())
    return raw.rstrip(b"\x00").decode("utf-8", errors="replace")
