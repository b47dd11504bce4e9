"""Discrete Fourier transform over complex doubles, on the host.

Port of fhe_tpu/math/dft.py (reference semantics: the C++ reference's
DiscreteFourierTransform): plain forward/inverse plus the "special"
negacyclic embedding transforms (evaluation at the odd 2N-th roots of
unity, for Z[X]/(X^N+1)) behind `lattice/field2n.py`.  fhe_tpu does no
device work here; the port makes the same numpy float64 calls, so every
value is fhe_tpu's bit for bit."""

from __future__ import annotations

import functools

import numpy as np


def forward_transform(x: np.ndarray) -> np.ndarray:
    """Plain DFT (dftransform.h ForwardTransform)."""
    return np.fft.fft(np.asarray(x, dtype=np.complex128))


def inverse_transform(x: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.asarray(x, dtype=np.complex128))


@functools.lru_cache(maxsize=None)
def _special_tables(N: int):
    """Roots for the negacyclic embedding: zeta^(2k+1), zeta = e^(i*pi/N)."""
    k = np.arange(N)
    return np.exp(1j * np.pi * k / N)


def forward_special(coeffs: np.ndarray) -> np.ndarray:
    """Evaluate a real-coefficient poly at the odd 2N-th roots of unity
    (ForwardTransformSpecial): out[j] = sum_k c_k zeta^{k(2j+1)}.

    Via one length-N FFT after the zeta^k pre-twist (the e^{+2pi i jk/N}
    kernel is N * ifft)."""
    c = np.asarray(coeffs, dtype=np.complex128)
    N = c.shape[-1]
    return N * np.fft.ifft(c * _special_tables(N))


def inverse_special(vals: np.ndarray) -> np.ndarray:
    """Inverse of forward_special (InverseTransformSpecial)."""
    v = np.asarray(vals, dtype=np.complex128)
    N = v.shape[-1]
    return np.fft.fft(v) / N / _special_tables(N)
