"""Function-approximation coefficient generators.  Port of
fhe_tpu/math/approx.py (host numpy, copied: the port imports nothing of
fhe_tpu).

Reference semantics: the reference's math/chebyshev.h and chebyshev.cpp
(EvalChebyshevCoefficients: interpolation at Chebyshev nodes over [a, b])
and math/hermite.h (Hermite trigonometric interpolation).  Host-side double
precision; consumed by pke.advanced.eval_chebyshev_series*."""

from __future__ import annotations

import numpy as np


def chebyshev_coefficients(func, a: float, b: float, degree: int) -> list[float]:
    """Interpolation coefficients of func over [a, b] in the T_k basis
    (chebyshev.cpp EvalChebyshevCoefficients): c_k = 2/(d+1) *
    sum_j f(x_j) cos(k arccos t_j) at the Chebyshev nodes t_j, with the
    c_0 /= 2 normalization matching eval_chebyshev_series."""
    if degree < 1:
        raise ValueError(f"Chebyshev degree must be at least 1, got {degree}")
    n = degree + 1
    j = np.arange(n)
    t = np.cos(np.pi * (j + 0.5) / n)
    x = 0.5 * (b - a) * t + 0.5 * (b + a)
    fv = np.array([func(v) for v in x], dtype=np.float64)
    coeffs = [2.0 / n * float(np.sum(fv * np.cos(k * np.arccos(t)))) for k in range(n)]
    coeffs[0] /= 2
    return coeffs


def chebyshev_fit(func, a: float, b: float, tol: float = 1e-9,
                  max_degree: int = 2048) -> list[float]:
    """Smallest-degree Chebyshev interpolation meeting `tol` on a dense
    grid (the adaptive variant the bootstrap sine setup uses)."""
    grid = np.linspace(a, b, 4001)
    fg = np.array([func(v) for v in grid])
    deg = 4
    while deg <= max_degree:
        cs = chebyshev_coefficients(func, a, b, deg)
        y = 2.0 * (grid - a) / (b - a) - 1.0
        approx = np.polynomial.chebyshev.chebval(y, cs)
        if np.max(np.abs(approx - fg)) < tol:
            return cs
        deg = deg + max(4, deg // 4)
    raise ValueError("chebyshev_fit did not converge")


def hermite_trig_coefficients(fvals: np.ndarray) -> np.ndarray:
    """Trigonometric (Hermite) interpolation coefficients of samples on
    the uniform circle grid (math/hermite.h GetHermiteTrigCoefficients):
    the complex Fourier coefficients whose series evaluation reproduces
    the samples."""
    f = np.asarray(fvals, dtype=np.complex128)
    return np.fft.fft(f) / len(f)


def hermite_trig_eval(coeffs: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Evaluate sum_k c_k e^{i k theta}."""
    k = np.arange(len(coeffs))
    return np.asarray(coeffs) @ np.exp(1j * np.outer(k, theta))
