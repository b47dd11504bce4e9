"""Distribution generators on the host: discrete Gaussians (exact CDT,
rounded, Peikert convolution), ternary, discrete uniform, binary.

Port of fhe_tpu/math/samplers.py (reference semantics: the C++
reference's discretegaussiangenerator, discretegaussiangeneratorgeneric,
ternaryuniformgenerator, discreteuniformgenerator and
binaryuniformgenerator).  fhe_tpu draws these on the host with numpy;
the port makes the same numpy calls in the same order, so one
`np.random.Generator` seed gives byte-identical samples.  The exact
sampler is a 128-bit cumulative table (CDT), statistically within 2^-128
of the true discrete Gaussian."""

from __future__ import annotations

import functools
import math

import numpy as np

KARNEY_TAIL = 12.0       # tail cut in sigmas for table construction


@functools.lru_cache(maxsize=None)
def _cdt_table(sigma: float) -> tuple[np.ndarray, np.ndarray, int]:
    """128-bit CDF of the centered discrete Gaussian, split into two
    uint64 words per entry for vectorized comparison."""
    bound = int(math.ceil(KARNEY_TAIL * sigma)) + 1
    xs = np.arange(-bound, bound + 1)
    # exact-enough weights via mpmath-free big-int scaling of exp
    ws = [math.exp(-(float(x) ** 2) / (2.0 * sigma * sigma)) for x in xs]
    tot = sum(ws)
    cum = 0.0
    hi = np.zeros(len(xs), dtype=np.uint64)
    lo = np.zeros(len(xs), dtype=np.uint64)
    scale = 1 << 128
    acc = 0
    for i, w in enumerate(ws):
        acc += int(w / tot * scale)
        acc = min(acc, scale - 1)
        hi[i] = acc >> 64
        lo[i] = acc & ((1 << 64) - 1)
    hi[-1] = (scale - 1) >> 64
    lo[-1] = (scale - 1) & ((1 << 64) - 1)
    return hi, lo, bound


def discrete_gaussian_cdt(rng: np.random.Generator, sigma: float,
                          size) -> np.ndarray:
    """Exact-table discrete Gaussian (the reference's
    GenerateIntVector exact path)."""
    hi, lo, bound = _cdt_table(sigma)
    n = int(np.prod(size)) if not isinstance(size, int) else size
    u_hi = rng.integers(0, 1 << 63, size=n, dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + rng.integers(0, 2, size=n).astype(
        np.uint64)
    u_lo = rng.integers(0, 1 << 63, size=n, dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + rng.integers(0, 2, size=n).astype(
        np.uint64)
    # index = first table entry with cdf >= u (lexicographic on (hi, lo))
    idx_hi = np.searchsorted(hi, u_hi, side="left")
    # refine ties on the hi word
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        j = idx_hi[i]
        while j < len(hi) and hi[j] == u_hi[i] and lo[j] < u_lo[i]:
            j += 1
        out[i] = j - bound
    return out.reshape(size)


def discrete_gaussian_rounded(rng: np.random.Generator, sigma: float,
                              size) -> np.ndarray:
    """Rounded continuous Gaussian (the reference's default/fast mode)."""
    return np.rint(rng.normal(0.0, sigma, size=size)).astype(np.int64)


def discrete_gaussian_peikert(rng: np.random.Generator, sigma: float,
                              size, base_sigma: float = 4.0) -> np.ndarray:
    """Peikert convolution: z = z1 + k*z2 with base samplers of small
    sigma (discretegaussiangeneratorgeneric.cpp's combination step);
    sigma^2 = base^2 (1 + k^2) -> k chosen from the target."""
    if sigma <= base_sigma * 1.5:
        return discrete_gaussian_cdt(rng, sigma, size)
    # exact variance split: sigma^2 = base^2 + k^2 * sigma2^2
    k = max(1, round(math.sqrt(sigma * sigma - base_sigma * base_sigma)
                     / base_sigma))
    sigma2 = math.sqrt(sigma * sigma - base_sigma * base_sigma) / k
    z1 = discrete_gaussian_cdt(rng, base_sigma, size)
    z2 = discrete_gaussian_cdt(rng, sigma2, size)
    return z1 + k * z2


def ternary_uniform(rng: np.random.Generator, size,
                    h: int | None = None) -> np.ndarray:
    """Uniform {-1,0,1} or sparse with Hamming weight h
    (ternaryuniformgenerator.h)."""
    if h is None:
        return rng.integers(-1, 2, size=size, dtype=np.int64)
    n = int(np.prod(size))
    s = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=h, replace=False)
    s[idx] = rng.choice(np.array([-1, 1]), size=h)
    return s.reshape(size)


def discrete_uniform(rng: np.random.Generator, q: int, size) -> np.ndarray:
    """Uniform in [0, q) (discreteuniformgenerator.h)."""
    return rng.integers(0, q, size=size, dtype=np.int64)


def binary_uniform(rng: np.random.Generator, size) -> np.ndarray:
    return rng.integers(0, 2, size=size, dtype=np.int64)
