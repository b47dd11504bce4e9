"""Ring arithmetic: primes, modular arithmetic, negacyclic NTT; function
approximation (Chebyshev and Hermite coefficients, host numpy)."""

from . import approx, modmath, ntt, primes

__all__ = ["approx", "modmath", "ntt", "primes"]
