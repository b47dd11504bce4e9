"""Ring arithmetic: primes, modular arithmetic, negacyclic NTT."""

from . import modmath, ntt, primes

__all__ = ["modmath", "ntt", "primes"]
