"""Ring arithmetic: primes, modular arithmetic, negacyclic NTT, the
Bluestein and arbitrary-cyclotomic transforms (`ntt_arb`); host numpy:
function approximation (Chebyshev and Hermite coefficients), samplers,
the complex DFT and matrices over Z_q."""

from . import approx, dft, matrix, modmath, ntt, ntt_arb, primes, samplers

__all__ = ["approx", "dft", "matrix", "modmath", "ntt", "ntt_arb", "primes", "samplers"]
