"""Bluestein DFT + arbitrary-cyclotomic transform over Z_q.

Port of fhe_tpu/math/ntt_arb.py (reference semantics: the C++
reference's BluesteinFFTNat -- chirp multiply, padded linear convolution
on an auxiliary power-of-2 NTT, unchirp -- and
ChineseRemainderTransformArbNat: evaluate at the phi(m) primitive m-th
roots, inverse = full inverse DFT with zeros at the non-primitive spots
followed by reduction mod the cyclotomic polynomial Phi_m).

As in fhe_tpu, the padded linear convolution runs exactly over three
31-bit NTT primes (fhe_tpu's own: `_aux_primes(2L)` at its own length L)
on the power-of-2 negacyclic NTT (zero padding keeps every product degree
below L, so the wrap never fires), then a CRT on the host.  The NTTs are
`lattice.rns.negacyclic_product`'s: on a CUDA device kernels 1-2, one
limb-stacked launch each way where L >= 512, else the small-N kernels,
one launch each way a prime.  Every residue is fhe_tpu's, and the CRT of
residues in [0, P) is the integer Garner gives, so the outputs are
byte-equal.  The chirps, the CRT and the mod-Phi_m division stay exact on
the host (object ints), as in fhe_tpu.  Entry points run on the card
unless `device` names another.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from . import primes as primesmod


# ---------------------------------------------------------------------------
# cyclotomic polynomials (exact integer coefficients)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cyclotomic_poly(m: int) -> tuple[int, ...]:
    """Coefficients of Phi_m(X), constant term first (exact ints)."""
    if m == 1:
        return (-1, 1)
    # X^m - 1 = prod_{d | m} Phi_d  =>  Phi_m = (X^m - 1) / prod_{d<m} Phi_d
    num = [0] * (m + 1)
    num[0] = -1
    num[m] = 1
    for d in range(1, m):
        if m % d == 0:
            den = cyclotomic_poly(d)
            num = _polydiv_exact(num, den)
    return tuple(num)


def _polydiv_exact(num: list[int], den: tuple[int, ...]) -> list[int]:
    """Exact division of integer polynomials (den monic up to +-1)."""
    num = list(num)
    dn = len(den) - 1
    lead = den[-1]
    out = [0] * (len(num) - dn)
    for i in range(len(num) - 1, dn - 1, -1):
        c = num[i] // lead
        out[i - dn] = c
        if c:
            for j, dj in enumerate(den):
                num[i - dn + j] -= c * dj
    if any(v != 0 for v in num):
        raise ArithmeticError("non-exact cyclotomic division")
    return out


def totient_indices(m: int) -> np.ndarray:
    """Ascending j in [1, m) with gcd(j, m) = 1."""
    return np.array([j for j in range(1, m) if math.gcd(j, m) == 1],
                    dtype=np.int64)


# ---------------------------------------------------------------------------
# exact linear convolution via a 3-prime CRT stack on the pow2 pipeline
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _aux_primes(two_L: int) -> tuple[int, ...]:
    return tuple(primesmod.generate_ntt_primes(31, two_L, 3))


def _exact_linconv(a: np.ndarray, b: np.ndarray, device="cuda") -> np.ndarray:
    """Exact integer linear convolution of nonneg int arrays (entries
    < 2^32), via negacyclic pow2 NTTs mod three 31-bit primes + CRT.
    Returns dtype=object (exact)."""
    from ..lattice import rns
    L = 1 << (len(a) + len(b) - 2).bit_length()
    aa = np.zeros(L, dtype=object)
    bb = np.zeros(L, dtype=object)
    aa[:len(a)] = np.asarray(a, dtype=object)
    bb[:len(b)] = np.asarray(b, dtype=object)
    x = rns.negacyclic_product(aa, bb, _aux_primes(2 * L), device)
    return x[:len(a) + len(b) - 1]


# ---------------------------------------------------------------------------
# Bluestein DFT mod q (any length m)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BluesteinPlan:
    m: int
    q: int
    psi: int                  # primitive 2m-th root mod q
    chirp: np.ndarray         # psi^{k^2 mod 2m}          [m]
    chirp_inv: np.ndarray     # psi^{-k^2 mod 2m}         [m]
    vker: np.ndarray          # chirp_inv[|t|], t=-(m-1)..(m-1)  [2m-1]
    vker_f: np.ndarray        # chirp[|t|]                       [2m-1]
    m_inv: int


@functools.lru_cache(maxsize=None)
def bluestein_plan(m: int, q: int) -> BluesteinPlan:
    if (q - 1) % (2 * m):
        raise ValueError(f"q={q} has no primitive 2m-th root (m={m})")
    psi = primesmod.root_of_unity(2 * m, q)
    k = np.arange(m, dtype=np.int64)
    e = (k * k) % (2 * m)
    chirp = np.array([pow(psi, int(t), q) for t in e], dtype=object)
    psi_inv = pow(psi, -1, q)
    chirp_inv = np.array([pow(psi_inv, int(t), q) for t in e], dtype=object)
    t = np.abs(np.arange(-(m - 1), m))
    return BluesteinPlan(m, q, psi, chirp, chirp_inv,
                         chirp_inv[t], chirp[t], pow(m, -1, q))


def bluestein_dft(x: np.ndarray, m: int, q: int,
                  inverse: bool = False, device="cuda") -> np.ndarray:
    """X_j = sum_k x_k w^{jk} mod q with w = psi^2 (order m); inverse
    evaluates at w^{-1} and scales by m^{-1}.  x: int array length m."""
    pl = bluestein_plan(m, q)
    x = np.asarray(x, dtype=object) % q
    if not inverse:
        u = (x * pl.chirp) % q
        w = _exact_linconv(u, pl.vker, device)
        out = (w[m - 1:2 * m - 1] % q) * pl.chirp % q
    else:
        u = (x * pl.chirp_inv) % q
        w = _exact_linconv(u, pl.vker_f, device)
        out = (w[m - 1:2 * m - 1] % q) * pl.chirp_inv % q
        out = out * pl.m_inv % q
    return out.astype(np.int64)


# ---------------------------------------------------------------------------
# arbitrary-cyclotomic ring transform (Z_q[X] / Phi_m(X))
# ---------------------------------------------------------------------------

def forward_arb(poly, m: int, q: int, device="cuda") -> np.ndarray:
    """Evaluate poly (len <= m, coefficients mod q) at the phi(m)
    primitive m-th roots w^j (gcd(j, m) = 1, ascending j) --
    ChineseRemainderTransformArbNat::ForwardTransform semantics."""
    x = np.zeros(m, dtype=np.int64)
    p = np.asarray(poly, dtype=np.int64) % q
    x[:len(p)] = p
    return bluestein_dft(x, m, q, device=device)[totient_indices(m)]


def inverse_arb(vals, m: int, q: int, device="cuda") -> np.ndarray:
    """Interpolate phi(m) primitive-root evaluations back to the unique
    representative of degree < phi(m) mod (Phi_m, q).  The full inverse
    DFT with zeros at non-primitive spots yields a degree-<m polynomial
    with the right primitive-root values; reducing mod Phi_m (which only
    constrains primitive-root behaviour) gives the interpolant."""
    idx = totient_indices(m)
    spec = np.zeros(m, dtype=np.int64)
    spec[idx] = np.asarray(vals, dtype=np.int64) % q
    r = bluestein_dft(spec, m, q, inverse=True, device=device)
    return _poly_mod_cyclo(r, m, q)


def _poly_mod_cyclo(r: np.ndarray, m: int, q: int) -> np.ndarray:
    phi = cyclotomic_poly(m)
    n = len(phi) - 1                       # = totient(m)
    c = [int(v) % q for v in r]
    for i in range(len(c) - 1, n - 1, -1):
        t = c[i]
        if t:
            for j in range(n + 1):
                c[i - n + j] = (c[i - n + j] - t * phi[j]) % q
    return np.array(c[:n], dtype=np.int64)


def multiply_arb(a, b, m: int, q: int, device="cuda") -> np.ndarray:
    """a * b mod (Phi_m(X), q) via pointwise multiplication in the
    primitive-root CRT basis."""
    fa = forward_arb(a, m, q, device).astype(object)
    fb = forward_arb(b, m, q, device).astype(object)
    return inverse_arb((fa * fb) % q, m, q, device)
