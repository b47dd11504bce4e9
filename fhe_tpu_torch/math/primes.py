"""Host-side number theory: primality, NTT-friendly primes, roots of unity.

Pure-Python exact arithmetic; mirrors the roles of the reference's
src/core/include/math/nbtheory{-impl}.h (LastPrime/FirstPrime/RootOfUnity)
without copying its search strategy.  Used only at parameter/keygen time.
"""

from __future__ import annotations

from functools import lru_cache

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=None)
def last_prime(bits: int, m: int) -> int:
    """Largest prime q < 2^bits with q = 1 (mod m).

    Matches LastPrime<NativeInteger>(bits, cyclOrder) used by the reference
    binfhe context generator (src/binfhe/lib/binfhecontext.cpp:164).
    """
    q = ((1 << bits) - 2) // m * m + 1
    while q > m:
        if is_prime(q):
            return q
        q -= m
    raise ValueError(f"no prime of {bits} bits congruent to 1 mod {m}")


@lru_cache(maxsize=None)
def first_prime(bits: int, m: int) -> int:
    """Smallest prime q > 2^(bits-1) with q = 1 (mod m)."""
    q = ((1 << (bits - 1)) // m + 1) * m + 1
    while q < (1 << bits):
        if is_prime(q):
            return q
        q += m
    raise ValueError(f"no prime of {bits} bits congruent to 1 mod {m}")


def next_prime_congruent(start: int, m: int) -> int:
    """Smallest prime q >= start with q = 1 (mod m)."""
    q = (start - 2) // m * m + m + 1
    while True:
        if is_prime(q):
            return q
        q += m


def prev_prime_congruent(start: int, m: int) -> int:
    """Largest prime q <= start with q = 1 (mod m)."""
    q = (start - 1) // m * m + 1
    while q > m:
        if is_prime(q):
            return q
        q -= m
    raise ValueError("no prime found")


def ntt_primes(count: int, N: int, below: int) -> tuple[int, ...]:
    """`count` distinct NTT primes for ring degree N (q = 1 mod 2N), the
    largest below `below`, in descending order."""
    out, q = [], below
    while len(out) < count:
        q = prev_prime_congruent(q - 1, 2 * N)
        out.append(q)
    return tuple(out)


def _factorize(n: int) -> list[int]:
    fs = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return fs


@lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest generator of (Z/qZ)* for prime q."""
    phi = q - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


@lru_cache(maxsize=None)
def root_of_unity(order: int, q: int) -> int:
    """A primitive `order`-th root of unity mod prime q (order | q-1)."""
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide {q}-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    assert pow(w, order, q) == 1 and pow(w, order // 2, q) != 1
    return w


def generate_ntt_primes(bits: int, two_n: int, count: int) -> list[int]:
    """`count` distinct primes just below 2^bits, all = 1 (mod two_n).

    Used to build RNS moduli chains for the pke schemes (the TPU analogue of
    the reference's gpu_primes.h tables, regenerated rather than copied).
    """
    out = []
    q = (1 << bits) - 1
    while len(out) < count:
        p = prev_prime_congruent(q, two_n)
        out.append(p)
        q = p - 1
        if p.bit_length() < bits - 1:
            raise ValueError("ran out of primes at this bit size")
    return out
