"""PKE parameter generation (CKKS/BGV/BFV over 32-bit RNS limbs): port of
fhe_tpu/pke/params.py, host code giving the same chains.

The reference generates moduli chains of up to 60-bit primes
(ckksrns-parametergeneration.cpp); fhe_tpu, and so the port, keeps every
limb below 2^31, so scaling factors are <= 2^28 per limb -- the regime the
reference calls COMPOSITESCALING for 32-bit words
(src/pke/unittest/utckksrns/UnitTestCKKSrnsCompositeScaling*.cpp).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import math

from ..math import primes
from ..lattice import stdparams


@dataclasses.dataclass(frozen=True)
class PkeParams:
    """Common RNS parameters. moduli = (q_0, ..., q_L); special_mods = P."""
    scheme: str
    N: int
    moduli: tuple          # full Q chain (level L = len-1)
    special_mods: tuple    # P extension primes (HYBRID key switching)
    num_part_q: int        # dnum: digits in hybrid decomposition
    scale_bits: int        # log2 of CKKS scaling factor / unused for BGV/BFV
    plain_mod: int = 0     # t for BGV/BFV
    std_dev: float = 3.19
    # CKKS composite scaling (reference: COMPOSITESCALINGAUTO for 32-bit
    # words, UnitTestCKKSrnsCompositeScaling*): one rescale drops
    # composite_degree limbs whose product is ~2^scale_bits.
    composite_degree: int = 1

    @property
    def L(self) -> int:
        return len(self.moduli)

    @property
    def num_per_part(self) -> int:
        return -(-self.L // self.num_part_q)

    def q_chain(self, level: int) -> tuple:
        """Moduli at a given number of remaining limbs."""
        return self.moduli[:level]


def _chain(bits_first: int, bits_rest: int, two_n: int, count: int,
           avoid=()) -> list[int]:
    out = []
    q = (1 << bits_first) - 1
    bits = bits_first
    while len(out) < count:
        p = primes.prev_prime_congruent(q, two_n)
        if p not in avoid:
            out.append(p)
        q = p - 1
        if len(out) == 1:
            q = (1 << bits_rest) - 1
        if p.bit_length() < bits_rest - 2:
            raise ValueError("prime chain exhausted")
    return out


def _alternating_primes(center_bits: int, count: int, two_n: int,
                        avoid: set) -> list[int]:
    """Primes = 1 mod 2N alternating above/below 2^center_bits, so the
    running product of any consecutive block stays centered."""
    out = []
    up = (1 << center_bits) + 1
    down = (1 << center_bits) + 1
    while len(out) < count:
        up = primes.next_prime_congruent(up + 1, two_n)
        if up not in avoid and up not in out:
            out.append(up)
        if len(out) >= count:
            break
        down = primes.prev_prime_congruent(down - 1, two_n)
        if down not in avoid and down not in out:
            out.append(down)
    return out[:count]


def _tracked_chain(scale_bits: int, cd: int, num_levels: int, two_n: int,
                   used: set) -> list[int]:
    """The level blocks of a chain whose FLEXIBLEAUTO scales stay near
    2^scale_bits: from the top down, each block's product is the closest
    a pair search finds to the scale it divides (S_{l-1} = S_l^2 / block),
    so an error in one block is corrected by the next instead of squared
    at every level.  Primes = 1 mod 2N within 3 bits of scale_bits / cd
    (below 2^30); cd - 2 primes near S^(1/cd), then the best pair (at cd
    = 1 the prime nearest S).
    Returned bottom level first, as the chain stores them."""
    width = scale_bits // cd
    lo = max(two_n + 1, 1 << (width - 3))
    hi = min(1 << (width + 3), 1 << 30)
    pool = sorted(q for q in range(lo // two_n * two_n + 1, hi, two_n)
                  if q >= lo and q not in used and primes.is_prime(q))
    log2 = math.log2
    target = float(scale_bits)                  # log2 of the running scale
    blocks = []
    for _ in range(num_levels):
        block = []
        for _ in range(cd - 2 if cd > 1 else 1):
            block.append(min(pool, key=lambda c: abs(log2(c) - target / cd)))
            pool.remove(block[-1])
        if cd > 1:
            rest = target - sum(log2(q) for q in block)
            logs = [log2(q) for q in pool]
            pairs = ((abs(la + logs[k] - rest), i, k) for i, la in enumerate(logs)
                     for k in (bisect.bisect_left(logs, rest - la) - 1,
                               bisect.bisect_left(logs, rest - la))
                     if 0 <= k < len(pool) and k != i)
            _, i, k = min(pairs, default=(None, None, None))
            if i is None:
                raise ValueError("prime chain exhausted")
            block += [pool[i], pool[k]]
            for q in block[-2:]:
                pool.remove(q)
        blocks.append(block)
        target = 2 * target - sum(log2(q) for q in block)
    return [q for block in reversed(blocks) for q in block]


@functools.lru_cache(maxsize=None)
def make_ckks_params(N: int = 1 << 13, num_levels: int = 8,
                     scale_bits: int = 28, first_bits: int = 30,
                     dnum: int = 3, num_special: int | None = None,
                     composite_degree: int = 1,
                     security: str = "not_set",
                     track_scale: bool = False) -> PkeParams:
    """CKKS chain: q0 ~ 2^first_bits, q1..qL ~ 2^scale_bits (each = 1 mod
    2N so the negacyclic NTT exists), P of ~30-bit primes with |P| >=
    max part size (keyswitch-hybrid noise requirement).

    composite_degree d > 1 (COMPOSITESCALING, for 32-bit limb words):
    every rescale level is a block of d limbs of ~scale_bits/d bits whose
    product is ~2^scale_bits; q0 is likewise a d-limb block of
    ~first_bits/d bits.  Enables delta ~ 2^52 precision on uint32 RNS.

    track_scale (the port's own; fhe_tpu has no such option): the level
    blocks come from `_tracked_chain` instead of alternating around
    2^(scale_bits/d).  Where primes = 1 mod 2N are sparse at that width
    (26-bit limbs at N = 2^16 are ~2^21 apart), the alternating blocks
    miss 2^scale_bits by up to a few percent, and FLEXIBLEAUTO squares
    the miss at every level: at N = 2^16, 22 levels, the scale reaches
    2^562 twelve levels down.  The default gives fhe_tpu's chain."""
    two_n = 2 * N
    cd = composite_degree
    used: set = set()
    if cd == 1:
        q0_block = [primes.prev_prime_congruent((1 << first_bits) - 1, two_n)]
    else:
        q0_block = _alternating_primes(first_bits // cd, cd, two_n, used)
    used.update(q0_block)
    if track_scale:
        rest = _tracked_chain(scale_bits, cd, num_levels, two_n, used)
    else:
        rest = _alternating_primes(scale_bits // cd, num_levels * cd, two_n, used)
    used.update(rest)
    moduli = tuple(q0_block + rest)
    n_sp = num_special if num_special is not None else \
        -(-(len(moduli)) // dnum)
    sp = []
    q = (1 << 30) - 1
    while len(sp) < n_sp:
        p = primes.prev_prime_congruent(q, two_n)
        if p not in used:
            sp.append(p)
        q = p - 1
    stdparams.validate(moduli, N, security, "ternary", tuple(sp))
    return PkeParams(scheme="CKKS", N=N, moduli=moduli,
                     special_mods=tuple(sp), num_part_q=dnum,
                     scale_bits=scale_bits, composite_degree=cd)


@functools.lru_cache(maxsize=None)
def make_bgv_params(N: int = 1 << 13, num_levels: int = 4,
                    plain_mod: int = 65537, mod_bits: int = 28,
                    dnum: int = 3,
                    security: str = "not_set") -> PkeParams:
    """BGV chain: q_i = 1 mod 2N; the qL^-1 plaintext factor introduced by
    modulus reduction is tracked per-ciphertext (pt_scale) and removed at
    decryption, like the reference's FLEXIBLEAUTO BGV scaling."""
    two_n = 2 * N
    mods = []
    q = (1 << mod_bits) - 1
    while len(mods) < num_levels + 1:
        p = primes.prev_prime_congruent(q, two_n)
        if p % plain_mod != 0:
            mods.append(p)
        q = p - 1
    n_sp = -(-(len(mods)) // dnum)
    sp = []
    q = (1 << 30) - 1
    while len(sp) < n_sp:
        p = primes.prev_prime_congruent(q, two_n)
        if p not in mods and p % plain_mod != 0:
            sp.append(p)
        q = p - 1
    stdparams.validate(mods, N, security, "ternary", tuple(sp))
    return PkeParams(scheme="BGV", N=N, moduli=tuple(mods),
                     special_mods=tuple(sp), num_part_q=dnum,
                     scale_bits=0, plain_mod=plain_mod)


@functools.lru_cache(maxsize=None)
def make_bfv_params(N: int = 1 << 13, num_limbs: int = 4,
                    plain_mod: int = 65537, mod_bits: int = 28,
                    dnum: int = 2,
                    security: str = "not_set") -> PkeParams:
    two_n = 2 * N
    mods = []
    q = (1 << mod_bits) - 1
    while len(mods) < num_limbs:
        p = primes.prev_prime_congruent(q, two_n)
        mods.append(p)
        q = p - 1
    n_sp = -(-num_limbs // dnum)
    sp = []
    q = (1 << 30) - 1
    while len(sp) < n_sp:
        p = primes.prev_prime_congruent(q, two_n)
        if p not in mods:
            sp.append(p)
        q = p - 1
    stdparams.validate(mods, N, security, "ternary", tuple(sp))
    return PkeParams(scheme="BFV", N=N, moduli=tuple(mods),
                     special_mods=tuple(sp), num_part_q=dnum,
                     scale_bits=0, plain_mod=plain_mod)
