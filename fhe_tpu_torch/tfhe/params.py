"""TFHE/FHEW parameter sets and derived crypto parameters.

Port of fhe_tpu/tfhe/params.py (host-only Python, carried over as is,
except that `make_params`, not `check_method_compatible`, is cached).
Numeric tables mirror the reference's named paramsets exactly
(src/binfhe/lib/binfhecontext.cpp:113-160 paramsMap and :181-196
derivation; enum src/binfhe/include/binfhe-constants.h:51-80) so that
ciphertext semantics are interchangeable.
The derivation logic (Q = last prime of `q_bits` bits congruent 1 mod 2N,
digitsG = ceil(logQ/log Bg), approximate gadget with first digit dropped)
follows binfhecontext.cpp:166-177 and rgsw-cryptoparameters.h:94.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import lru_cache

from ..math import primes

STD_DEV = 3.19


class Method(enum.Enum):
    AP = "AP"            # FHEW/DM digit-decomposed blind rotation
    GINX = "GINX"        # CGGI ternary-MUX blind rotation (default)
    LMKCDEY = "LMKCDEY"  # automorphism-based blind rotation


class KeyDist(enum.Enum):
    UNIFORM_TERNARY = "UNIFORM_TERNARY"
    GAUSSIAN = "GAUSSIAN"


class Gate(enum.IntEnum):
    """Gate order = index into the gate-constant table
    (rgsw-cryptoparameters.cpp PreCompute m_gateConst)."""
    OR = 0
    AND = 1
    NOR = 2
    NAND = 3
    XOR = 4
    XNOR = 5
    MAJORITY = 6
    AND3 = 7
    OR3 = 8
    AND4 = 9
    OR4 = 10
    XOR_FAST = 11
    XNOR_FAST = 12
    CMUX = 13


@dataclasses.dataclass(frozen=True)
class RawParams:
    """One row of the named-paramset table."""
    q_bits: int          # bits of ring modulus Q ("numberBits")
    cyc_order: int       # 2N
    n: int               # LWE dimension ("latticeParam")
    q: int               # LWE/gate modulus ("mod")
    q_ks: int            # key-switch modulus (0 = use Q)
    std_dev: float
    base_ks: int         # Bks
    base_g: int          # Bg, gadget base
    base_r: int          # Brk (AP refresh base)
    num_auto_keys: int   # LMKCDEY
    key_dist: KeyDist


_T = KeyDist.UNIFORM_TERNARY
_G = KeyDist.GAUSSIAN

# binfhecontext.cpp:113-160, verbatim numbers.
PARAM_SETS: dict[str, RawParams] = {
    "TOY":                 RawParams(27, 1024, 64, 512, 0, STD_DEV, 25, 512, 23, 9, _T),
    "MEDIUM":              RawParams(28, 2048, 422, 1024, 16384, STD_DEV, 128, 1024, 32, 10, _T),
    "STD128_AP":           RawParams(27, 2048, 503, 1024, 16384, STD_DEV, 32, 512, 32, 10, _T),
    "STD128":              RawParams(27, 2048, 503, 1024, 16384, STD_DEV, 32, 512, 32, 10, _T),
    "STD128_3":            RawParams(27, 2048, 595, 1024, 65536, STD_DEV, 64, 128, 32, 10, _T),
    "STD128_4":            RawParams(27, 2048, 595, 2048, 65536, STD_DEV, 64, 128, 64, 10, _T),
    "STD128Q":             RawParams(25, 2048, 534, 1024, 16384, STD_DEV, 32, 128, 32, 10, _T),
    "STD128Q_3":           RawParams(50, 4096, 600, 2048, 32768, STD_DEV, 32, 33554432, 64, 10, _T),
    "STD128Q_4":           RawParams(50, 4096, 641, 2048, 65536, STD_DEV, 64, 33554432, 64, 10, _T),
    "STD192":              RawParams(37, 4096, 790, 2048, 16384, STD_DEV, 32, 524288, 64, 10, _T),
    "STD192_3":            RawParams(37, 4096, 875, 4096, 65536, STD_DEV, 64, 524288, 64, 10, _T),
    "STD192_4":            RawParams(37, 4096, 875, 4096, 65536, STD_DEV, 64, 8192, 64, 10, _T),
    "STD192Q":             RawParams(35, 4096, 875, 1024, 32768, STD_DEV, 32, 4096, 32, 10, _T),
    "STD192Q_3":           RawParams(34, 4096, 922, 2048, 65536, STD_DEV, 16, 4096, 64, 10, _T),
    "STD192Q_4":           RawParams(34, 4096, 980, 2048, 131072, STD_DEV, 16, 4096, 64, 10, _T),
    "STD256":              RawParams(29, 4096, 1076, 2048, 32768, STD_DEV, 32, 1024, 64, 10, _T),
    "STD256_3":            RawParams(29, 4096, 1145, 2048, 65536, STD_DEV, 64, 256, 64, 10, _T),
    "STD256_4":            RawParams(29, 4096, 1145, 4096, 65536, STD_DEV, 64, 256, 64, 10, _T),
    "STD256Q":             RawParams(27, 4096, 1225, 1024, 65536, STD_DEV, 16, 128, 32, 10, _T),
    "STD256Q_3":           RawParams(27, 4096, 1400, 4096, 65536, STD_DEV, 21, 64, 64, 10, _T),
    "STD256Q_4":           RawParams(27, 4096, 1625, 4096, 2097152, STD_DEV, 16, 64, 64, 10, _T),
    "STD128_LMKCDEY":      RawParams(28, 2048, 447, 2048, 16384, STD_DEV, 32, 1024, 64, 10, _G),
    "STD128_3_LMKCDEY":    RawParams(27, 2048, 556, 2048, 32768, STD_DEV, 32, 512, 64, 10, _T),
    "STD128_4_LMKCDEY":    RawParams(27, 2048, 595, 2048, 65536, STD_DEV, 64, 128, 64, 10, _T),
    "STD128Q_LMKCDEY":     RawParams(27, 2048, 483, 2048, 16384, STD_DEV, 32, 512, 64, 10, _G),
    "STD128Q_3_LMKCDEY":   RawParams(25, 2048, 643, 2048, 65536, STD_DEV, 64, 128, 64, 10, _T),
    "STD128Q_4_LMKCDEY":   RawParams(50, 4096, 641, 4096, 65536, STD_DEV, 64, 33554432, 64, 10, _T),
    "STD192_LMKCDEY":      RawParams(39, 4096, 716, 2048, 32768, STD_DEV, 32, 1048576, 64, 10, _G),
    "STD192_3_LMKCDEY":    RawParams(39, 4096, 771, 4096, 65536, STD_DEV, 64, 1048576, 64, 10, _G),
    "STD192_4_LMKCDEY":    RawParams(37, 4096, 875, 4096, 65536, STD_DEV, 64, 8192, 64, 10, _T),
    "STD192Q_LMKCDEY":     RawParams(36, 4096, 776, 4096, 32768, STD_DEV, 32, 262144, 64, 10, _G),
    "STD192Q_3_LMKCDEY":   RawParams(36, 4096, 834, 4096, 65536, STD_DEV, 64, 4096, 64, 10, _G),
    "STD192Q_4_LMKCDEY":   RawParams(34, 4096, 949, 4096, 65536, STD_DEV, 64, 4096, 64, 10, _T),
    "STD256_LMKCDEY":      RawParams(30, 4096, 939, 2048, 32768, STD_DEV, 32, 1024, 64, 10, _G),
    "STD256_3_LMKCDEY":    RawParams(29, 4096, 1076, 4096, 32768, STD_DEV, 32, 256, 64, 10, _T),
    "STD256_4_LMKCDEY":    RawParams(29, 4096, 1145, 4096, 65536, STD_DEV, 64, 256, 64, 10, _T),
    "STD256Q_LMKCDEY":     RawParams(28, 4096, 1019, 4096, 32768, STD_DEV, 32, 1024, 64, 10, _G),
    "STD256Q_3_LMKCDEY":   RawParams(26, 4096, 1242, 4096, 65536, STD_DEV, 64, 128, 64, 10, _T),
    "STD256Q_4_LMKCDEY":   RawParams(26, 4096, 1320, 4096, 131072, STD_DEV, 64, 64, 64, 10, _T),
    "LPF_STD128":          RawParams(27, 2048, 556, 2048, 32768, STD_DEV, 32, 128, 64, 10, _T),
    "LPF_STD128Q":         RawParams(25, 2048, 645, 2048, 65536, STD_DEV, 64, 128, 64, 10, _T),
    "LPF_STD128_LMKCDEY":  RawParams(27, 2048, 556, 2048, 32768, STD_DEV, 32, 512, 64, 10, _T),
    "LPF_STD128Q_LMKCDEY": RawParams(25, 2048, 600, 2048, 32768, STD_DEV, 32, 128, 64, 10, _T),
    "SIGNED_MOD_TEST":     RawParams(28, 2048, 512, 1024, 0, STD_DEV, 25, 128, 23, 10, _T),
    # framework-local LMKCDEY test set: q = 2N (round-to-odd requirement),
    # TOY-sized n (insecure, CI-speed)
    "TOY_LMKCDEY":         RawParams(27, 1024, 64, 1024, 0, STD_DEV, 25, 512, 23, 9, _T),
    # framework-local 2-limb RNS ring test set (q_bits 34 > 30 forces the
    # rgsw_rns accumulator; insecure n, CI-speed)
    "TOY_RNS":             RawParams(34, 2048, 64, 1024, 16384, STD_DEV, 32, 131072, 32, 10, _T),
    # framework-local test set: q=8192 gives plaintext space 16 for the
    # radix/fhEVM 2+2-bit limbs with a q/(2p) = 256 decryption margin.
    # qKS = 2^20 keeps the dominant keyswitch noise sigma*sqrt(N*dc)*q/qKS
    # at ~4.5 in q units (the earlier qKS=2^17 at q=4096 left ~3 sigma of
    # margin and flipped limbs at LUT-step edges).  EvalFunc's 2q
    # accumulator needs 2q <= 4N: q = N here.  (insecure n, CI-speed;
    # production uses STD128_4 scaled the same way)
    # Bg=32 (digitsG=6): blind-rotate noise ~ sqrt(dG2*N)*Bg/2*sigma*
    # sqrt(2n)/(Q/q) ~ 10 q-units at N=8192 (Bg=512 gave ~100 -- above the
    # 256 margin at 2.5 sigma)
    "TOY_RADIX":           RawParams(27, 16384, 64, 8192, 1048576, STD_DEV, 32, 32, 32, 10, _T),
}


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """Fully derived parameter object (all static Python ints)."""
    name: str
    method: Method
    key_dist: KeyDist
    # ring
    N: int               # ring dimension
    Q: int               # ring modulus (NTT prime)
    # LWE
    n: int               # LWE dimension
    q: int               # gate modulus
    q_ks: int            # key-switch modulus
    std_dev: float
    # gadget (blind rotation)
    base_g: int
    digits_g: int        # ceil(logQ / log Bg)
    # key switch
    base_ks: int
    digits_ks: int       # ceil(log qKS / log Bks)
    # AP
    base_r: int
    digits_r: int
    # LMKCDEY
    num_auto_keys: int
    # 2-limb RNS ring modulus for q_bits > 30 (Q = prod(moduli_rns);
    # empty tuple = single-limb Q)
    moduli_rns: tuple = ()

    @property
    def digits_g2(self) -> int:
        """Digits per external product: approximate gadget drops the first
        digit of each of the 2 polys (rgsw-acc.cpp:63)."""
        return (self.digits_g - 1) * 2

    def gate_const(self, gate: Gate) -> int:
        """Linear-combination offset per gate, mod q
        (rgsw-cryptoparameters.cpp PreCompute m_gateConst)."""
        q = self.q
        table = {
            Gate.OR: 5 * (q >> 3), Gate.AND: 7 * (q >> 3),
            Gate.NOR: 1 * (q >> 3), Gate.NAND: 3 * (q >> 3),
            Gate.XOR: 6 * (q >> 3), Gate.XNOR: 2 * (q >> 3),
            Gate.MAJORITY: 7 * (q >> 3), Gate.AND3: 11 * (q // 12),
            Gate.OR3: 7 * (q // 12), Gate.AND4: 15 * (q >> 4),
            Gate.OR4: 9 * (q >> 4), Gate.XOR_FAST: 6 * (q >> 3),
            Gate.XNOR_FAST: 2 * (q >> 3),
        }
        return table[gate] % q


def check_method_compatible(method: Method, name: str) -> None:
    """isMethodCompatible (binfhe-constants-impl.cpp:266-330): LMKCDEY
    paramsets only run under the LMKCDEY method, and vice versa.  The
    reference throws on a mismatch; silently running GINX on an
    *_LMKCDEY set is worse than an error — the Gaussian-secret sets
    (e.g. STD128_LMKCDEY) would produce WRONG gates, because the GINX
    bootstrap key is a ternary two-column CMUX key that treats every
    |s_i| >= 2 coefficient as zero."""
    is_lmk_set = "LMKCDEY" in name
    # TOY/MEDIUM run under any method in the reference's compat table
    any_method = name in ("TOY", "MEDIUM")
    if method == Method.LMKCDEY:
        if not (is_lmk_set or any_method):
            raise ValueError(
                f"paramset {name} is incompatible with method LMKCDEY "
                "(binfhe-constants-impl.cpp:266 isMethodCompatible)")
    elif is_lmk_set:
        raise ValueError(
            f"paramset {name} is incompatible with method {method.value} "
            "(binfhe-constants-impl.cpp:296 isMethodCompatible); use "
            "method=LMKCDEY or omit method to auto-select it")


@lru_cache(maxsize=None)
def make_params(name: str, method: Method | None = None) -> TfheParams:
    """method=None auto-selects from the set name (*_LMKCDEY ->
    LMKCDEY, else GINX) — a deliberate usability improvement over the
    reference's default-GINX-then-throw; explicit mismatches still
    raise via check_method_compatible."""
    if method is None:
        method = Method.LMKCDEY if "LMKCDEY" in name else Method.GINX
    check_method_compatible(method, name)
    raw = PARAM_SETS[name]
    N = raw.cyc_order // 2
    moduli_rns = ()
    if raw.q_bits <= 30:
        Q = primes.last_prime(raw.q_bits, raw.cyc_order)
    else:
        # uint32 limbs cannot hold Q >= 2^31: use a 2-limb RNS ring with
        # Q = q1*q2 of ~q_bits total (the TPU-native analogue of the
        # reference's single 37..50-bit NativeInteger modulus)
        b1 = (raw.q_bits + 1) // 2
        b2 = raw.q_bits - b1 + 1
        q1 = primes.last_prime(min(b1, 30), raw.cyc_order)
        q2 = primes.last_prime(min(b2, 30), raw.cyc_order)
        if q2 == q1:
            q2 = primes.prev_prime_congruent(q1 - 1, raw.cyc_order)
        moduli_rns = (q1, q2)
        Q = q1 * q2
    q_ks = raw.q_ks if raw.q_ks != 0 else (Q if raw.q_bits <= 30 else
                                           1 << 27)
    digits_g = int(math.ceil(math.log(Q) / math.log(raw.base_g)))
    digits_ks = int(math.ceil(math.log(q_ks) / math.log(raw.base_ks)))
    digits_r = int(math.ceil(math.log(raw.q) / math.log(raw.base_r)))
    return TfheParams(
        name=name, method=method, key_dist=raw.key_dist,
        N=N, Q=Q, n=raw.n, q=raw.q, q_ks=q_ks, std_dev=raw.std_dev,
        base_g=raw.base_g, digits_g=digits_g,
        base_ks=raw.base_ks, digits_ks=digits_ks,
        base_r=raw.base_r, digits_r=digits_r,
        num_auto_keys=raw.num_auto_keys, moduli_rns=moduli_rns,
    )
