"""HE-standard lattice security tables (port of fhe_tpu/lattice/stdparams.py,
host code, copied so that the port imports nothing of fhe_tpu).

The numeric tables of the reference's
src/core/lib/lattice/stdlatticeparms.cpp:120-263 (themselves from the
HomomorphicEncryption.org security standard): for each (secret
distribution, ring dimension, security level) the MAXIMUM log2(Q) that
still meets the level.

Used to validate PKE parameter chains (`pke.params`)."""

from __future__ import annotations

import enum
import math


class SecurityLevel(enum.Enum):
    HEStd_128_classic = "128_classic"
    HEStd_192_classic = "192_classic"
    HEStd_256_classic = "256_classic"
    HEStd_128_quantum = "128_quantum"
    HEStd_192_quantum = "192_quantum"
    HEStd_256_quantum = "256_quantum"
    HEStd_NotSet = "not_set"


class DistType(enum.Enum):
    UNIFORM = "uniform"
    ERROR = "error"
    TERNARY = "ternary"


# (dist, ring_dim, level) -> max log2(Q); stdlatticeparms.cpp:120-263
_C, _Q = "classic", "quantum"
_TABLE: dict[tuple[str, int, str], int] = {}


def _load(dist: str, kind: str, rows: list[tuple[int, int, int, int]]):
    for n, a, b, c in rows:
        _TABLE[(dist, n, f"128_{kind}")] = a
        _TABLE[(dist, n, f"192_{kind}")] = b
        _TABLE[(dist, n, f"256_{kind}")] = c


_load("uniform", _C, [(1024, 29, 21, 16), (2048, 56, 39, 31),
                      (4096, 111, 77, 60), (8192, 220, 154, 120),
                      (16384, 440, 307, 239), (32768, 880, 612, 478)])
_load("error", _C, [(1024, 29, 21, 16), (2048, 56, 39, 31),
                    (4096, 111, 77, 60), (8192, 220, 154, 120),
                    (16384, 440, 307, 239), (32768, 883, 613, 478),
                    (65536, 1749, 1201, 931), (131072, 3525, 2413, 1868)])
_load("ternary", _C, [(1024, 27, 19, 14), (2048, 54, 37, 29),
                      (4096, 109, 75, 58), (8192, 218, 152, 118),
                      (16384, 438, 305, 237), (32768, 881, 611, 476),
                      (65536, 1747, 1199, 929), (131072, 3523, 2411, 1866)])
_load("uniform", _Q, [(1024, 27, 19, 15), (2048, 53, 37, 29),
                      (4096, 103, 72, 56), (8192, 206, 143, 111),
                      (16384, 413, 286, 222), (32768, 829, 573, 445)])
_load("error", _Q, [(1024, 27, 19, 15), (2048, 53, 37, 29),
                    (4096, 103, 72, 56), (8192, 206, 143, 111),
                    (16384, 413, 286, 222), (32768, 829, 573, 445),
                    (65536, 1665, 1147, 890), (131072, 3351, 2304, 1786)])
_load("ternary", _Q, [(1024, 25, 17, 13), (2048, 51, 35, 27),
                      (4096, 101, 70, 54), (8192, 202, 141, 109),
                      (16384, 411, 284, 220), (32768, 827, 571, 443),
                      (65536, 1663, 1145, 888), (131072, 3348, 2301, 1784)])


def max_log_q(ring_dim: int, level: SecurityLevel | str,
              dist: DistType | str = DistType.TERNARY) -> int:
    """Max log2(Q) for (ring_dim, level, dist); 0 if unlisted
    (StdLatticeParm::FindMaxQ semantics)."""
    lv = level.value if isinstance(level, SecurityLevel) else level
    dv = dist.value if isinstance(dist, DistType) else dist
    return _TABLE.get((dv, ring_dim, lv), 0)


def min_ring_dim(log_q: float, level: SecurityLevel | str,
                 dist: DistType | str = DistType.TERNARY) -> int:
    """Smallest listed ring dimension supporting log2(Q) at the level
    (StdLatticeParm::FindRingDim semantics)."""
    lv = level.value if isinstance(level, SecurityLevel) else level
    dv = dist.value if isinstance(dist, DistType) else dist
    dims = sorted(n for (d, n, l) in _TABLE if d == dv and l == lv)
    for n in dims:
        if _TABLE[(dv, n, lv)] >= log_q:
            return n
    raise ValueError(f"no standard ring dimension supports "
                     f"log2(Q)={log_q} at {lv}/{dv}")


def validate(moduli, N: int, level: SecurityLevel | str,
             dist: DistType | str = DistType.TERNARY,
             special_moduli=()) -> None:
    """Raise if the full modulus (incl. key-switch extension P) exceeds
    the standard's bound for (N, level, dist) -- the reference's
    parameter-generation security check."""
    if (isinstance(level, SecurityLevel) and
            level == SecurityLevel.HEStd_NotSet) or level == "not_set":
        return
    log_q = sum(math.log2(q) for q in tuple(moduli) + tuple(special_moduli))
    bound = max_log_q(N, level, dist)
    if bound == 0:
        raise ValueError(f"ring dimension {N} not in the HE standard "
                         f"tables for {level}")
    if log_q > bound:
        raise ValueError(
            f"log2(Q*P) = {log_q:.1f} exceeds the HE-standard bound "
            f"{bound} for N={N} at {level} ({dist}); increase N or "
            f"shrink the modulus chain")
