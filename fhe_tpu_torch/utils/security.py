"""Side-channel hardening: constant-time primitives and timing guards.

Port of fhe_tpu/utils/security.py (reference semantics: security/
constant_time.h:76-382, ct_select/ct_eq/ct_lt/ct_memcmp and constant-time
table lookups, and security/timing_guard.h:209-274, TimingGuard: a
busy-wait to a minimum duration so that secret-dependent fast paths are
masked; unit test UnitTestConstantTime.cpp).

The compute path on the card is data-oblivious by construction: its
kernels and tensor ops run the same instructions whatever the values
(selects are `torch.where`, a predicated select, and gathers read every
index the shape gives).  The helpers below are for the HOST-side control
plane (key management, serialization comparisons, protocol transcripts),
where the reference needs them too; `ct_select_vec` takes tensors on any
device as well as numpy arrays."""

from __future__ import annotations

import time

import numpy as np
import torch


# ---------------------------------------------------------------------------
# constant-time scalar/vector primitives (constant_time.h:76-220)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def ct_mask(bit: int) -> int:
    """0 -> 0, 1 -> all-ones (64-bit)."""
    return (-(bit & 1)) & _M64


def ct_select(cond_bit: int, a: int, b: int) -> int:
    """cond ? a : b without branching."""
    m = ct_mask(cond_bit)
    return ((a & m) | (b & ~m)) & _M64


def ct_eq(a: int, b: int) -> int:
    """1 if a == b else 0, branch-free (64-bit operands)."""
    x = (a ^ b) & _M64
    return 1 ^ (((x | (-x & _M64)) >> 63) & 1)


def ct_lt(a: int, b: int) -> int:
    """1 if a < b else 0, branch-free (unsigned 64-bit operands): the
    sign of the 65-bit difference."""
    return ((a & _M64) - (b & _M64)) >> 64 & 1


def ct_memcmp(a: bytes, b: bytes) -> int:
    """0 iff equal; runs in time dependent only on the lengths
    (constant_time.h ct_memcmp)."""
    if len(a) != len(b):
        return 1
    acc = 0
    for x, y in zip(a, b):
        acc |= x ^ y
    return 1 if acc else 0


def ct_table_lookup(table: np.ndarray, index: int) -> int:
    """Read table[index] touching EVERY entry (cache-timing safe;
    constant_time.h CtTableLookup)."""
    t = np.asarray(table, dtype=np.uint64)
    idx = np.arange(len(t), dtype=np.uint64)
    mask = np.where(idx == np.uint64(index), _M64, 0).astype(np.uint64)
    return int(np.bitwise_or.reduce(t & mask))


def ct_select_vec(cond, a, b):
    """Vectorized branch-free select: cond ? a : b elementwise, by masks.
    Tensors give a tensor (int64 words, on their device); numpy arrays a
    uint64 array, as fhe_tpu's."""
    if isinstance(cond, torch.Tensor):
        m = -(cond.to(torch.int64) & 1)          # 1 -> all ones, 0 -> zeros
        a = torch.as_tensor(a, device=cond.device).to(torch.int64)
        b = torch.as_tensor(b, device=cond.device).to(torch.int64)
        return (a & m) | (b & ~m)
    c = np.asarray(cond, dtype=np.uint64)
    m = (~(c - np.uint64(1))) & np.uint64(_M64)   # 1 -> ones, 0 -> zeros
    return (np.asarray(a, np.uint64) & m) | \
           (np.asarray(b, np.uint64) & ~m)


# ---------------------------------------------------------------------------
# TimingGuard (timing_guard.h:209-274)
# ---------------------------------------------------------------------------

class TimingGuard:
    """Context manager enforcing a minimum elapsed wall time, so callers
    cannot distinguish secret-dependent fast paths:

        with TimingGuard(min_ns=2_000_000):
            secret_dependent_work()
    """

    def __init__(self, min_ns: int):
        self.min_ns = int(min_ns)
        self.start = 0
        self.elapsed_ns = 0

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        target = self.start + self.min_ns
        # busy-wait (sleep released early would leak through scheduler
        # granularity; the reference busy-waits for the same reason,
        # timing_guard.h:233-260)
        while time.perf_counter_ns() < target:
            pass
        self.elapsed_ns = time.perf_counter_ns() - self.start
        return False
