"""Negacyclic NTT over 32-bit prime fields (port of fhe_tpu/math/ntt.py).

EVALUATION layout (canonical, natural order), as in fhe_tpu:
    eval[k] = a(psi^(2k+1)),  k = 0..N-1,  psi a primitive 2N-th root,
with psi = primes.root_of_unity(2N, q), the same root fhe_tpu picks: the
bootstrap key is stored in EVAL form, so every EVAL value depends on it.

`forward_butterfly` / `inverse_butterfly` are the plain PyTorch versions
(Cooley-Tukey / Gentleman-Sande stages, exact int64 arithmetic: each
butterfly's sum and difference reduced by one remainder, the values the
kernels' Shoup products and reductions give).
`ntt_forward` / `ntt_inverse` take them for a CPU tensor and launch the
CUDA kernels (`kernels.ntt`) for a CUDA tensor; they raise on any other
device and never fall back.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import primes
from .modmath import mont_constants, mont_mul, shoup_precompute, to_mont as _to_mont


@functools.lru_cache(maxsize=None)
def bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    perm = np.zeros(n, dtype=np.int32)
    for b in range(logn):
        perm |= ((np.arange(n) >> b) & 1).astype(np.int32) << (logn - 1 - b)
    perm.flags.writeable = False
    return perm


def _powers(g: int, n: int, q: int) -> np.ndarray:
    """g^k mod q for k < n (exact int64: q < 2^31), by doubling."""
    out = np.ones(n, dtype=np.int64)
    k, gk = 1, g % q
    while k < n:
        out[k:2 * k] = out[:min(k, n - k)] * gk % q
        k, gk = 2 * k, gk * gk % q
    return out


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Per-(N, q, device) tables.  Table tensors hold uint32 words as int32
    bit patterns (the Shoup companions reach 2^32 - 1); scalars are ints."""
    N: int
    q: int
    logN: int
    qinv_neg: int          # -q^-1 mod 2^32
    r2: int                # 2^64 mod q
    psi: int
    ninv: int              # N^-1 mod q
    ninv_s: int            # its Shoup companion
    fwd_w: torch.Tensor    # [N] psi^br(j)
    fwd_ws: torch.Tensor
    inv_w: torch.Tensor    # [N] psi^-br(j)
    inv_ws: torch.Tensor
    br: torch.Tensor       # [N] int64 bit reversal permutation (involution)


def _words(x) -> torch.Tensor:
    """uint32 values -> int32 tensor with the same bit patterns."""
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).view(np.int32).copy())


@functools.lru_cache(maxsize=None)
def make_plan(N: int, q: int, device: str | torch.device = "cpu") -> NttPlan:
    if not (N & (N - 1) == 0 and N >= 8):
        raise ValueError(f"N must be a power of two >= 8, got {N}")
    if not (q % (2 * N) == 1 and primes.is_prime(q) and q < 2**31):
        raise ValueError(f"q={q} is not an NTT prime below 2^31 for N={N}")
    logN = N.bit_length() - 1
    psi = primes.root_of_unity(2 * N, q)
    psi_inv = pow(psi, -1, q)
    ninv = pow(N, -1, q)
    qinv_neg, _r1, r2 = mont_constants(q)
    br = bit_reverse_perm(N)
    fwd_w = _powers(psi, N, q)[br]
    inv_w = _powers(psi_inv, N, q)[br]
    shoup = lambda w: (w << 32) // q            # shoup_precompute, all at once
    dev = torch.device(device)
    return NttPlan(
        N=N, q=q, logN=logN, qinv_neg=qinv_neg, r2=r2, psi=psi,
        ninv=ninv, ninv_s=shoup_precompute(ninv, q),
        fwd_w=_words(fwd_w).to(dev),
        fwd_ws=_words(shoup(fwd_w)).to(dev),
        inv_w=_words(inv_w).to(dev),
        inv_ws=_words(shoup(inv_w)).to(dev),
        br=torch.from_numpy(br.astype(np.int64)).to(dev),
    )


def _table(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int64)


def forward_butterfly(plan: NttPlan, x: torch.Tensor, out_br: bool = False) -> torch.Tensor:
    """[..., N] COEFFICIENT -> EVALUATION; plain version.

    Natural order, or with out_br the stages' bit-reversed order (the
    final gather skipped).  Returns the input's integer dtype."""
    N, q = plan.N, plan.q
    lead = x.shape[:-1]
    w_all = _table(plan.fwd_w, x.device)
    y = x.reshape(-1, N).to(torch.int64)
    for s in range(plan.logN):
        m = 1 << s
        t = N >> (s + 1)
        yv = y.reshape(-1, m, 2, t)
        u = yv[:, :, 0, :]
        v = yv[:, :, 1, :] * w_all[m:2 * m].reshape(1, m, 1) % q      # the Shoup product's value
        y = torch.stack([u + v, u - v + q], dim=2).reshape(-1, N) % q
    if not out_br:
        y = y[:, _table(plan.br, x.device)]    # bit-reversed -> natural
    return y.reshape(*lead, N).to(x.dtype)


def inverse_butterfly(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., N] EVALUATION (natural order) -> COEFFICIENT; plain version."""
    N, q = plan.N, plan.q
    lead = x.shape[:-1]
    w_all = _table(plan.inv_w, x.device)
    y = x.reshape(-1, N).to(torch.int64)[:, _table(plan.br, x.device)]
    for s in range(plan.logN):
        h = N >> (s + 1)
        t = 1 << s
        yv = y.reshape(-1, h, 2, t)
        u = yv[:, :, 0, :]
        v = yv[:, :, 1, :]
        y = torch.stack([(u + v) % q, (u - v + q) * w_all[h:2 * h].reshape(1, h, 1) % q],
                        dim=2).reshape(-1, N)
    y = y * plan.ninv % q
    return y.reshape(*lead, N).to(x.dtype)


def _dispatch(plan: NttPlan, x: torch.Tensor, plain, kernel) -> torch.Tensor:
    """Plain version for a CPU tensor, the kernel for a CUDA one; raises on
    any other device.  (The callers import `kernels.ntt` when called:
    that package imports this module.)"""
    if x.device.type == "cpu":
        return plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    lead = x.shape[:-1]
    return kernel(plan, x.reshape(-1, plan.N).contiguous()).reshape(*lead, plan.N)


def ntt_forward(plan: NttPlan, x: torch.Tensor, out_br: bool = False) -> torch.Tensor:
    """[..., N] int32 COEFFICIENT -> EVALUATION (bit-reversed order with
    out_br): plain on CPU, kernel on CUDA."""
    from ..kernels import ntt as kntt
    return _dispatch(plan, x, functools.partial(forward_butterfly, out_br=out_br),
                     functools.partial(kntt.forward, out_br=out_br))


def ntt_inverse(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., N] int32 EVALUATION -> COEFFICIENT: plain on CPU, kernel on CUDA."""
    from ..kernels import ntt as kntt
    return _dispatch(plan, x, inverse_butterfly, kntt.inverse)


def to_mont(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    return _to_mont(x, plan.q).to(x.dtype)


def pointwise_mont(plan: NttPlan, a: torch.Tensor, b_mont: torch.Tensor) -> torch.Tensor:
    """a * b mod q where b_mont is in Montgomery form; result plain form."""
    return mont_mul(a, b_mont, plan.q).to(a.dtype)


def pointwise_mul(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain a * b mod q."""
    return pointwise_mont(plan, to_mont(plan, a), b)


def negacyclic_mul(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic polynomial product in COEFFICIENT domain (for tests)."""
    ea = ntt_forward(plan, a)
    eb = ntt_forward(plan, b)
    return ntt_inverse(plan, pointwise_mul(plan, ea, eb))
