"""The NTT of an RNS (double-CRT) ring element: the part of
fhe_tpu/lattice/rns.py that the 2-limb accumulator (`tfhe.rgsw_rns`) uses.

A ring element mod Q = q_0 ... q_{L-1} is one int32 tensor [..., L, N]
(limb-major, fhe_tpu's layout), limb l a residue mod its own NTT prime
q_l < 2^31.  `RnsPlan` stacks the limbs' `math.ntt.NttPlan` tables as
[L, N].  `ntt_forward` / `ntt_inverse` transform every limb of every row:
the plain per-limb loop (`forward_plain` / `inverse_plain`) for a CPU
tensor, the limb-stacked NTT kernels (`kernels.ntt.forward_limbs` /
`inverse_limbs`, one launch for all limbs) for a CUDA tensor; they raise
on any other device and never fall back.  EVALUATION is natural order, as
in `math.ntt`.  The rest of fhe_tpu's RnsPoly (basis switching,
automorphisms) waits for ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..math import ntt as nttmod


@dataclasses.dataclass(frozen=True, eq=False)
class RnsPlan:
    """Per-(N, moduli, device) tables: the limbs' NttPlans, their tables
    stacked [L, N] int32 (uint32 words), and the moduli as an int64 [L, 1]
    tensor for broadcasting against [..., L, N]."""
    N: int
    moduli: tuple[int, ...]
    plans: tuple[nttmod.NttPlan, ...]
    q: torch.Tensor
    fwd_w: torch.Tensor
    fwd_ws: torch.Tensor
    inv_w: torch.Tensor
    inv_ws: torch.Tensor

    @property
    def L(self) -> int:
        return len(self.moduli)


@functools.lru_cache(maxsize=None)
def make_rns_plan(N: int, moduli: tuple[int, ...], device: str | torch.device = "cpu") -> RnsPlan:
    """The plan of the basis `moduli` (each an NTT prime below 2^31 for N)."""
    dev = torch.device(device)
    plans = tuple(nttmod.make_plan(N, q, dev) for q in moduli)
    stack = lambda name: torch.stack([getattr(p, name) for p in plans]).contiguous()
    return RnsPlan(N=N, moduli=tuple(moduli), plans=plans,
                   q=torch.tensor(moduli, dtype=torch.int64, device=dev)[:, None],
                   fwd_w=stack("fwd_w"), fwd_ws=stack("fwd_ws"),
                   inv_w=stack("inv_w"), inv_ws=stack("inv_ws"))


def _per_limb(plan: RnsPlan, x: torch.Tensor, fn) -> torch.Tensor:
    return torch.stack([fn(p, x[..., l, :]) for l, p in enumerate(plan.plans)], dim=-2)


def forward_plain(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] COEFFICIENT -> EVALUATION, limb by limb; plain version."""
    return _per_limb(plan, x, nttmod.forward_butterfly)


def inverse_plain(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] EVALUATION -> COEFFICIENT, limb by limb; plain version."""
    return _per_limb(plan, x, nttmod.inverse_butterfly)


def _dispatch(plan: RnsPlan, x: torch.Tensor, plain, kernel) -> torch.Tensor:
    if tuple(x.shape[-2:]) != (plan.L, plan.N):
        raise ValueError(f"RNS NTT needs [..., {plan.L}, {plan.N}], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT for device {x.device}")
    lead = x.shape[:-2]
    return kernel(plan, x.reshape(-1, plan.L, plan.N).contiguous()).reshape(*lead, plan.L, plan.N)


def ntt_forward(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] int32 COEFFICIENT -> EVALUATION, per-limb moduli: plain
    on CPU, the limb-stacked kernel on CUDA."""
    from ..kernels import ntt as kntt
    return _dispatch(plan, x, forward_plain, kntt.forward_limbs)


def ntt_inverse(plan: RnsPlan, x: torch.Tensor) -> torch.Tensor:
    """[..., L, N] int32 EVALUATION -> COEFFICIENT: plain on CPU, the
    limb-stacked kernel on CUDA."""
    from ..kernels import ntt as kntt
    return _dispatch(plan, x, inverse_plain, kntt.inverse_limbs)
