"""Launch wrappers for the NTT kernels (`csrc/ntt.cuh`, entry points in
`csrc/ntt.cu`).

Kernels 1 and 2 of the port: the batched negacyclic forward and inverse
NTT, replacing `fhe_tpu/math/ntt_pallas.py` `_fwd_kernel` / `_inv_kernel`.
The plain PyTorch versions are `math.ntt.forward_butterfly` /
`inverse_butterfly`; `math.ntt.ntt_forward` / `ntt_inverse` take them for a
CPU tensor and these wrappers for a CUDA one.

The kernels are compiled for the N of `sizes()` (`csrc/ntt_shapes.h`):
2^3 to 2^8 by the small-N kernels (`csrc/ntt_small.cu`, counted as
`ntt_forward_small` / `ntt_inverse_small`), 2^9 to 2^16 by `csrc/ntt.cuh`'s;
`check_n` raises ValueError for any other N, before any launch, and runs
without a card.  They take any NTT prime q < 2^31: lazy butterflies where
q < 2^30 (4q < 2^32), canonical ones above, chosen here from `plan.q` (the
small-N kernels are canonical at every q).  Each wrapper checks its input,
launches on the current stream without synchronising, and adds one to its
entry of `LAUNCHES` per launch.

`forward_limbs` / `inverse_limbs` run the same kernels' rows over an RNS
ring element [rows, L, N] in one launch: row r, limb l, with limb l's
modulus, table and scale (`lattice.rns.RnsPlan`), for 1 to `max_limbs()`
limbs at the N of `limb_sizes()` (`check_limbs` raises ValueError
otherwise, without a card), lazy
only where every limb is below 2^30.  Their plain versions are
`lattice.rns.forward_plain` / `inverse_plain`.

At N = `SPLIT_N` = 2^16 the kernels run a row as two 2^15 halves after its
first stage (`csrc/ntt_launch.h` kSplitLogN) and take the plan's tables
regathered by `split_tables`; `forward_split_model` /
`inverse_split_model` are that data flow in plain PyTorch, on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import types

import numpy as np
import torch

from . import _build
from ._build import max_limbs
from ._build import ntt_large_sizes as limb_sizes
from ._build import ntt_sizes as sizes
from ._build import ntt_small_sizes as small_sizes

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0, "ntt_forward_limbs": 0, "ntt_inverse_limbs": 0,
            "ntt_forward_small": 0, "ntt_inverse_small": 0}
LAZY_Q = 1 << 30
SPLIT_N = 1 << 16


def check_n(N: int) -> None:
    """ValueError unless the NTT kernels are built for N."""
    if N not in sizes():
        raise ValueError(f"no NTT kernel for N = {N}; instantiated: {list(sizes())} "
                         f"(csrc/ntt_shapes.h)")


def rows_per_block(N: int) -> int:
    """Rows one block of the N-point kernels transforms (from the library)."""
    check_n(N)
    return _build.library().cdll.fhe_ntt_rows_per_block(N)


@functools.lru_cache(maxsize=None)
def _scale(N: int, q: int, psi: int, ninv: int) -> tuple[int, int]:
    """inv_w[1] N^-1 mod q (inv_w[1] = psi^-(N/2), the inverse's last-stage
    twiddle) and its Shoup companion: the inverse folds N^-1 into that stage."""
    w = pow(psi, -(N // 2), q) * ninv % q
    return w, (w << 32) // q


@functools.lru_cache(maxsize=None)
def _split_index(N: int) -> np.ndarray:
    """Entries of the N-point table that make the split tables [T_0 | T_1]:
    T_h[u] = W[u + (1 + h) 2^k] for 2^k <= u < 2^(k+1), T_h[0] = W[1]."""
    H = N // 2
    u = np.arange(H, dtype=np.int64)
    level = np.zeros(H, dtype=np.int64)
    level[1:] = 1 << (np.log2(u[1:]).astype(np.int64))
    halves = [np.where(u == 0, 1, u + (1 + h) * level) for h in (0, 1)]
    return np.concatenate(halves)


@functools.lru_cache(maxsize=None)
def _split_tables(N: int, moduli: tuple, device: str) -> tuple:
    from ..lattice import rns
    plan = rns.make_rns_plan(N, moduli, torch.device(device))
    idx = torch.from_numpy(_split_index(N)).to(plan.fwd_w.device)
    return tuple(t.index_select(-1, idx).contiguous()
                 for t in (plan.fwd_w, plan.fwd_ws, plan.inv_w, plan.inv_ws))


def split_tables(plan) -> tuple:
    """The tables of a plan (math.ntt's NttPlan or an RnsPlan) regathered
    for the split kernels: (fwd_w, fwd_ws, inv_w, inv_ws), each [L, N]
    (L = 1 for an NttPlan), cached per (N, moduli, device)."""
    moduli = plan.moduli if hasattr(plan, "moduli") else (plan.q,)
    return _split_tables(plan.N, tuple(moduli), str(plan.fwd_w.device))


def _half_plan(plan, h: int, split: tuple):
    """The 2^15 plan of half h (math.ntt's fields the butterflies read),
    its tables T_h and no N^-1 scale."""
    from ..math.ntt import bit_reverse_perm
    H = plan.N // 2
    fw, _, iw, _ = (t[0, h * H:(h + 1) * H] for t in split)
    br = torch.from_numpy(bit_reverse_perm(H).astype(np.int64))
    return types.SimpleNamespace(N=H, q=plan.q, logN=H.bit_length() - 1, fwd_w=fw, inv_w=iw,
                                 br=br, ninv=1)


def forward_split_model(plan, x: torch.Tensor, out_br: bool = False) -> torch.Tensor:
    """The split forward's data flow in plain PyTorch ([..., N], N =
    SPLIT_N, CPU): the stage on the top bit, each half's 2^15 transform on
    its T_h, the halves' slots interleaved (natural order) or concatenated
    (out_br).  Equals math.ntt.forward_butterfly."""
    from ..math.ntt import forward_butterfly
    N, q, H = plan.N, plan.q, plan.N // 2
    split = split_tables(plan)
    a, b = x[..., :H].to(torch.int64), x[..., H:].to(torch.int64)
    wb = b * int(split[0][0, 0]) % q
    outs = [forward_butterfly(_half_plan(plan, h, split), v, out_br)
            for h, v in ((0, (a + wb) % q), (1, (a - wb) % q))]
    if out_br:
        return torch.cat(outs, dim=-1).to(x.dtype)
    return torch.stack(outs, dim=-1).reshape(x.shape).to(x.dtype)


def inverse_split_model(plan, x: torch.Tensor) -> torch.Tensor:
    """The split inverse's data flow in plain PyTorch: each half's 2^15
    inverse (no scale) on slots 2i + h, then the top stage with N^-1 as
    inverse_stage_kernel computes it.  Equals math.ntt.inverse_butterfly."""
    from ..math.ntt import inverse_butterfly
    N, q, H = plan.N, plan.q, plan.N // 2
    split = split_tables(plan)
    a, b = (inverse_butterfly(_half_plan(plan, h, split), x[..., h::2]).to(torch.int64)
            for h in (0, 1))
    w1n, _ = _scale(N, q, plan.psi, plan.ninv)
    return torch.cat([(a + b) * plan.ninv % q, (a - b) % q * w1n % q], dim=-1).to(x.dtype)


def _tables(plan) -> tuple:
    """The tables a launch passes: the plan's, or its split tables at SPLIT_N."""
    if plan.N == SPLIT_N:
        return split_tables(plan)
    return plan.fwd_w, plan.fwd_ws, plan.inv_w, plan.inv_ws


def _check(plan, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"NTT kernel needs a CUDA tensor, got {x.device}")
    check_n(plan.N)
    if x.dtype != torch.int32:
        raise TypeError(f"NTT kernel needs int32 residues, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != plan.N:
        raise ValueError(f"NTT kernel needs [rows, {plan.N}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("NTT kernel needs a contiguous tensor")
    if plan.fwd_w.device != x.device:
        raise ValueError(f"plan tables on {plan.fwd_w.device}, input on {x.device}")
    if any(t.data_ptr() % 16 for t in (plan.fwd_w, plan.fwd_ws, plan.inv_w, plan.inv_ws)):
        raise ValueError("NTT kernel needs 16-byte aligned plan tables")


def forward(plan, x: torch.Tensor, out_br: bool = False) -> torch.Tensor:
    """[rows, N] int32 COEFFICIENT -> EVALUATION (kernel), in natural order
    or, with out_br, in the stages' bit-reversed order."""
    _check(plan, x)
    y = torch.empty_like(x)
    lib = _build.library().cdll
    w, ws, _, _ = _tables(plan)
    rc = lib.fhe_ntt_forward(x.data_ptr(), y.data_ptr(), w.data_ptr(),
                             ws.data_ptr(), x.shape[0], plan.N, plan.q,
                             int(out_br), int(plan.q < LAZY_Q), _build.stream_handle(x.device))
    _build.check(rc, "fhe_ntt_forward")
    LAUNCHES["ntt_forward_small" if plan.N in small_sizes() else "ntt_forward"] += 1
    return y


def inverse(plan, x: torch.Tensor) -> torch.Tensor:
    """[rows, N] int32 natural-order EVALUATION -> COEFFICIENT (kernel)."""
    _check(plan, x)
    y = torch.empty_like(x)
    lib = _build.library().cdll
    _, _, w, ws = _tables(plan)
    rc = lib.fhe_ntt_inverse(x.data_ptr(), y.data_ptr(), w.data_ptr(),
                             ws.data_ptr(), x.shape[0], plan.N, plan.q,
                             plan.ninv, plan.ninv_s, *_scale(plan.N, plan.q, plan.psi, plan.ninv),
                             int(plan.q < LAZY_Q), _build.stream_handle(x.device))
    _build.check(rc, "fhe_ntt_inverse")
    LAUNCHES["ntt_inverse_small" if plan.N in small_sizes() else "ntt_inverse"] += 1
    return y


def check_limbs(plan) -> None:
    """ValueError unless the limb-stacked kernels take the RNS plan: an N of
    limb_sizes() and 1 to max_limbs() limbs."""
    check_n(plan.N)
    if plan.N not in limb_sizes():
        raise ValueError(f"the limb-stacked NTT kernels take N in {list(limb_sizes())}, got "
                         f"{plan.N} (the small-N kernels are single-modulus)")
    if not 1 <= plan.L <= max_limbs():
        raise ValueError(f"the limb-stacked NTT kernels take 1 to {max_limbs()} limbs, "
                         f"got {plan.L} (csrc/ntt_launch.h kMaxLimbs)")


def _check_limbs(plan, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"NTT kernel needs a CUDA tensor, got {x.device}")
    check_limbs(plan)
    if x.dtype != torch.int32:
        raise TypeError(f"NTT kernel needs int32 residues, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (plan.L, plan.N):
        raise ValueError(f"limb-stacked NTT kernel needs [rows, {plan.L}, {plan.N}], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("NTT kernel needs a contiguous tensor")
    tables = (plan.fwd_w, plan.fwd_ws, plan.inv_w, plan.inv_ws)
    if any(t.device != x.device for t in tables):
        raise ValueError(f"plan tables on {plan.fwd_w.device}, input on {x.device}")
    if any(tuple(t.shape) != (plan.L, plan.N) or not t.is_contiguous() for t in tables):
        raise ValueError(f"limb-stacked NTT kernel needs contiguous [{plan.L}, {plan.N}] tables")
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("NTT kernel needs 16-byte aligned plan tables")


@functools.lru_cache(maxsize=None)
def _limb_scalars(limbs: tuple, inverse: bool):
    """The scalars of limbs ((N, q, psi, N^-1, its Shoup companion) each) as
    the C entry points take them, [1 or 5, L] uint32: q, and for the
    inverse N^-1, its companion and _scale's pair, limb by limb."""
    _, qs, _, ninvs, ninv_ss = zip(*limbs)
    rows = [qs]
    if inverse:
        pairs = [_scale(*limb[:4]) for limb in limbs]
        rows += [ninvs, ninv_ss, [w for w, _ in pairs], [ws for _, ws in pairs]]
    flat = [v for row in rows for v in row]
    return (ctypes.c_uint32 * len(flat))(*flat)


def _launch_limbs(entry: str, plan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    _check_limbs(plan, x)
    tables = _tables(plan)
    w, ws = tables[2:] if inverse else tables[:2]
    y = torch.empty_like(x)
    lazy = all(q < LAZY_Q for q in plan.moduli)
    limbs = tuple((p.N, p.q, p.psi, p.ninv, p.ninv_s) for p in plan.plans)
    fn = getattr(_build.library().cdll, entry)
    rc = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), ws.data_ptr(), x.shape[0], plan.L, plan.N,
            ctypes.cast(_limb_scalars(limbs, inverse), ctypes.c_void_p), int(lazy),
            _build.stream_handle(x.device))
    _build.check(rc, entry)
    return y


def forward_limbs(plan, x: torch.Tensor) -> torch.Tensor:
    """[rows, L, N] int32 COEFFICIENT -> natural-order EVALUATION, each
    limb mod its own prime (kernel)."""
    y = _launch_limbs("fhe_ntt_forward_limbs", plan, x, False)
    LAUNCHES["ntt_forward_limbs"] += 1
    return y


def inverse_limbs(plan, x: torch.Tensor) -> torch.Tensor:
    """[rows, L, N] int32 natural-order EVALUATION -> COEFFICIENT (kernel)."""
    y = _launch_limbs("fhe_ntt_inverse_limbs", plan, x, True)
    LAUNCHES["ntt_inverse_limbs"] += 1
    return y
