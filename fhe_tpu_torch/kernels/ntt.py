"""Launch wrappers for the NTT kernels (`csrc/ntt.cuh`, entry points in
`csrc/ntt.cu`).

Kernels 1 and 2 of the port: the batched negacyclic forward and inverse
NTT, replacing `fhe_tpu/math/ntt_pallas.py` `_fwd_kernel` / `_inv_kernel`.
The plain PyTorch versions are `math.ntt.forward_butterfly` /
`inverse_butterfly`; `math.ntt.ntt_forward` / `ntt_inverse` take them for a
CPU tensor and these wrappers for a CUDA one.

The kernels are compiled for the N of `sizes()` (`csrc/ntt_shapes.h`);
`check_n` raises ValueError for any other N, before any launch, and runs
without a card.  They take any NTT prime q < 2^31: lazy butterflies where
q < 2^30 (4q < 2^32), canonical ones above, chosen here from `plan.q`.
Each wrapper checks its input, launches on the current stream without
synchronising, and adds one to its entry of `LAUNCHES` per launch.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from ._build import ntt_sizes as sizes

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0}
LAZY_Q = 1 << 30


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
    rc = lib.fhe_ntt_forward(x.data_ptr(), y.data_ptr(), plan.fwd_w.data_ptr(),
                             plan.fwd_ws.data_ptr(), x.shape[0], plan.N, plan.q,
                             int(out_br), int(plan.q < LAZY_Q), _build.stream_handle(x.device))
    _build.check(rc, "fhe_ntt_forward")
    LAUNCHES["ntt_forward"] += 1
    return y


def inverse(plan, x: torch.Tensor) -> torch.Tensor:
    """[rows, N] int32 natural-order EVALUATION -> COEFFICIENT (kernel)."""
    _check(plan, x)
    y = torch.empty_like(x)
    lib = _build.library().cdll
    rc = lib.fhe_ntt_inverse(x.data_ptr(), y.data_ptr(), plan.inv_w.data_ptr(),
                             plan.inv_ws.data_ptr(), x.shape[0], plan.N, plan.q,
                             plan.ninv, plan.ninv_s, *_scale(plan.N, plan.q, plan.psi, plan.ninv),
                             int(plan.q < LAZY_Q), _build.stream_handle(x.device))
    _build.check(rc, "fhe_ntt_inverse")
    LAUNCHES["ntt_inverse"] += 1
    return y
