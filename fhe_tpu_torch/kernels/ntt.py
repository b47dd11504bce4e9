"""Launch wrappers for the NTT kernels (`csrc/ntt.cu`).

Kernels 1 and 2 of the port: the batched negacyclic forward and inverse
NTT, replacing `fhe_tpu/math/ntt_pallas.py` `_fwd_kernel` / `_inv_kernel`.
The plain PyTorch versions are `math.ntt.forward_butterfly` /
`inverse_butterfly`; `math.ntt.ntt_forward` / `ntt_inverse` take them for a
CPU tensor and these wrappers for a CUDA one.

Each wrapper checks its input, launches on the current stream without
synchronising, and adds one to its entry of `LAUNCHES` per launch.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0}


def _check(plan, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"NTT kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"NTT kernel needs int32 residues, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != plan.N:
        raise ValueError(f"NTT kernel needs [rows, {plan.N}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("NTT kernel needs a contiguous tensor")
    if plan.fwd_w.device != x.device:
        raise ValueError(f"plan tables on {plan.fwd_w.device}, input on {x.device}")


def forward(plan, x: torch.Tensor, out_br: bool = False) -> torch.Tensor:
    """[rows, N] int32 COEFFICIENT -> EVALUATION (kernel), in natural order
    or, with out_br, in the stages' bit-reversed order."""
    _check(plan, x)
    y = torch.empty_like(x)
    lib = _build.library().cdll
    rc = lib.fhe_ntt_forward(x.data_ptr(), y.data_ptr(), plan.fwd_w.data_ptr(),
                             plan.fwd_ws.data_ptr(), x.shape[0], plan.N, plan.q,
                             int(out_br), _build.stream_handle(x.device))
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
                             plan.ninv, plan.ninv_s, _build.stream_handle(x.device))
    _build.check(rc, "fhe_ntt_inverse")
    LAUNCHES["ntt_inverse"] += 1
    return y
