"""Launch wrapper for the blind-rotation kernel (`csrc/blind_rotate.cu`).

Kernel 3 of the port: the whole n-step CGGI blind rotation in one launch,
replacing `fhe_tpu/tfhe/boot_mxu.py` `_mega_kernel` + `_step_body`.  The
plain PyTorch version is `tfhe.boot.blind_rotate_plain`;
`tfhe.boot.blind_rotate` takes it for CPU tensors and this wrapper for
CUDA tensors.

The wrapper checks its inputs, launches on the current stream without
synchronising, and adds one to `LAUNCHES["blind_rotate"]` per launch.
`require` and `step_constants` serve the bit-reversed kernels too
(`kernels.blind_rotate_br`): all three run `fhe::cggi_step`.
"""

from __future__ import annotations

import torch

from ..math import ntt as nttmod
from . import _build

LAUNCHES = {"blind_rotate": 0}


def require(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def step_constants(params, plan) -> tuple:
    """(N, dG2, dG - 1, g_bits, offset, Q, qinv_neg, N^-1, its Shoup
    companion, 2^32 mod Q): the C `fhe::CggiParams`, in its order.  Raises
    where the kernel's int32 digit arithmetic does not hold."""
    g_bits = params.base_g.bit_length() - 1
    if params.base_g != 1 << g_bits:
        raise ValueError(f"gadget base {params.base_g} is not a power of two")
    offset = sum((params.base_g >> 1) << (g_bits * t) for t in range(params.digits_g))
    Q = params.Q
    if offset >= 2**31 - Q:
        raise ValueError("digit offset overflows int32 for these parameters")
    return (params.N, params.digits_g2, params.digits_g - 1, g_bits, offset,
            Q, plan.qinv_neg, plan.ninv, plan.ninv_s, (1 << 32) % Q)


def blind_rotate(params, bsk: torch.Tensor, acc: torch.Tensor, a: torch.Tensor,
                 q_lwe: int, psi_pows_mont: torch.Tensor) -> torch.Tensor:
    """bsk [steps, 2, dG2, 2, N], acc [B, 2, N], a [B, steps] and
    psi_pows_mont [2N], all int32 on one CUDA device.  Returns the rotated
    accumulator [B, 2, N] int32 (natural EVALUATION order, plain form)."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"blind-rotation kernel needs CUDA tensors, got {dev}")
    N, dg2 = params.N, params.digits_g2
    B, steps = acc.shape[0], bsk.shape[0]
    require(acc, "acc", (B, 2, N), dev)
    require(bsk, "bsk", (steps, 2, dg2, 2, N), dev)
    require(a, "a", (B, steps), dev)
    require(psi_pows_mont, "psi_pows_mont", (2 * N,), dev)
    if (2 * N) % q_lwe:
        raise ValueError(f"LWE modulus {q_lwe} must divide 2N = {2 * N}")
    plan = nttmod.make_plan(N, params.Q, dev)
    consts = step_constants(params, plan)
    out = torch.empty_like(acc)
    lib = _build.library().cdll
    rc = lib.fhe_blind_rotate(
        acc.data_ptr(), out.data_ptr(), a.data_ptr(), bsk.data_ptr(), psi_pows_mont.data_ptr(),
        plan.fwd_w.data_ptr(), plan.fwd_ws.data_ptr(), plan.inv_w.data_ptr(),
        plan.inv_ws.data_ptr(), B, steps, *consts, q_lwe, (2 * N) // q_lwe,
        _build.stream_handle(dev))
    _build.check(rc, "fhe_blind_rotate")
    LAUNCHES["blind_rotate"] += 1
    return out
