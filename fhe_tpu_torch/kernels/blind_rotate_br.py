"""Launch wrappers for the bit-reversed blind-rotation kernels
(`csrc/blind_rotate_br.cu`).

Kernel 4 of the port, `blind_rotate_mega`, runs the whole n-step rotation
in one launch and replaces `fhe_tpu/tfhe/boot_pallas.py` `_mega_kernel`.
Kernel 5, `rotate_step_br`, runs one step per launch and replaces
`_step_kernel`; `blind_rotate_fused` launches it once per step.  The
accumulator and the key are in bit-reversed EVALUATION order.  The plain
PyTorch versions are `tfhe.boot_pallas.blind_rotate_mega_plain` and
`rotate_step_br_plain`; `tfhe.boot_pallas` takes them for CPU tensors and
these wrappers for CUDA tensors.

Each wrapper checks its inputs once (`blind_rotate_fused` once per
rotation, not once per step), launches on the current stream without
synchronising, and adds one to its entry of `LAUNCHES` per launch.
"""

from __future__ import annotations

import torch

from ..math import ntt as nttmod
from . import _build
from .blind_rotate import require, step_constants

LAUNCHES = {"blind_rotate_mega": 0, "rotate_step_br": 0}


def _checked(params, bsk_br, acc_br, idx_pos, idx_neg, psi_pows_mont):
    """Checks every input; returns (device, plan, C step constants)."""
    dev = acc_br.device
    if dev.type != "cuda":
        raise ValueError(f"blind-rotation kernel needs CUDA tensors, got {dev}")
    N, B, n = params.N, acc_br.shape[0], bsk_br.shape[0]
    require(acc_br, "acc_br", (B, 2, N), dev)
    require(bsk_br, "bsk_br", (n, 2, params.digits_g2, 2, N), dev)
    require(idx_pos, "idx_pos", (B, n), dev)
    require(idx_neg, "idx_neg", (B, n), dev)
    require(psi_pows_mont, "psi_pows_mont", (2 * N,), dev)
    plan = nttmod.make_plan(N, params.Q, dev)
    return dev, plan, step_constants(params, plan)


def _tables(plan, psi_pows_mont) -> tuple:
    return (psi_pows_mont.data_ptr(), plan.fwd_w.data_ptr(), plan.fwd_ws.data_ptr(),
            plan.inv_w.data_ptr(), plan.inv_ws.data_ptr())


def blind_rotate_mega(params, bsk_br: torch.Tensor, acc_br: torch.Tensor,
                      idx_pos: torch.Tensor, idx_neg: torch.Tensor,
                      psi_pows_mont: torch.Tensor) -> torch.Tensor:
    """Kernel 4.  bsk_br [n, 2, dG2, 2, N], acc_br [B, 2, N], idx_pos and
    idx_neg [B, n] (exponents of X^idx and X^-idx mod 2N), psi_pows_mont
    [2N], all int32 on one CUDA device.  Returns the rotated accumulator
    [B, 2, N] (bit-reversed EVALUATION order, plain form)."""
    dev, plan, consts = _checked(params, bsk_br, acc_br, idx_pos, idx_neg, psi_pows_mont)
    out = torch.empty_like(acc_br)
    rc = _build.library().cdll.fhe_blind_rotate_mega(
        acc_br.data_ptr(), out.data_ptr(), idx_pos.data_ptr(), idx_neg.data_ptr(),
        bsk_br.data_ptr(), *_tables(plan, psi_pows_mont), acc_br.shape[0], bsk_br.shape[0],
        *consts, _build.stream_handle(dev))
    _build.check(rc, "fhe_blind_rotate_mega")
    LAUNCHES["blind_rotate_mega"] += 1
    return out


def rotate_step_br(params, bsk_step: torch.Tensor, acc_br: torch.Tensor,
                   idx_pos: torch.Tensor, idx_neg: torch.Tensor,
                   psi_pows_mont: torch.Tensor) -> torch.Tensor:
    """Kernel 5, one launch: bsk_step [2, dG2, 2, N], acc_br [B, 2, N],
    idx_pos and idx_neg [B].  Returns acc_br after one step."""
    return blind_rotate_fused(params, bsk_step[None], acc_br, idx_pos[:, None],
                              idx_neg[:, None], psi_pows_mont)


def blind_rotate_fused(params, bsk_br: torch.Tensor, acc_br: torch.Tensor,
                       idx_pos: torch.Tensor, idx_neg: torch.Tensor,
                       psi_pows_mont: torch.Tensor) -> torch.Tensor:
    """The n-step rotation as n launches of kernel 5, on the inputs of
    `blind_rotate_mega`; the accumulator alternates between two buffers."""
    dev, plan, consts = _checked(params, bsk_br, acc_br, idx_pos, idx_neg, psi_pows_mont)
    n = bsk_br.shape[0]
    bufs = (torch.empty_like(acc_br), torch.empty_like(acc_br))
    step_bytes = bsk_br[0].numel() * bsk_br.element_size()
    fn = _build.library().cdll.fhe_rotate_step_br
    tables = _tables(plan, psi_pows_mont)
    stream = _build.stream_handle(dev)
    cur = acc_br
    for i in range(n):
        nxt = bufs[i % 2]
        rc = fn(cur.data_ptr(), nxt.data_ptr(), idx_pos.data_ptr(), idx_neg.data_ptr(),
                bsk_br.data_ptr() + i * step_bytes, *tables, acc_br.shape[0], n, i, *consts,
                stream)
        _build.check(rc, "fhe_rotate_step_br")
        LAUNCHES["rotate_step_br"] += 1
        cur = nxt
    return cur
