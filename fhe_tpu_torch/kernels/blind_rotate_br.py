"""Launch wrappers for the bit-reversed blind-rotation kernels
(`csrc/blind_rotate.cuh`).

Kernel 4 of the port, `blind_rotate_mega`, is the bit-reversed
instantiation of the whole-scan kernel and replaces
`fhe_tpu/tfhe/boot_pallas.py` `_mega_kernel`.  Kernel 5, `rotate_step_br`,
runs one step per launch and replaces `_step_kernel`; `blind_rotate_fused`
makes its n launches from one C loop (`fhe_cggi_steps`), not from Python.
The accumulator and the key are in bit-reversed EVALUATION order.  The
plain PyTorch versions are `tfhe.boot_pallas.blind_rotate_mega_plain` and
`rotate_step_br_plain`; `tfhe.boot_pallas` takes them for CPU tensors and
these wrappers for CUDA tensors.

Each wrapper takes the mask's modulus `q_lwe` (default params.q; a power
of two dividing 2N, `blind_rotate.check_q_lwe`), checks its inputs once
(`blind_rotate_fused` once per rotation), launches on the current stream
without synchronising, and adds to its entry of `LAUNCHES` one per kernel
launch (n for a rotation of `blind_rotate_fused`); from N = `wide_n()` on
the wide kernels run (`csrc/cggi_step_wide.cuh`), counted under the same
names with "_wide".
"""

from __future__ import annotations

import torch

from . import _build
from .blind_rotate import checked, is_wide, scan

LAUNCHES = {"blind_rotate_mega": 0, "rotate_step_br": 0, "blind_rotate_mega_wide": 0,
            "rotate_step_br_wide": 0}


def blind_rotate_mega(params, bsk_br: torch.Tensor, acc_br: torch.Tensor, a: torch.Tensor,
                      psi_pows_mont: torch.Tensor, q_lwe: int | None = None) -> torch.Tensor:
    """Kernel 4.  bsk_br [n, 2, dG2, 2, N], acc_br [B, 2, N], a [B, n] the
    mask mod q_lwe, psi_pows_mont [2N], all int32 on one CUDA device.
    Returns the rotated accumulator [B, 2, N] (bit-reversed EVALUATION
    order, plain form)."""
    out = scan(params, bsk_br, acc_br, a, psi_pows_mont, natural=False, q_lwe=q_lwe)
    LAUNCHES["blind_rotate_mega_wide" if is_wide(params) else "blind_rotate_mega"] += 1
    return out


def blind_rotate_fused(params, bsk_br: torch.Tensor, acc_br: torch.Tensor, a: torch.Tensor,
                       psi_pows_mont: torch.Tensor, q_lwe: int | None = None) -> torch.Tensor:
    """The n-step rotation as n launches of kernel 5, on the inputs of
    `blind_rotate_mega`; the accumulator alternates between two buffers."""
    dev, c, tables, consts = checked(params, bsk_br, acc_br, a, psi_pows_mont, q_lwe)
    n = bsk_br.shape[0]
    if n == 0:
        return acc_br.clone()
    bufs = (torch.empty_like(acc_br), torch.empty_like(acc_br))
    rc = _build.library().cdll.fhe_cggi_steps(
        acc_br.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), a.data_ptr(),
        bsk_br.data_ptr(), *tables, acc_br.shape[0], n, params.N, params.digits_g2, c,
        *consts, _build.stream_handle(dev))
    _build.check(rc, "fhe_cggi_steps")
    LAUNCHES["rotate_step_br_wide" if is_wide(params) else "rotate_step_br"] += n
    return bufs[(n - 1) % 2]


def rotate_step_br(params, bsk_step: torch.Tensor, acc_br: torch.Tensor, a_i: torch.Tensor,
                   psi_pows_mont: torch.Tensor, q_lwe: int | None = None) -> torch.Tensor:
    """Kernel 5, one launch: bsk_step [2, dG2, 2, N], acc_br [B, 2, N], a_i
    [B] the step's mask word mod q_lwe.  Returns acc_br after one step."""
    return blind_rotate_fused(params, bsk_step[None], acc_br, a_i[:, None].contiguous(),
                              psi_pows_mont, q_lwe)
