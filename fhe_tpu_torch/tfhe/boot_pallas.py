"""CGGI blind rotation in bit-reversed EVALUATION order (port of
fhe_tpu/tfhe/boot_pallas.py, `ntt_impl="mega"` and `"fused"`).

The accumulator and the bootstrap key stay in bit-reversed EVAL order
across the n steps: the inverse butterflies consume that order and the
forward butterflies produce it, so no permutation runs inside a step.
The test vector enters through the forward NTT with `out_br`, the key as
its bit-reversed copy (`rgsw.BootstrapKey.bsk_br`, made once per key), and
one gather returns the result to natural order before extraction.

`blind_rotate_mega` (the whole scan, one launch) and `rotate_step_br` /
`blind_rotate_fused` (one launch per step) take their plain versions for
CPU tensors and the CUDA kernels (`kernels.blind_rotate_br`) for CUDA
tensors; they raise on any other device and never fall back.  The plain
versions are the natural-order plain rotation (`boot.blind_rotate_plain`)
between two bit reversals, while the kernels index the rotation directly
in bit-reversed order: two different computations that must agree byte
for byte.
"""

from __future__ import annotations

import torch

from ..kernels import blind_rotate_br as kbr
from ..math import ntt as nttmod
from . import boot, rgsw
from .params import TfheParams


def bit_reverse(params: TfheParams, x: torch.Tensor) -> torch.Tensor:
    """The last (evaluation) axis permuted by the bit reversal, an
    involution: natural <-> bit-reversed order."""
    plan = nttmod.make_plan(params.N, params.Q, x.device)
    return torch.index_select(x, -1, plan.br)


def bsk_to_br(params: TfheParams, bsk: torch.Tensor) -> torch.Tensor:
    """The bootstrap key's evaluation axis in bit-reversed order."""
    return rgsw.bsk_to_br(bsk)


def _psi_powers(params: TfheParams, device) -> torch.Tensor:
    return boot._psi_powers_mont_words(params.N, params.Q, device)


def blind_rotate_mega_plain(params: TfheParams, bsk_br: torch.Tensor,
                            acc_br: torch.Tensor, a: torch.Tensor,
                            a_modulus: int | None = None) -> torch.Tensor:
    """Plain version of kernel 4: bsk_br [n, 2, dG2, 2, N], acc_br [B, 2, N]
    in bit-reversed EVAL order, a [B, n] the mask mod a_modulus (default q)."""
    rot = boot.blind_rotate_plain(params, bit_reverse(params, bsk_br),
                                  bit_reverse(params, acc_br), a, a_modulus)
    return bit_reverse(params, rot)


def blind_rotate_mega(params: TfheParams, bsk_br: torch.Tensor, acc_br: torch.Tensor,
                      a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """Whole-scan CGGI accumulation in bit-reversed order: the plain version
    for CPU tensors, kernel 4 for CUDA tensors."""
    if acc_br.device.type == "cpu":
        return blind_rotate_mega_plain(params, bsk_br, acc_br, a, a_modulus)
    return kbr.blind_rotate_mega(params, bsk_br, acc_br, a, _psi_powers(params, acc_br.device),
                                 a_modulus)


def rotate_step_br_plain(params: TfheParams, bsk_br_i: torch.Tensor, acc_br: torch.Tensor,
                         a_i: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """Plain version of kernel 5, one step: bsk_br_i [2, dG2, 2, N], a_i [B]."""
    return blind_rotate_mega_plain(params, bsk_br_i[None], acc_br, a_i[:, None], a_modulus)


def rotate_step_br(params: TfheParams, bsk_br_i: torch.Tensor, acc_br: torch.Tensor,
                   a_i: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """One CGGI step in bit-reversed order: the plain version for CPU
    tensors, one launch of kernel 5 for CUDA tensors."""
    if acc_br.device.type == "cpu":
        return rotate_step_br_plain(params, bsk_br_i, acc_br, a_i, a_modulus)
    return kbr.rotate_step_br(params, bsk_br_i, acc_br, a_i, _psi_powers(params, acc_br.device),
                              a_modulus)


def blind_rotate_fused(params: TfheParams, bsk_br: torch.Tensor, acc_br: torch.Tensor,
                       a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """Per-step CGGI accumulation in bit-reversed order, one step at a time
    (fhe_tpu's lax.scan over `_step_kernel`): the plain step for CPU
    tensors, n launches of kernel 5 for CUDA tensors."""
    if acc_br.device.type == "cpu":
        for i in range(bsk_br.shape[0]):
            acc_br = rotate_step_br_plain(params, bsk_br[i], acc_br, a[:, i], a_modulus)
        return acc_br
    return kbr.blind_rotate_fused(params, bsk_br, acc_br, a, _psi_powers(params, acc_br.device),
                                  a_modulus)


def _bootstrap_core_br(rotate, params: TfheParams, key: rgsw.BootstrapKey,
                       test_vec: torch.Tensor, a: torch.Tensor,
                       a_modulus: int | None) -> torch.Tensor:
    plan = nttmod.make_plan(params.N, params.Q, test_vec.device)
    acc1 = nttmod.ntt_forward(plan, test_vec, out_br=True)
    acc_br = torch.stack([torch.zeros_like(acc1), acc1], dim=1)
    rot = rotate(params, key.bsk_br, acc_br, a, a_modulus)
    return bit_reverse(params, rot)


def bootstrap_core_mega(params: TfheParams, key: rgsw.BootstrapKey, test_vec: torch.Tensor,
                        a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """Test vector [B, N] COEFFICIENT -> whole-scan rotation by the mask a
    mod a_modulus (default q) -> accumulator [B, 2, N] in natural EVAL
    order (boot.bootstrap_core with impl "mega")."""
    return _bootstrap_core_br(blind_rotate_mega, params, key, test_vec, a, a_modulus)


def bootstrap_core_fused(params: TfheParams, key: rgsw.BootstrapKey, test_vec: torch.Tensor,
                         a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """As bootstrap_core_mega, one launch per step (impl "fused")."""
    return _bootstrap_core_br(blind_rotate_fused, params, key, test_vec, a, a_modulus)
