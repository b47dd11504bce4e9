"""Launch wrappers for the blind-rotation kernels (`csrc/blind_rotate.cuh`).

Kernels 3 and 4 of the port are one whole-scan kernel, templated on the
order: the n-step CGGI blind rotation in one launch.  `blind_rotate`
launches its natural-order instantiation (kernel 3, replacing
`fhe_tpu/tfhe/boot_mxu.py` `_mega_kernel` + `_step_body`);
`kernels.blind_rotate_br` launches the bit-reversed one (kernel 4) and the
one-step kernel (kernel 5).  The plain PyTorch version of this one is
`tfhe.boot.blind_rotate_plain`; `tfhe.boot.blind_rotate` takes it for CPU
tensors and this wrapper for CUDA tensors.

Every wrapper checks its inputs before any launch, and raises ValueError
for a parameter set the kernels are not built for: an (N, dG2) outside
`shapes()` (the instantiations, `csrc/cggi_shapes.h`) or Q >= 2^30 (the
kernels' lazy reduction keeps values below 4Q < 2^32), and for an LWE
modulus `q_lwe` of the mask (params.q unless the caller gives the
ciphertext's own, as functional bootstrapping does) that is not a power
of two dividing 2N.  A block holds `choose_c(B, SMs, N)` ciphertexts.  The
wrappers launch on the current stream without synchronising and add one
to their entry of `LAUNCHES` per kernel launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..math import ntt as nttmod
from . import _build
from ._build import shapes, wide_n  # noqa: F401  (re-exported)

LAUNCHES = {"blind_rotate": 0, "blind_rotate_wide": 0}
MAX_Q = 1 << 30
KINDS = {"natural": 0, "bit-reversed": 1, "step": 2}


def check_params(params) -> None:
    """ValueError unless the kernels are built for params' shape and Q."""
    shape = (params.N, params.digits_g2)
    if shape not in shapes():
        raise ValueError(f"no blind-rotation kernel for (N, dG2) = {shape}; instantiated: "
                         f"{list(shapes())} (csrc/cggi_shapes.h)")
    if params.Q >= MAX_Q:
        raise ValueError(f"Q = {params.Q} >= 2^30: the blind-rotation kernels need 4Q < 2^32")


def check_q_lwe(params, q_lwe: int) -> None:
    """ValueError unless the mask's modulus q_lwe is a power of two, >= 2,
    dividing 2N: the kernels index X^(((q_lwe - a) mod q_lwe) * 2N/q_lwe)
    with a mask of 2N - 1."""
    two_n = 2 * params.N
    if not (2 <= q_lwe <= two_n and q_lwe & (q_lwe - 1) == 0):
        raise ValueError(f"LWE modulus {q_lwe} must be a power of two >= 2 dividing "
                         f"2N = {two_n}")


def choose_c(batch: int, sm_count: int, N: int | None = None) -> int:
    """Ciphertexts per block: 2 (each key word fetched serves two) once the
    batch gives every SM two blocks of two, else 1 (more blocks, and batch
    1 is the latency path).  Always 1 at a ring of N >= wide_n(), whose
    wide step takes one ciphertext a block."""
    if N is not None and N >= wide_n():
        return 1
    return 2 if batch >= 4 * sm_count else 1


def is_wide(params) -> bool:
    """True where the kernels run the wide step (N >= wide_n())."""
    return params.N >= wide_n()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def require(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def step_constants(params, plan) -> tuple:
    """(g_bits, offset, Q, qinv_neg, N^-1, its Shoup companion, 2^32 mod Q):
    the C `StepConsts`, in the entry points' order.  Raises where the
    kernel's int32 digit arithmetic does not hold."""
    g_bits = params.base_g.bit_length() - 1
    if params.base_g != 1 << g_bits:
        raise ValueError(f"gadget base {params.base_g} is not a power of two")
    offset = sum((params.base_g >> 1) << (g_bits * t) for t in range(params.digits_g))
    Q = params.Q
    if offset >= 2**31 - Q:
        raise ValueError("digit offset overflows int32 for these parameters")
    return (g_bits, offset, Q, plan.qinv_neg, plan.ninv, plan.ninv_s, (1 << 32) % Q)


def checked(params, bsk_br, acc, a, psi_pows_mont, q_lwe: int | None):
    """Checks every input of a rotation (bsk_br [n, 2, dG2, 2, N], acc
    [B, 2, N], a [B, n] mod q_lwe (default params.q), psi_pows_mont [2N],
    int32 on one CUDA device); returns (device, C, the five table pointers,
    the step constants with q_lwe and 2N/q_lwe): the entry points'
    arguments around the shape."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"blind-rotation kernel needs CUDA tensors, got {dev}")
    check_params(params)
    q_lwe = params.q if q_lwe is None else q_lwe
    check_q_lwe(params, q_lwe)
    N, dg2 = params.N, params.digits_g2
    B, n = acc.shape[0], bsk_br.shape[0]
    require(acc, "acc", (B, 2, N), dev)
    require(bsk_br, "bsk_br", (n, 2, dg2, 2, N), dev)
    require(a, "a", (B, n), dev)
    require(psi_pows_mont, "psi_pows_mont", (2 * N,), dev)
    c = choose_c(B, _sm_count(dev), N)
    plan = nttmod.make_plan(N, params.Q, dev)
    tables = (psi_pows_mont.data_ptr(), plan.fwd_w.data_ptr(), plan.fwd_ws.data_ptr(),
              plan.inv_w.data_ptr(), plan.inv_ws.data_ptr())
    return dev, c, tables, step_constants(params, plan) + (q_lwe, (2 * N) // q_lwe)


def scan(params, bsk_br, acc, a, psi_pows_mont, natural: bool,
         q_lwe: int | None) -> torch.Tensor:
    """One launch of the whole-scan kernel in either order; returns the
    rotated accumulator [B, 2, N] (plain form, the order of acc)."""
    dev, c, tables, consts = checked(params, bsk_br, acc, a, psi_pows_mont, q_lwe)
    out = torch.empty_like(acc)
    rc = _build.library().cdll.fhe_cggi_scan(
        acc.data_ptr(), out.data_ptr(), a.data_ptr(), bsk_br.data_ptr(), *tables,
        acc.shape[0], bsk_br.shape[0], params.N, params.digits_g2, c, int(natural), *consts,
        _build.stream_handle(dev))
    _build.check(rc, "fhe_cggi_scan")
    return out


def blind_rotate(params, bsk_br: torch.Tensor, acc: torch.Tensor, a: torch.Tensor,
                 psi_pows_mont: torch.Tensor, q_lwe: int | None = None) -> torch.Tensor:
    """Kernel 3.  bsk_br [n, 2, dG2, 2, N] (the key in bit-reversed EVAL
    order, `rgsw.BootstrapKey.bsk_br`), acc [B, 2, N] (natural EVAL order,
    plain form), a [B, n] the mask mod q_lwe (default params.q),
    psi_pows_mont [2N], all int32 on one CUDA device.  Returns the rotated
    accumulator [B, 2, N] in natural EVAL order."""
    out = scan(params, bsk_br, acc, a, psi_pows_mont, natural=True, q_lwe=q_lwe)
    LAUNCHES["blind_rotate_wide" if is_wide(params) else "blind_rotate"] += 1
    return out


def occupancy(params, c: int, kind: str) -> int:
    """Resident blocks per SM of a kernel ("natural" or "bit-reversed"
    scan, or "step") at params' shape with c ciphertexts per block."""
    check_params(params)
    blocks = ctypes.c_int(0)
    rc = _build.library().cdll.fhe_cggi_occupancy(params.N, params.digits_g2, c, KINDS[kind],
                                                   ctypes.byref(blocks))
    _build.check(rc, "fhe_cggi_occupancy")
    return blocks.value
