"""Gate bootstrapping: test-vector init, CGGI blind rotation, extraction.

Port of fhe_tpu/tfhe/boot.py (reference: binfhe-base-scheme.cpp
BootstrapGateCore / EvalBinGate, rgsw-acc-cggi.cpp EvalAcc /
AddToAccCGGI).  The monomial (X^idx - 1) multiply happens analytically in
EVALUATION format: its value at psi^(2k+1) is psi^((2k+1) idx) - 1.

`blind_rotate` takes the plain PyTorch version (`blind_rotate_plain`,
the scan of fhe_tpu's boot.blind_rotate) for CPU tensors and the CUDA
kernel (`kernels.blind_rotate`) for CUDA tensors.  `run_accumulator`
picks the accumulator by the key's method and, for GINX, by `ntt_impl`,
as fhe_tpu does: this natural-order rotation, the bit-reversed ones of
`boot_pallas`, or the DM and LMKCDEY rotations of `acc`.  The GINX
rotations take the mask's modulus `a_modulus` (default params.q): a
functional bootstrap rotates by a mask mod its ciphertext's own modulus,
a power of two dividing 2N.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import blind_rotate as kbr
from ..math import ntt as nttmod
from ..math.modmath import add_mod, mont_mul, sub_mod
from . import acc as accmod
from . import lwe, rgsw
from .params import Gate, TfheParams

# the bootstrap keys of the three blind-rotation methods (GINX, AP, LMKCDEY)
Key = rgsw.BootstrapKey | accmod.DmKey | accmod.LmkcdeyKey


@functools.lru_cache(maxsize=None)
def psi_powers_mont(N: int, Q: int) -> np.ndarray:
    """[2N] table of psi^e mod Q in Montgomery form (psi = 2N-th root)."""
    return (accmod.psi_powers(N, Q) << 32) % Q


@functools.lru_cache(maxsize=None)
def _psi_powers_mont_words(N: int, Q: int, device: torch.device) -> torch.Tensor:
    """psi_powers_mont as an int32 tensor on `device`, made once per device."""
    return torch.from_numpy(psi_powers_mont(N, Q).astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _mono_sq_tables(N: int, Q: int) -> np.ndarray:
    """P[j, k] = psi^(2^j * (2k+1)) mod Q in Montgomery form, for the
    exponentiation-by-squaring monomial evaluation."""
    pows = psi_powers_mont(N, Q)
    logm = (2 * N).bit_length() - 1
    k = np.arange(N, dtype=np.int64)
    return np.stack([pows[((1 << j) * (2 * k + 1)) % (2 * N)] for j in range(logm)])


def monomial_pair_eval(params: TfheParams, idx: torch.Tensor, zero_low_bits: int = 0):
    """(X^idx - 1, X^-idx - 1) in EVALUATION Montgomery form, [B, N] int64.

    Plain version, by exponentiation by squaring as fhe_tpu computes it
    (the CUDA kernel looks the same values up in psi_powers_mont).  The
    negative-exponent values are the k-axis flip of the positive ones,
    since 2(N-1-k)+1 = -(2k+1) mod 2N.  zero_low_bits: idx is a multiple
    of 2^zero_low_bits, so those squaring rounds are skipped."""
    N, Q = params.N, params.Q
    tables = torch.from_numpy(_mono_sq_tables(N, Q)).to(idx.device)
    r1 = (1 << 32) % Q                                      # Montgomery 1
    w = torch.full(tuple(idx.shape) + (N,), r1, dtype=torch.int64, device=idx.device)
    for j in range(zero_low_bits, tables.shape[0]):
        bit = ((idx.to(torch.int64) >> j) & 1)[..., None]
        w = torch.where(bit == 1, mont_mul(w, tables[j], Q), w)
    return sub_mod(w, r1, Q), sub_mod(torch.flip(w, dims=[-1]), r1, Q)


def _rotation_indices(params: TfheParams, a: torch.Tensor, q: int):
    """idx_pos = ((q - a) mod q) * 2N/q mod 2N, and the count of its
    always-zero low bits."""
    N = params.N
    m_by = (2 * N) // q
    a64 = a.to(torch.int64)
    idx = (torch.where(a64 == 0, 0, q - a64) * m_by) & (2 * N - 1)
    zlb = (m_by.bit_length() - 1) if (m_by & (m_by - 1)) == 0 else 0
    return idx, zlb


def blind_rotate_plain(params: TfheParams, bsk: torch.Tensor, acc: torch.Tensor,
                       a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """CGGI accumulation, plain PyTorch version (any device).

    bsk: [steps, 2, dG2, 2, N] int32 (EVALUATION, Montgomery);
    acc: [B, 2, N] int32 (EVALUATION, plain form);
    a:   [B, steps] int32, the LWE mask mod a_modulus (default q).
    Returns the accumulator [B, 2, N] int32."""
    N, Q = params.N, params.Q
    plan = nttmod.make_plan(N, Q)
    idx, zlb = _rotation_indices(params, a, params.q if a_modulus is None else a_modulus)
    acc = acc.to(torch.int64)
    for i in range(bsk.shape[0]):
        bsk_i = bsk[i].to(torch.int64)                      # [2, dG2, 2, N]
        c = nttmod.inverse_butterfly(plan, acc)             # [B, 2, N]
        digits = rgsw.signed_digit_decompose(params, c)     # [B, dG2, N]
        d_eval = rgsw.ntt_signed_digits(plan, digits)
        ep_pos = rgsw.external_product(plan, d_eval, bsk_i[0])
        ep_neg = rgsw.external_product(plan, d_eval, bsk_i[1])
        mp, mn = monomial_pair_eval(params, idx[:, i], zlb)
        upd = add_mod(mont_mul(ep_pos, mp[:, None, :], Q),
                      mont_mul(ep_neg, mn[:, None, :], Q), Q)
        acc = add_mod(acc, upd, Q)
    return acc.to(torch.int32)


def blind_rotate(params: TfheParams, key: rgsw.BootstrapKey, acc: torch.Tensor,
                 a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """CGGI accumulation: the plain version on key.bsk for CPU tensors, the
    CUDA kernel on the key's cached bit-reversed copy (`key.bsk_br`) for
    CUDA tensors (raises on anything else, never falls back).  a is the
    mask mod a_modulus (default q)."""
    if acc.device.type == "cpu":
        return blind_rotate_plain(params, key.bsk, acc, a, a_modulus)
    return kbr.blind_rotate(params, key.bsk_br, acc, a,
                            _psi_powers_mont_words(params.N, params.Q, acc.device), a_modulus)


def gate_constants(params: TfheParams, gate: Gate, p: int = 4) -> tuple[int, int, int, int]:
    """Host: (lb, ub, lv, uv) for the gate test vector (BootstrapGateCore)."""
    Q, q = params.Q, params.q
    q_half = q >> 1
    q1 = params.gate_const(gate)
    q2 = (q1 + q_half) % q
    swap = q1 >= q2
    lb, ub = (q2, q1) if swap else (q1, q2)
    q2p = Q // (p * 2) + 1
    lv = q2p if swap else Q - q2p
    uv = Q - q2p if swap else q2p
    return lb, ub, lv, uv


def make_gate_test_vector(params: TfheParams, b: torch.Tensor, consts) -> torch.Tensor:
    """Accumulator init for gate bootstrapping, COEFFICIENT format
    (BootstrapGateCore): b [B] mod q -> [B, N] int32, with value lv or uv
    at coefficient j*factor and zero elsewhere."""
    N, q = params.N, params.q
    q_half = q >> 1
    lb, ub, lv, uv = consts
    factor = N // q_half
    j = torch.arange(q_half, dtype=torch.int64, device=b.device)
    bj = sub_mod(b.to(torch.int64)[:, None], j, q)          # [B, q/2]
    vals = torch.where((bj >= lb) & (bj < ub), lv, uv)
    out = torch.zeros(b.shape[0], q_half, factor, dtype=torch.int32, device=b.device)
    out[:, :, 0] = vals.to(torch.int32)
    return out.reshape(b.shape[0], N)


def make_func_test_vector(params: TfheParams, b: torch.Tensor, f_table: np.ndarray,
                          f_mod: int, ct_mod: int | None = None) -> torch.Tensor:
    """Accumulator init for a functional bootstrap (BootstrapFuncCore),
    COEFFICIENT format: b [B] mod ct_mod (default q) -> [B, N] int32 with
    Q/f_mod * f_table[(b - j) mod ct_mod] at coefficient j * 2N/ct_mod for
    j in [0, ct_mod/2), zero elsewhere.  f_table: ct_mod host values in
    [0, f_mod)."""
    N, Q = params.N, params.Q
    ct_mod = params.q if ct_mod is None else ct_mod
    f_table = np.asarray(f_table)
    if f_table.shape != (ct_mod,):
        raise ValueError(f"a LUT over Z_{ct_mod} needs {ct_mod} entries, got shape "
                         f"{f_table.shape}")
    if f_table.min() < 0 or f_table.max() >= f_mod:
        raise ValueError(f"LUT values must lie in [0, {f_mod})")
    factor = 2 * N // ct_mod
    tbl = torch.from_numpy(f_table.astype(np.int64) * (Q // f_mod)).to(b.device)
    j = torch.arange(ct_mod // 2, dtype=torch.int64, device=b.device)
    bj = sub_mod(b.to(torch.int64)[:, None], j, ct_mod)      # [B, ct_mod/2]
    out = torch.zeros(b.shape[0], ct_mod // 2, factor, dtype=torch.int32, device=b.device)
    out[:, :, 0] = tbl[bj].to(torch.int32)
    return out.reshape(b.shape[0], N)


def initial_acc(params: TfheParams, test_vec: torch.Tensor) -> torch.Tensor:
    """The accumulator (0, NTT(test_vec)), [B, 2, N] natural EVALUATION."""
    plan = nttmod.make_plan(params.N, params.Q, test_vec.device)
    acc1 = nttmod.ntt_forward(plan, test_vec)
    return torch.stack([torch.zeros_like(acc1), acc1], dim=1).contiguous()


def bootstrap_core(params: TfheParams, key: rgsw.BootstrapKey, test_vec: torch.Tensor,
                   a: torch.Tensor, a_modulus: int | None = None) -> torch.Tensor:
    """Blind-rotate a COEFFICIENT test vector by the mask `a` (mod
    a_modulus, default q); returns the accumulator [B, 2, N] in EVALUATION
    format."""
    return blind_rotate(params, key, initial_acc(params, test_vec), a, a_modulus)


# ntt_impl -> accumulator.  fhe_tpu's NTT names compute the same transform
# the TPU's way, so they run the default (natural-order, kernel 3) path.
ACCUMULATORS = {None: "mega2", "mega2": "mega2", "butterfly": "mega2", "pallas": "mega2",
                "mxu": "mega2", "lane": "mega2", "fourstep": "mega2",
                "mega": "mega", "fused": "fused"}


def accumulator(ntt_impl: str | None) -> str:
    """The accumulator that `ntt_impl` selects; ValueError if none does."""
    if ntt_impl not in ACCUMULATORS:
        raise ValueError(f"unknown ntt_impl {ntt_impl!r}; expected one of "
                         f"{sorted(map(str, ACCUMULATORS))}")
    return ACCUMULATORS[ntt_impl]


def run_accumulator(params: TfheParams, key: Key, test_vec: torch.Tensor,
                    a: torch.Tensor, ntt_impl: str | None = None,
                    a_modulus: int | None = None) -> torch.Tensor:
    """Accumulator dispatch (fhe_tpu boot.run_accumulator, and the LMKCDEY
    branch of its _finish_gate): test vector [B, N] COEFFICIENT ->
    accumulator [B, 2, N] natural EVALUATION.

    A DmKey runs `acc.blind_rotate_dm` and an LmkcdeyKey
    `acc.blind_rotate_lmkcdey_scan`, whose schedule needs the mask on the
    host (one copy a gate); both for every accepted `ntt_impl`, as in
    fhe_tpu, whose "mega"/"fused" only match a GINX key.  A GINX
    BootstrapKey: "mega", the bit-reversed whole scan (kernel 4); "fused",
    the bit-reversed scan one step per launch (kernel 5); otherwise the
    natural-order whole scan (kernel 3).  A mask mod a_modulus other than q
    (a functional bootstrap's) takes a GINX key, as in fhe_tpu."""
    impl = accumulator(ntt_impl)
    if a_modulus not in (None, params.q) and not isinstance(key, rgsw.BootstrapKey):
        raise ValueError(f"a mask mod {a_modulus} != q needs a GINX BootstrapKey, "
                         f"got {type(key).__name__}")
    if isinstance(key, accmod.DmKey):
        return accmod.blind_rotate_dm(params, key.bsk, initial_acc(params, test_vec), a)
    if isinstance(key, accmod.LmkcdeyKey):
        return accmod.blind_rotate_lmkcdey_scan(params, key.rgsw, key.auto,
                                                initial_acc(params, test_vec), a.cpu().numpy())
    if impl == "mega2":
        return bootstrap_core(params, key, test_vec, a, a_modulus)
    from . import boot_pallas
    core = boot_pallas.bootstrap_core_mega if impl == "mega" else boot_pallas.bootstrap_core_fused
    return core(params, key, test_vec, a, a_modulus)


def extract_lwe(params: TfheParams, acc: torch.Tensor, b_offset: int,
                p: int = 4) -> lwe.LweCiphertext:
    """Transpose + constant-term extraction (EvalBinGate).

    The a-poly transpose a(X) -> a(X^(2N-1)) is a flip in natural-order
    EVALUATION format; b = b_offset + acc1.coef[0] mod Q."""
    Q = params.Q
    plan = nttmod.make_plan(params.N, Q, acc.device)
    both = torch.stack([torch.flip(acc[:, 0, :], dims=[-1]), acc[:, 1, :]], dim=1)
    coef = nttmod.ntt_inverse(plan, both)
    b = add_mod(coef[:, 1, 0], b_offset, Q).to(torch.int32)
    return lwe.LweCiphertext(a=coef[:, 0, :], b=b, modulus=Q, pt_mod=p)


def _finish_gate(params: TfheParams, key: Key, gate: Gate,
                 comb: lwe.LweCiphertext, p: int, extended: bool,
                 ntt_impl: str | None) -> lwe.LweCiphertext:
    lead = comb.batch_shape
    a = comb.a.reshape(-1, params.n).contiguous()
    b = comb.b.reshape(-1)
    tv = make_gate_test_vector(params, b, gate_constants(params, gate, p))
    acc = run_accumulator(params, key, tv, a, ntt_impl)
    ct = extract_lwe(params, acc, params.Q // (p * 2) + 1, p)
    ct = lwe.LweCiphertext(a=ct.a.reshape(*lead, params.N), b=ct.b.reshape(lead),
                           modulus=params.Q, pt_mod=p)
    if extended:
        return ct
    return lwe.switch_ct_to_qn(params, key.ksk, ct)


def _to_gate_domain(params: TfheParams, key: Key,
                    ct: lwe.LweCiphertext) -> lwe.LweCiphertext:
    return lwe.switch_ct_to_qn(params, key.ksk, ct) if ct.modulus == params.Q else ct


def eval_bin_gate(params: TfheParams, key: Key, gate: Gate,
                  ct1: lwe.LweCiphertext, ct2: lwe.LweCiphertext,
                  extended: bool = False, ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """Two-input bootstrapped gate (binfhe-base-scheme.cpp EvalBinGate).

    ct1/ct2: [B]-batched LWE ciphertexts mod q, dim n; ntt_impl selects
    the accumulator (`run_accumulator`)."""
    comb = lwe.add(_to_gate_domain(params, key, ct1), _to_gate_domain(params, key, ct2))
    if gate in (Gate.XOR, Gate.XNOR, Gate.XOR_FAST, Gate.XNOR_FAST):
        comb = lwe.add(comb, comb)
    return _finish_gate(params, key, gate, comb, 4, extended, ntt_impl)


def eval_bin_gate_multi(params: TfheParams, key: Key, gate: Gate,
                        cts: list[lwe.LweCiphertext], extended: bool = False,
                        ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """3/4-input gates + MAJORITY (EvalBinGate vector overload)."""
    if gate not in (Gate.AND3, Gate.OR3, Gate.AND4, Gate.OR4, Gate.MAJORITY):
        raise ValueError(f"multi-input form not defined for {gate}")
    comb = _to_gate_domain(params, key, cts[0])
    for ct in cts[1:]:
        comb = lwe.add(comb, _to_gate_domain(params, key, ct))
    return _finish_gate(params, key, gate, comb, comb.pt_mod, extended, ntt_impl)


def bootstrap(params: TfheParams, key: Key, ct: lwe.LweCiphertext,
              extended: bool = False, ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """Plain refresh bootstrap (Bootstrap): shifts b by q/4, then runs the
    AND-gate pipeline on the single ciphertext."""
    q = params.q
    shifted = lwe.LweCiphertext(a=ct.a, b=add_mod(ct.b, q >> 2, q).to(torch.int32),
                                modulus=q, pt_mod=ct.pt_mod)
    return _finish_gate(params, key, Gate.AND, shifted, ct.pt_mod, extended, ntt_impl)
