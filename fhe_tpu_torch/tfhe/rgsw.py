"""RGSW bootstrapping keys, gadget decomposition, external product (CGGI).

Port of fhe_tpu/tfhe/rgsw.py (reference: rgsw-acc-cggi.cpp KeyGenCGGI,
rgsw-acc.cpp SignedDigitDecompose -- approximate gadget, first digit
dropped, balanced digits in [-Bg/2, Bg/2)).  The key is stored in
EVALUATION format and Montgomery form, so every external-product multiply
is one REDC.  Unlike fhe_tpu there is no Shoup dual of the key: the
Montgomery-only STD128 key (31.4 MiB) fits in the H100's 50 MB L2, a key
with duals would not.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..math import ntt as nttmod
from ..math.modmath import add_mod, mont_mul
from . import lwe
from .params import TfheParams


@dataclasses.dataclass(frozen=True)
class BootstrapKey:
    """CGGI bootstrap key.

    bsk: [n, 2, dG2, 2, N] int32 -- EVALUATION format, Montgomery form.
         axis 1: sign (0: s_i==1 key, 1: s_i==-1 key);
         axis 2: gadget row r (digit (r>>1)+1 of poly r&1);
         axis 3: RLWE column (a, b).
    ksk: LWE switching key N->n.
    bsk_br (made at first use, then cached on the key): bsk with its
         evaluation axis in bit-reversed order, the blind-rotation kernels'
         key on every accumulator; one copy per key and device, since
         `to` makes a new key.
    """
    bsk: torch.Tensor
    ksk: lwe.LweSwitchingKey

    def to(self, device) -> "BootstrapKey":
        return BootstrapKey(bsk=self.bsk.to(device), ksk=self.ksk.to(device))

    @functools.cached_property
    def bsk_br(self) -> torch.Tensor:
        return bsk_to_br(self.bsk)


def bsk_to_br(bsk: torch.Tensor) -> torch.Tensor:
    """A bootstrap key [..., N] with its evaluation axis in bit-reversed
    order (the permutation is an involution)."""
    N = bsk.shape[-1]
    perm = torch.from_numpy(nttmod.bit_reverse_perm(N).astype(np.int64)).to(bsk.device)
    return torch.index_select(bsk, -1, perm).contiguous()


def gadget_powers(params: TfheParams) -> np.ndarray:
    """Gpow_r = Bg^((r>>1)+1) mod Q for r in [0, dG2): the message scale of
    gadget row r under the approximate (first-digit-dropped) gadget."""
    return np.array([pow(params.base_g, (r >> 1) + 1, params.Q)
                     for r in range(params.digits_g2)], dtype=np.int64)


def bsk_gen(params: TfheParams, sk: lwe.LweSecretKey, sk_n: lwe.LweSecretKey,
            rng: np.random.Generator) -> torch.Tensor:
    """Generate the CGGI bootstrap key (rgsw-acc-cggi.cpp:40-100).

    Host sampling in fhe_tpu's draw order (uniform a, then Gaussian e);
    the NTTs and the assembly run on sk's device.
    Returns bsk [n, 2, dG2, 2, N] int32 (EVALUATION, Montgomery)."""
    Q, N, n = params.Q, params.N, params.n
    dg2 = params.digits_g2
    a = rng.integers(0, Q, size=(n, 2, dg2, N), dtype=np.int64)
    e = lwe._sample_error(rng, (n, 2, dg2, N), params.std_dev) % Q
    s = ternary_secret(sk)
    dev = sk.s.device
    plan = nttmod.make_plan(N, Q, dev)
    m = torch.from_numpy(np.stack([(s == 1), (s == -1)], axis=1).astype(np.int64)).to(dev)
    skn = torch.from_numpy(sk_n.s.cpu().numpy().astype(np.int64) % Q).to(dev, torch.int32)
    gpow = torch.from_numpy(gadget_powers(params)).to(dev)

    skn_mont = nttmod.to_mont(plan, nttmod.ntt_forward(plan, skn[None])[0])
    a_eval = nttmod.ntt_forward(plan, lwe._residues(a.reshape(-1, N), dev)).reshape(n, 2, dg2, N)
    e_eval = nttmod.ntt_forward(plan, lwe._residues(e.reshape(-1, N), dev)).reshape(n, 2, dg2, N)
    # the constant poly m*Gpow_r has the same value at every evaluation
    # point; row r adds it to column r&1
    msg = (m[:, :, None, None] * gpow[None, None, :, None]) % Q
    row_odd = (torch.arange(dg2, device=dev) & 1)[None, None, :, None]
    col0 = add_mod(a_eval, torch.where(row_odd == 0, msg, 0), Q)
    col1 = add_mod(e_eval, mont_mul(a_eval, skn_mont, Q), Q)
    col1 = add_mod(col1, torch.where(row_odd == 1, msg, 0), Q)
    bsk = torch.stack([col0, col1], dim=3).to(torch.int32)   # [n, 2, dg2, 2, N]
    return nttmod.to_mont(plan, bsk)


def ternary_secret(sk: lwe.LweSecretKey) -> np.ndarray:
    """sk.s as int64 numpy; ValueError unless it is ternary."""
    s = sk.s.cpu().numpy().astype(np.int64)
    if np.abs(s).max() > 1:
        # the two-column CMUX key can only represent ternary secrets; a
        # Gaussian secret (e.g. STD128_LMKCDEY's) would silently lose
        # every |s_i| >= 2 coefficient
        raise ValueError(
            "GINX bootstrap keys require a ternary secret "
            f"(got |s| up to {int(np.abs(s).max())}); Gaussian-secret "
            "paramsets must use method=LMKCDEY")
    return s


def signed_digit_decompose(params: TfheParams, c: torch.Tensor) -> torch.Tensor:
    """Approximate signed base-Bg decomposition (rgsw-acc.cpp:54-91).

    c: [..., 2, N] coefficients in [0, Q).
    Returns int64 digits [..., dG2, N] in [-Bg/2, Bg/2), interleaved as
    r = 2*t + poly (digit t+1 of poly `poly`), with digit 0 dropped.
    The closed form adds offset = sum_t (Bg/2) Bg^t, so every digit is an
    unsigned digit of (d + offset) minus Bg/2, with no borrow chain."""
    Q = params.Q
    g_bits = params.base_g.bit_length() - 1
    bg = params.base_g
    dgt = params.digits_g
    d = c.to(torch.int64)
    d = torch.where(d >= (Q >> 1), d - Q, d)
    offset = sum((bg >> 1) << (g_bits * t) for t in range(dgt))
    u = d + offset
    outs = [((u >> (g_bits * t)) & (bg - 1)) - (bg >> 1) for t in range(1, dgt)]
    st = torch.stack(outs, dim=-3)                           # [..., dg, 2, N]
    return st.reshape(st.shape[:-3] + (2 * (dgt - 1), st.shape[-1]))


def ntt_signed_digits(plan: nttmod.NttPlan, digits: torch.Tensor) -> torch.Tensor:
    """Forward NTT (plain version) of small signed digits lifted to [0, Q)."""
    return nttmod.forward_butterfly(plan, digits % plan.q)


def external_product(plan: nttmod.NttPlan, d_eval: torch.Tensor,
                     bsk_rows: torch.Tensor) -> torch.Tensor:
    """sum_r d_eval[..., r, :] * bsk_rows[r, c, :] -> [..., 2, N] (int64).

    d_eval: [..., dG2, N] plain form (EVALUATION);
    bsk_rows: [dG2, 2, N] Montgomery form (EVALUATION).
    Montgomery REDC products: the result is in PLAIN form."""
    prod = mont_mul(d_eval[..., :, None, :], bsk_rows, plan.q)
    return prod.sum(dim=-3) % plan.q
