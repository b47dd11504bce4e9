"""2-limb RNS ring accumulator: TFHE gate bootstrapping for Q >= 2^31.

Port of fhe_tpu/tfhe/rgsw_rns.py.  The STD192*, STD128Q_3/_4 and TOY_RNS
sets have a ring modulus of 35 to 51 bits, kept as two NTT primes
Q = q1 q2 (`params.moduli_rns`, each below 2^30), so the accumulator holds
[B, 2, L = 2, N] residues and every NTT runs limb-stacked
(`lattice.rns`: the limb-stacked kernels 1 and 2 on the card, one launch
a transform for both limbs).  The rest is int64 PyTorch ops: the
blind rotation is a Python loop over the n steps, each one inverse and one
forward NTT launch.

The signed gadget decomposition needs each coefficient's integer value:
Garner (v = x1 + q1 t, t = (x2 - x1) q1^-1 mod q2) rebuilds it in int64,
then it is centred and split into balanced base-Bg digits.  fhe_tpu adds
the whole offset sum_t (Bg/2) Bg^t to a 64-bit word, which wraps where
that offset passes 2^64 (STD128Q_3/_4: Bg = 2^25, dG = 3); here the top
digit takes its Bg/2 alone, so every digit is exact on every set and equal
to fhe_tpu's where fhe_tpu is exact.  Likewise the mod switch Q -> q_ks
rounds exactly from the Garner form, where fhe_tpu's uint64 product
x q_ks wraps (Q q_ks reaches 2^67).  Both faults of fhe_tpu are in
ROADMAP.md queue 3.

Only GINX keys and two-input gates have an RNS path, as in fhe_tpu.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..lattice import rns
from . import boot, lwe, rgsw
from .params import Gate, TfheParams

R = 1 << 32          # the Montgomery radix of the key's form


@dataclasses.dataclass(frozen=True)
class RnsKey:
    """CGGI bootstrap key over the RNS ring.

    bsk: [n, 2, dG2, 2, L, N] int32, EVALUATION format, Montgomery form
         (the axes of rgsw.BootstrapKey, with the limb axis before N);
    ksk: LWE switching key N -> n, mod q_ks."""
    bsk: torch.Tensor
    ksk: lwe.LweSwitchingKey

    def to(self, device) -> "RnsKey":
        return RnsKey(bsk=self.bsk.to(device), ksk=self.ksk.to(device))


def _plan(params: TfheParams, device) -> rns.RnsPlan:
    return rns.make_rns_plan(params.N, tuple(params.moduli_rns), device)


@functools.lru_cache(maxsize=None)
def _limb_consts(params: TfheParams, device: torch.device):
    """Per limb as [L, 1] int64 on device: R mod q_l and R^-1 mod q_l."""
    col = lambda vals: torch.tensor(vals, dtype=torch.int64, device=device)[:, None]
    return (col([R % q for q in params.moduli_rns]),
            col([pow(R, -1, q) for q in params.moduli_rns]))


def crt(params: TfheParams, x: torch.Tensor) -> torch.Tensor:
    """Garner: [..., 2, N] residues (limb axis -2) -> [..., N] int64 v in
    [0, Q) with v = x1 + q1 t, t = (x2 - x1) q1^-1 mod q2 (x2 - x1 lifted
    by a multiple of q2 above q1, so one remainder makes t)."""
    q1, q2 = params.moduli_rns
    x1 = x[..., 0, :].to(torch.int64)
    t = (x[..., 1, :] - x1 + -(-q1 // q2) * q2) * pow(q1, -1, q2) % q2
    return x1 + q1 * t


def signed_digit_decompose_rns(params: TfheParams, c: torch.Tensor) -> torch.Tensor:
    """[..., 2, L, N] COEFFICIENT residues -> balanced base-Bg digits
    [..., dG2, N] int32 in [-Bg/2, Bg/2), digit 0 dropped, rows
    r = 2 (t - 1) + poly for digit t.

    The closed form of fhe_tpu, exactly: with u = d + sum_t (Bg/2) Bg^t
    (d the centred coefficient), digit t is ((u >> t g) mod Bg) - Bg/2.
    The offset's top term, a multiple of Bg^(dG-1), changes only the top
    digit, by Bg/2, so it is added there and u never needs more than 52
    bits."""
    Q = params.Q
    bg, dgt = params.base_g, params.digits_g
    g_bits = bg.bit_length() - 1
    half = bg >> 1
    v = crt(params, c)
    u = torch.where(v >= Q // 2, v - Q, v) + sum(half << (g_bits * t) for t in range(dgt - 1))
    outs = []
    for t in range(1, dgt):
        w = u >> (g_bits * t)
        if t == dgt - 1:
            w = w + half
        outs.append(((w & (bg - 1)) - half).to(torch.int32))
    st = torch.stack(outs, dim=-3)                            # [..., dG-1, 2, N]
    return st.reshape(st.shape[:-3] + (2 * (dgt - 1), st.shape[-1]))


def ntt_digits_rns(params: TfheParams, digits: torch.Tensor) -> torch.Tensor:
    """Signed digits [..., dG2, N] -> EVALUATION residues [..., dG2, L, N]
    int32 (one limb-stacked forward NTT)."""
    plan = _plan(params, digits.device)
    d = digits.to(torch.int32)[..., None, :]
    return rns.ntt_forward(plan, torch.where(d < 0, d + plan.q.to(torch.int32), d))


def key_sum_rns(params: TfheParams, d_eval: torch.Tensor, bsk_rows: torch.Tensor) -> torch.Tensor:
    """sum_r d_eval[..., r, :, :] * bsk_rows[..., r, c, :, :] -> [..., 2, L, N]
    int64, unreduced: below dG2 q_l^2 < 2^55.

    d_eval: [..., dG2, L, N] plain; bsk_rows: [..., dG2, 2, L, N]
    Montgomery (broadcast against d_eval's leading axes), so this is R
    times the external product (mod q_l)."""
    d = d_eval.to(torch.int64)
    b = bsk_rows.to(torch.int64)
    out = d[..., 0, None, :, :] * b[..., 0, :, :, :]
    for r in range(1, b.shape[-4]):
        out.addcmul_(d[..., r, None, :, :], b[..., r, :, :, :])
    return out


def external_product_rns(params: TfheParams, d_eval: torch.Tensor,
                         bsk_rows: torch.Tensor) -> torch.Tensor:
    """sum_r d_eval[..., r, :, :] * bsk_rows[..., r, c, :, :] * R^-1 mod q_l
    -> [..., 2, L, N] int64, plain form (fhe_tpu's dG2 Montgomery products
    and sums): `key_sum_rns` reduced once."""
    plan = _plan(params, d_eval.device)
    _, rinv = _limb_consts(params, d_eval.device)
    return key_sum_rns(params, d_eval, bsk_rows) % plan.q * rinv % plan.q


@functools.lru_cache(maxsize=None)
def _mono_table(params: TfheParams, device: torch.device, scale: str) -> torch.Tensor:
    """[L, 2N] int64: (psi_l^e - 1) s mod q_l, psi_l the 2N-th root of limb
    l's NTT plan, s = R (scale "R": fhe_tpu's Montgomery form) or R^-1
    ("1/R": the blind rotation's, which cancels the key's R)."""
    rows = []
    for q in params.moduli_rns:
        s = R % q if scale == "R" else pow(R, -1, q)
        rows.append((boot.psi_powers_mont(params.N, q) * pow(R, -1, q) - 1) % q * s % q)
    return torch.from_numpy(np.stack(rows)).to(device)


def _monomial_pair(params: TfheParams, idx: torch.Tensor,
                   table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, L, N] each: the EVALUATION values table[(2k+1) idx mod 2N] of
    X^idx - 1 and, flipped along k (2(N-1-k)+1 = -(2k+1) mod 2N), of
    X^-idx - 1."""
    N = params.N
    k2 = 2 * torch.arange(N, dtype=torch.int64, device=idx.device) + 1
    e = (idx.to(torch.int64)[:, None] * k2) & (2 * N - 1)         # [B, N]
    w = table[:, e].movedim(0, -2)                                  # [B, L, N]
    return w, torch.flip(w, dims=[-1])


def monomial_pair_rns(params: TfheParams, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(X^idx - 1, X^-idx - 1) in EVALUATION Montgomery form, [B, L, N]
    int64 each, for idx [B]: looked up in a table of psi_l's powers
    (fhe_tpu computes the same residues by squaring)."""
    return _monomial_pair(params, idx, _mono_table(params, idx.device, "R"))


# ---------------------------------------------------------------------------
# bootstrap key + blind rotation
# ---------------------------------------------------------------------------

def bsk_gen_rns(params: TfheParams, sk: lwe.LweSecretKey, sk_n: lwe.LweSecretKey,
                rng: np.random.Generator) -> torch.Tensor:
    """CGGI bootstrap key over the RNS ring, [n, 2, dG2, 2, L, N] int32
    (EVALUATION, Montgomery).  Host draws in fhe_tpu's order (uniform a
    limb by limb, then the Gaussian e); the NTTs and the assembly run on
    sk's device."""
    mods = tuple(params.moduli_rns)
    N, n, dg2 = params.N, params.n, params.digits_g2
    shape = (n, 2, dg2, N)
    a = np.stack([rng.integers(0, q, size=shape, dtype=np.int64) for q in mods], axis=-2)
    e = lwe._sample_error(rng, shape, params.std_dev)
    s = rgsw.ternary_secret(sk)
    dev = sk.s.device
    plan = _plan(params, dev)
    q = plan.q
    r1, _ = _limb_consts(params, dev)
    m = torch.from_numpy(np.stack([(s == 1), (s == -1)], axis=1).astype(np.int64)).to(dev)
    gpow = torch.tensor([[g % ql for ql in mods] for g in rgsw.gadget_powers(params).tolist()],
                        dtype=torch.int64, device=dev)                    # [dg2, L]
    a_eval = rns.ntt_forward(plan, lwe._residues(a, dev)).to(torch.int64)
    del a
    e_r = torch.from_numpy(e).to(dev)[..., None, :] % q
    e_eval = rns.ntt_forward(plan, e_r.to(torch.int32))
    del e, e_r
    skn = sk_n.s.to(dev, torch.int64)[None, :] % q
    skn_eval = rns.ntt_forward(plan, skn.to(torch.int32)).to(torch.int64)     # [L, N]
    # the constant poly m Gpow_r has the same value at every evaluation
    # point; row r adds it to column r & 1
    msg = m[:, :, None, None, None] * gpow[None, None, :, :, None]          # [n, 2, dg2, L, 1]
    row_odd = (torch.arange(dg2, device=dev) & 1).bool()[:, None, None]
    col0 = (a_eval + torch.where(row_odd, 0, msg)) % q
    col1 = (e_eval + a_eval * skn_eval % q + torch.where(row_odd, msg, 0)) % q
    del a_eval, e_eval
    bsk = torch.stack([col0, col1], dim=3)                                  # [n, 2, dg2, 2, L, N]
    return (bsk * r1 % q).to(torch.int32)


def blind_rotate_rns(params: TfheParams, bsk: torch.Tensor, acc: torch.Tensor,
                     a: torch.Tensor) -> torch.Tensor:
    """CGGI accumulation over the 2-limb ring: bsk [n, 2, dG2, 2, L, N];
    acc [B, 2, L, N] int32 EVALUATION; a [B, n] mod q.  Each step: inverse
    NTT, digits, forward NTT of the digits, both signs' key sums, then
    acc + sum_sign key_sum * (X^(+-idx) - 1) R^-1 mod q_l (the R of the key
    cancelled by the monomials' R^-1: fhe_tpu's residues).  The key sums
    are reduced first only where dG2 q^3 products could pass 2^63
    (STD128Q_3/_4).  Returns [B, 2, L, N] int32."""
    plan = _plan(params, acc.device)
    q_max = max(params.moduli_rns)
    reduce_sums = 2 * params.digits_g2 * (q_max - 1) ** 3 + q_max >= 1 << 63
    table = _mono_table(params, acc.device, "1/R")
    idx, _ = boot._rotation_indices(params, a, params.q)
    for i in range(bsk.shape[0]):
        c = rns.ntt_inverse(plan, acc)
        d_eval = ntt_digits_rns(params, signed_digit_decompose_rns(params, c))
        sums = key_sum_rns(params, d_eval[:, None], bsk[i])         # [B, sign, 2, L, N]
        if reduce_sums:
            sums %= plan.q
        t = acc.to(torch.int64)
        for sums_s, mono_s in zip(sums.unbind(1), _monomial_pair(params, idx[:, i], table)):
            t.addcmul_(sums_s, mono_s[:, None])
        acc = (t % plan.q).to(torch.int32)
    return acc


# ---------------------------------------------------------------------------
# gate pipeline
# ---------------------------------------------------------------------------

def _gate_test_vector_rns(params: TfheParams, b: torch.Tensor, gate: Gate,
                          p: int = 4) -> torch.Tensor:
    """[B, L, N] int32 COEFFICIENT residues of the gate test vector for
    b [B] mod q: lv or uv (mod Q) at coefficient j N/(q/2), zero elsewhere."""
    N, q = params.N, params.q
    q_half = q >> 1
    lb, ub, lv, uv = boot.gate_constants(params, gate, p)
    plan = _plan(params, b.device)
    j = torch.arange(q_half, dtype=torch.int64, device=b.device)
    bj = (b.to(torch.int64)[:, None] - j) % q
    vals = torch.where((bj >= lb) & (bj < ub), lv, uv)                 # [B, q/2] int64
    out = torch.zeros(b.shape[0], plan.L, q_half, N // q_half, dtype=torch.int32,
                      device=b.device)
    out[..., 0] = (vals[:, None, :] % plan.q).to(torch.int32)
    return out.reshape(b.shape[0], plan.L, N)


def switch_to_qks(params: TfheParams, v: torch.Tensor) -> torch.Tensor:
    """floor(v q_ks / Q + 1/2) mod q_ks for int64 v in [0, Q), exactly.

    With v = x1 + q1 t (x1 = v mod q1) and t q_ks = A q2 + B, v q_ks =
    A Q + C, C = B q1 + x1 q_ks < 2^61, so the rounded quotient is
    A + floor((C + Q//2) / Q): no product passes 2^62."""
    q1, q2 = params.moduli_rns
    Q, qks = params.Q, params.q_ks
    x1, t = v % q1, v // q1
    A, B = t * qks // q2, t * qks % q2
    return (A + (B * q1 + x1 * qks + Q // 2) // Q) % qks


def extract_switch_rns(params: TfheParams, acc: torch.Tensor, b_offset: int,
                       p: int = 4) -> lwe.LweCiphertext:
    """Sample extraction (one limb-stacked inverse NTT, Garner) and the
    exact mod switch Q -> q_ks: acc [B, 2, L, N] EVALUATION -> an LWE
    ciphertext of dimension N mod q_ks."""
    plan = _plan(params, acc.device)
    both = torch.stack([torch.flip(acc[:, 0], dims=[-1]), acc[:, 1]], dim=1)   # a(X^{2N-1})
    v = crt(params, rns.ntt_inverse(plan, both))                     # [B, 2, N]
    b = (v[:, 1, 0] + b_offset) % params.Q
    return lwe.LweCiphertext(a=switch_to_qks(params, v[:, 0]).to(torch.int32),
                             b=switch_to_qks(params, b).to(torch.int32),
                             modulus=params.q_ks, pt_mod=p)


def _extract_and_switch(params: TfheParams, acc: torch.Tensor, b_offset: int,
                        ksk: lwe.LweSwitchingKey, p: int) -> lwe.LweCiphertext:
    """Extraction and mod switch to q_ks, key switch to dimension n, mod
    switch to q."""
    ct = lwe.key_switch(params, ksk, extract_switch_rns(params, acc, b_offset, p))
    return lwe.mod_switch(ct, params.q)


def initial_acc_rns(params: TfheParams, test_vec: torch.Tensor) -> torch.Tensor:
    """The accumulator (0, NTT(test_vec)), [B, 2, L, N] EVALUATION."""
    acc1 = rns.ntt_forward(_plan(params, test_vec.device), test_vec)
    return torch.stack([torch.zeros_like(acc1), acc1], dim=1)


def eval_bin_gate_rns(params: TfheParams, key: RnsKey, gate: Gate, ct1: lwe.LweCiphertext,
                      ct2: lwe.LweCiphertext, p: int = 4) -> lwe.LweCiphertext:
    """Two-input bootstrapped gate on the 2-limb ring (the Q >= 2^31
    counterpart of boot.eval_bin_gate): ct1, ct2 batched mod q, dim n."""
    for ct in (ct1, ct2):
        if ct.modulus != params.q:
            raise ValueError(f"{params.name}: the RNS gate takes ciphertexts mod q = "
                             f"{params.q}, got mod {ct.modulus}")
    comb = lwe.add(ct1, ct2)
    if gate in (Gate.XOR, Gate.XNOR, Gate.XOR_FAST, Gate.XNOR_FAST):
        comb = lwe.add(comb, comb)
    lead = comb.batch_shape
    a = comb.a.reshape(-1, params.n).contiguous()
    tv = _gate_test_vector_rns(params, comb.b.reshape(-1), gate, p)
    rot = blind_rotate_rns(params, key.bsk, initial_acc_rns(params, tv), a)
    ct = _extract_and_switch(params, rot, params.Q // (p * 2) + 1, key.ksk, p)
    return lwe.LweCiphertext(a=ct.a.reshape(*lead, params.n), b=ct.b.reshape(lead),
                             modulus=ct.modulus, pt_mod=p)
