"""Alternative blind-rotation accumulators: DM (FHEW/AP) and LMKCDEY.

Port of fhe_tpu/tfhe/acc.py (reference: rgsw-acc-dm.cpp KeyGenAcc /
EvalAcc, rgsw-acc-lmkcdey.cpp KeyGenAcc / EvalAcc / KeyGenAuto /
Automorphism).  Host randomness comes in fhe_tpu's draw order (uniform a,
then Gaussian e, per key block), so one seed gives byte-identical keys; the
NTTs and the key assembly run on the secret key's device.

* DM/AP: the n*dR steps run over the whole batch in lockstep; each step
  selects its key per ciphertext by digit value (`index_select` over the
  [Br-1] axis), and a zero digit is a masked no-op (`torch.where`).
* LMKCDEY: the discrete-log grouping of the mask is data-dependent, so
  `lmk_schedule` compiles it on the host (numpy) into a uniform op stream
  of T slots, and `blind_rotate_lmkcdey_scan` runs the slots as a Python
  loop of masked keyed automorphisms and external products.  A branch that
  no ciphertext of a slot needs is skipped (the host knows from the
  schedule); the output bytes are the same.  `blind_rotate_lmkcdey`, the
  per-ciphertext walk of the reference's EvalAcc, is the anchor the tests
  hold the scan against.  LMKCDEY needs q == 2N.

Nothing here is a kernel of its own: on the card every NTT goes through
`math.ntt.ntt_forward` / `ntt_inverse`, i.e. kernels 1 and 2, and the rest
is PyTorch ops around them.  Monomials X^m are never built: their
EVALUATION values are gathered from the table of powers of psi.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..math import ntt as nttmod
from ..math.modmath import add_mod
from . import lwe, rgsw
from .params import TfheParams


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def psi_powers(N: int, Q: int) -> np.ndarray:
    """[2N] psi^e mod Q (plain form), psi the NTT plan's 2N-th root."""
    psi = nttmod.make_plan(N, Q).psi
    out, acc = np.zeros(2 * N, dtype=np.int64), 1
    for e in range(2 * N):
        out[e] = acc
        acc = acc * psi % Q
    return out


def _monomial_eval(params: TfheParams, mm: torch.Tensor) -> torch.Tensor:
    """EVALUATION values of X^mm (plain form) for an int64 exponent tensor
    mm (any shape), mod Q, on mm's device: out[..., k] = psi^((2k+1) mm)."""
    N = params.N
    pows = torch.from_numpy(psi_powers(N, params.Q)).to(mm.device)
    k2 = 2 * torch.arange(N, dtype=torch.int64, device=mm.device) + 1
    return pows[(mm[..., None] * k2) % (2 * N)]


def _rgsw_encrypt_monomials(params: TfheParams, sk_n: lwe.LweSecretKey,
                            mm: np.ndarray, rng: np.random.Generator) -> torch.Tensor:
    """Batch RGSW encryptions of X^mm[...] under the ring secret.

    mm: [...] int exponents in [0, 2N).  Returns [..., dG2, 2, N] int32,
    EVALUATION, Montgomery form (the layout of rgsw.BootstrapKey rows)."""
    Q, N, dg2 = params.Q, params.N, params.digits_g2
    shape = mm.shape + (dg2, N)
    a = rng.integers(0, Q, size=shape, dtype=np.int64)
    e = lwe._sample_error(rng, shape, params.std_dev) % Q
    dev = sk_n.s.device
    plan = nttmod.make_plan(N, Q, dev)
    a_eval = nttmod.ntt_forward(plan, lwe._residues(a.reshape(-1, N), dev)).reshape(shape)
    del a
    e_eval = nttmod.ntt_forward(plan, lwe._residues(e.reshape(-1, N), dev)).reshape(shape)
    del e
    mono = _monomial_eval(params, torch.from_numpy(mm.astype(np.int64)).to(dev))
    gpow = torch.from_numpy(rgsw.gadget_powers(params)).to(dev)
    msg = mono[..., None, :] * gpow[:, None] % Q                # [..., dg2, N]
    del mono
    skn_eval = _skn_eval(params, sk_n, plan).to(torch.int64)
    row_odd = (torch.arange(dg2, device=dev) & 1).bool()[:, None]
    col0 = add_mod(a_eval, torch.where(row_odd, 0, msg), Q).to(torch.int32)
    col1 = add_mod(e_eval, a_eval.to(torch.int64) * skn_eval % Q, Q)
    del a_eval, e_eval
    col1 = add_mod(col1, torch.where(row_odd, msg, 0), Q).to(torch.int32)
    return nttmod.to_mont(plan, torch.stack([col0, col1], dim=-2))


def _skn_eval(params: TfheParams, sk_n: lwe.LweSecretKey, plan) -> torch.Tensor:
    """The ring secret in EVALUATION form, [N] int32 on the plan's device."""
    skn = sk_n.s.to(plan.fwd_w.device, torch.int64) % params.Q
    return nttmod.ntt_forward(plan, skn.to(torch.int32)[None])[0]


def _ntt_digits(plan: nttmod.NttPlan, digits: torch.Tensor) -> torch.Tensor:
    """Forward NTT of small signed digits lifted to int32 residues in
    [0, Q): kernel 1 on the card (`rgsw.ntt_signed_digits` is the plain
    version on every device and must not run here)."""
    return nttmod.ntt_forward(plan, (digits % plan.q).to(torch.int32))


def _key_product(plan: nttmod.NttPlan, d_eval: torch.Tensor,
                 keys: torch.Tensor) -> torch.Tensor:
    """sum_r d_eval[:, r, :] * keys[:, r, c, :] * R^-1 mod q -> [B, 2, N]
    int64, plain form: the residue of `rgsw.external_product`'s dG2
    Montgomery products, from one reduction after the sum where
    dG2 (q-1)^2 < 2^63.  d_eval [B, dG2, N] plain, keys [B, dG2, 2, N]
    Montgomery (one key per ciphertext)."""
    q = plan.q
    prod = d_eval.to(torch.int64)[:, :, None, :] * keys
    if keys.shape[-3] * (q - 1) ** 2 >= 1 << 63:
        prod = prod % q
    return prod.sum(dim=-3) % q * pow(1 << 32, -1, q) % q


def _external(params: TfheParams, plan: nttmod.NttPlan, acc: torch.Tensor,
              key: torch.Tensor) -> torch.Tensor:
    """External product of acc [B, 2, N] EVAL with per-ciphertext RGSW keys
    [B, dG2, 2, N] -> [B, 2, N] int32 EVAL (one inverse and one forward NTT)."""
    c = nttmod.ntt_inverse(plan, acc)
    d_eval = _ntt_digits(plan, rgsw.signed_digit_decompose(params, c))
    return _key_product(plan, d_eval, key).to(torch.int32)


# ---------------------------------------------------------------------------
# DM (AP) accumulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DmKey:
    """bsk: [n*dR, Br-1, dG2, 2, N] int32 (EVALUATION, Montgomery):
    step i*dR + k, value v-1 holds RGSW(X^{s_i * v * Br^k * 2N/q}).
    ksk: LWE switching key N -> n."""
    bsk: torch.Tensor
    ksk: lwe.LweSwitchingKey

    def to(self, device) -> "DmKey":
        return DmKey(bsk=self.bsk.to(device), ksk=self.ksk.to(device))


def dm_bsk_gen(params: TfheParams, sk: lwe.LweSecretKey, sk_n: lwe.LweSecretKey,
               rng: np.random.Generator) -> torch.Tensor:
    """KeyGenAcc for DM (rgsw-acc-dm.cpp:39-60)."""
    q, n, N = params.q, params.n, params.N
    Br, dR = params.base_r, params.digits_r
    s = sk.s.cpu().numpy().astype(np.int64)                 # [n], small signed
    # m[i, k, v] = s_i * v * Br^k; exponent ((m mod q) + q) % q * 2N/q
    m = (s[:, None, None] * (Br ** np.arange(dR))[None, :, None]
         * np.arange(1, Br)[None, None, :])
    mm = ((m % q) + q) % q * (2 * N // q)                   # [n, dR, Br-1]
    bsk = _rgsw_encrypt_monomials(params, sk_n, mm, rng)
    return bsk.reshape(n * dR, Br - 1, params.digits_g2, 2, N)


def _dm_digits(params: TfheParams, a: torch.Tensor) -> torch.Tensor:
    """The base-Br digits of (q - a) mod q, step-major: [n*dR, B] int64,
    row i*dR + k digit k of mask entry i."""
    q, Br, dR = params.q, params.base_r, params.digits_r
    a = a.to(torch.int64)
    rest = torch.where(a == 0, 0, q - a)
    digs = []
    for _ in range(dR):
        digs.append(rest % Br)
        rest = rest // Br
    return torch.stack(digs, dim=-1).reshape(a.shape[0], -1).T


def blind_rotate_dm(params: TfheParams, bsk: torch.Tensor, acc: torch.Tensor,
                    a: torch.Tensor) -> torch.Tensor:
    """DM accumulation (rgsw-acc-dm.cpp EvalAcc :62-77), batched.

    acc [B, 2, N] int32 EVAL; a [B, n] int32 mod q.  Per step one inverse
    NTT of [B, 2, N] and one forward NTT of [B, dG2, N]; returns acc."""
    plan = nttmod.make_plan(params.N, params.Q, acc.device)
    vals = _dm_digits(params, a)
    acc = acc.to(torch.int32)
    for i in range(bsk.shape[0]):
        v = vals[i]
        key = torch.index_select(bsk[i], 0, v.clamp(min=1) - 1)  # [B, dG2, 2, N]
        acc = torch.where((v > 0)[:, None, None], _external(params, plan, acc, key), acc)
    return acc


# ---------------------------------------------------------------------------
# LMKCDEY accumulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LmkcdeyKey:
    """rgsw: [n, dG2, 2, N] int32 RGSW(X^{s_i}) keys;
    auto: [w+1, dGa, 2, N] int32 automorphism keys, index 0 for
    X -> X^{2N-5}, index j >= 1 for X -> X^{5^j} (both EVALUATION,
    Montgomery); ksk: LWE switching key N -> n."""
    rgsw: torch.Tensor
    auto: torch.Tensor
    ksk: lwe.LweSwitchingKey

    def to(self, device) -> "LmkcdeyKey":
        return LmkcdeyKey(rgsw=self.rgsw.to(device), auto=self.auto.to(device),
                          ksk=self.ksk.to(device))


def check_lmkcdey(params: TfheParams) -> None:
    """ValueError for a parameter set LMKCDEY cannot key.  fhe_tpu stops on
    both with a bare AssertionError (acc.py:213, and make_plan's prime
    assert through acc.py:76)."""
    if params.q != 2 * params.N:
        raise ValueError(
            f"{params.name}: LMKCDEY needs q == 2N (round-to-odd exponents), "
            f"got q = {params.q}, 2N = {2 * params.N}")
    if params.moduli_rns:
        raise ValueError(
            f"{params.name}: LMKCDEY keys on a 2-limb RNS ring (Q = "
            f"{' * '.join(map(str, params.moduli_rns))}) cannot be made; fhe_tpu "
            "cannot key this set either (its NTT plan needs a prime Q; ROADMAP.md "
            "queue 3)")


def _auto_perm(N: int, k: int) -> np.ndarray:
    """Evaluation-index permutation of the automorphism X -> X^k."""
    i = np.arange(N, dtype=np.int64)
    return ((2 * i + 1) * k % (2 * N) - 1) // 2


def _keygen_auto(params: TfheParams, skn_eval: torch.Tensor, k: int,
                 rng: np.random.Generator) -> torch.Tensor:
    """KeyGenAuto (rgsw-acc-lmkcdey.cpp:208-228): switch s(X^k) -> s with
    dGa = digitsG - 1 rows (approximate single-poly gadget).
    skn_eval: [N] int64 EVAL; returns [dGa, 2, N] int32 plain form."""
    Q, N = params.Q, params.N
    dga = params.digits_g - 1
    dev = skn_eval.device
    plan = nttmod.make_plan(N, Q, dev)
    sk_auto = skn_eval[torch.from_numpy(_auto_perm(N, k)).to(dev)]
    gpow = torch.tensor([pow(params.base_g, t + 1, Q) for t in range(dga)],
                        dtype=torch.int64, device=dev)
    a = torch.from_numpy(rng.integers(0, Q, size=(dga, N), dtype=np.int64)).to(dev)
    e = lwe._sample_error(rng, (dga, N), params.std_dev) % Q
    e_eval = nttmod.ntt_forward(plan, lwe._residues(e, dev)).to(torch.int64)
    col1 = (e_eval + (Q - sk_auto) * gpow[:, None] % Q + a * skn_eval % Q) % Q
    return torch.stack([a, col1], dim=1).to(torch.int32)


def lmkcdey_key_gen(params: TfheParams, sk: lwe.LweSecretKey, sk_n: lwe.LweSecretKey,
                    rng: np.random.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """KeyGenAcc for LMKCDEY (rgsw-acc-lmkcdey.cpp:39-68): (rgsw, auto)."""
    check_lmkcdey(params)
    q, N, w = params.q, params.N, params.num_auto_keys
    s = sk.s.cpu().numpy().astype(np.int64)
    mm = ((s % q) + q) % q * (2 * N // q)                   # [n]
    rgsw_keys = _rgsw_encrypt_monomials(params, sk_n, mm, rng)
    plan = nttmod.make_plan(N, params.Q, sk_n.s.device)
    skn_eval = _skn_eval(params, sk_n, plan).to(torch.int64)
    M = 2 * N
    autos = [_keygen_auto(params, skn_eval, M - 5, rng)]
    autos += [_keygen_auto(params, skn_eval, pow(5, j, M), rng) for j in range(1, w + 1)]
    return rgsw_keys, nttmod.to_mont(plan, torch.stack(autos))


def _log_gen_table(N: int) -> np.ndarray:
    """m_logGen (rgsw-cryptoparameters.cpp:117-127): logGen[5^i] = i,
    logGen[-5^i] = -i, logGen[2N-1] = 2N (flag for -1), logGen[1] = 0."""
    M = 2 * N
    t = np.zeros(M, dtype=np.int64)
    t[M - 1] = M
    g = 1
    for i in range(1, N // 2):
        g = (g * 5) % M
        t[g] = i
        t[M - g] = -i
    return t


def sdd_single(params: TfheParams, c: torch.Tensor) -> torch.Tensor:
    """Approximate signed decomposition of one poly per row (rgsw-acc.cpp:94),
    first digit dropped: c [..., N] in [0, Q) -> int64 [..., dGa, N] in
    [-Bg/2, Bg/2).  The closed form of `rgsw.signed_digit_decompose`; equal
    to fhe_tpu's sequential-borrow `_sdd_single` and to its `_sdd_single_jnp`."""
    Q = params.Q
    g_bits = params.base_g.bit_length() - 1
    bg = params.base_g
    dgt = params.digits_g
    d = c.to(torch.int64)
    d = torch.where(d >= (Q >> 1), d - Q, d)
    u = d + sum((bg >> 1) << (g_bits * t) for t in range(dgt))
    return torch.stack([((u >> (g_bits * t)) & (bg - 1)) - (bg >> 1)
                        for t in range(1, dgt)], dim=-2)


def _automorphism(params: TfheParams, plan: nttmod.NttPlan, acc_p: torch.Tensor,
                  akey: torch.Tensor) -> torch.Tensor:
    """Key switch of an already permuted accumulator (Automorphism,
    rgsw-acc-lmkcdey.cpp:269-300): acc_p [B, 2, N] EVAL, akey [B, dGa, 2, N]
    Montgomery -> (0, acc_p[:, 1]) + digits(acc_p[:, 0]) x akey, int32."""
    c = nttmod.ntt_inverse(plan, acc_p[:, 0])
    prod = _key_product(plan, _ntt_digits(plan, sdd_single(params, c)), akey)
    prod[:, 1] = add_mod(prod[:, 1], acc_p[:, 1], params.Q)
    return prod.to(torch.int32)


def _permute(acc: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """acc [B, 2, N] with each row's evaluation axis gathered by perm [B, N]."""
    return torch.gather(acc, -1, perm[:, None, :].expand(-1, 2, -1))


def blind_rotate_lmkcdey(params: TfheParams, rgsw_keys: torch.Tensor,
                         auto_keys: torch.Tensor, acc: torch.Tensor,
                         a_host: np.ndarray) -> torch.Tensor:
    """LMKCDEY accumulation (rgsw-acc-lmkcdey.cpp EvalAcc :70-155), one
    ciphertext at a time in the reference's order: the bit-exactness anchor
    of `blind_rotate_lmkcdey_scan` (tests only).  acc: [B, 2, N] int32 EVAL;
    a_host: [B, n] numpy mod q."""
    N = params.N
    M, Nh, w = 2 * N, N // 2, params.num_auto_keys
    dev = acc.device
    plan = nttmod.make_plan(N, params.Q, dev)
    log_gen = _log_gen_table(N)

    def auto(cur, k, key_idx):
        perm = torch.from_numpy(_auto_perm(N, k)).to(dev)[None]
        return _automorphism(params, plan, _permute(cur, perm), auto_keys[key_idx][None])

    def ext(cur, j):
        return _external(params, plan, cur, rgsw_keys[j][None])

    outs = []
    for b in range(a_host.shape[0]):
        perm_map: dict[int, list[int]] = {}
        for i, ai in enumerate(a_host[b]):
            idx = int(log_gen[((M - int(ai)) % M) | 1])
            perm_map.setdefault(idx, []).append(i)
        cur = acc[b:b + 1].clone()
        # initial rotation of the body only (the mask part is zero: no key)
        cur[:, 1] = cur[:, 1, torch.from_numpy(_auto_perm(N, M - 5)).to(dev)]
        n_skips = 0
        for sign in (-1, 1):
            for i in range(Nh - 1, 0, -1):
                if sign * i in perm_map:
                    if n_skips:
                        cur = auto(cur, pow(5, n_skips, M), n_skips)
                        n_skips = 0
                    for j in perm_map[sign * i]:
                        cur = ext(cur, j)
                n_skips += 1
                if n_skips == w or i == 1:
                    cur = auto(cur, pow(5, n_skips, M), n_skips)
                    n_skips = 0
            if sign == -1:
                for j in perm_map.get(M, []):                # the -1 group
                    cur = ext(cur, j)
                cur = auto(cur, M - 5, 0)
        for j in perm_map.get(0, []):                        # exponent 0
            cur = ext(cur, j)
        outs.append(cur)
    return torch.cat(outs)


def lmk_schedule(params: TfheParams, a_host: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host (numpy, vectorized over the batch): compile the LMKCDEY
    exponent-ladder walk (rgsw-acc-lmkcdey.cpp EvalAcc :70-155) into a
    uniform per-element op stream.

    Op kinds per slot: 0 = noop, 1 = keyed automorphism (param1 = auto key
    index: 0 -> X^{2N-5} conjugation, k in [1, w] -> X^{5^k}), 2 = external
    product with rgsw key param2, preceded by an automorphism of power
    param1 (0 = none).

    The sequence reproduces the reference's lazy-composition flush
    discipline exactly: between consecutive stops separated by g exponent
    steps the applied automorphisms are [w, w, ..., w, g mod w] with the
    remainder merged into the stop's op; the conjugation is a forced stop
    between the ladder's two phases.

    Returns (kinds [B, T], p1 [B, T], p2 [B, T], T)."""
    N = params.N
    M = 2 * N
    Nh = N // 2
    w = params.num_auto_keys
    B, n = a_host.shape
    log_gen = _log_gen_table(N)

    a_odd = ((M - (a_host.astype(np.int64) % M)) % M) | 1
    idx = log_gen[a_odd]                                     # [B, n] signed
    pos = np.where(idx == M, Nh - 1,
                   np.where(idx < 0, Nh - 1 + idx,
                            np.where(idx == 0, 2 * Nh - 1, 2 * Nh - 1 - idx)))
    # stable sort by (position, j): processing order == the reference's
    # per-group ascending-j appends
    keyed = pos * (n + 1) + np.arange(n)[None, :]
    order = np.argsort(keyed, axis=1, kind="stable")
    pos_s = np.take_along_axis(pos, order, axis=1)           # [B, n]
    j_s = order.astype(np.int32)

    # stop table: n secrets + conjugation stop + tail stop; per row
    # [secrets with pos <= Nh-1][conj][rest][tail]
    S = n + 2
    n_neg = (pos_s <= Nh - 1).sum(axis=1)                    # [B]
    for_cols = np.arange(S)[None, :]
    before = for_cols < n_neg[:, None]
    at_conj = for_cols == n_neg[:, None]
    after = (for_cols > n_neg[:, None]) & (for_cols < S - 1)
    sec_idx = np.where(before, for_cols, np.clip(for_cols - 1, 0, n - 1))
    stop_pos = np.where(before | after,
                        np.take_along_axis(np.pad(pos_s, ((0, 0), (0, 1))), sec_idx, axis=1),
                        np.where(at_conj, Nh - 1, 2 * Nh - 1))
    stop_kind = np.where(at_conj, 1, np.where(for_cols == S - 1, 2, 0))  # 0 ext, 1 conj, 2 tail
    stop_j = np.where(before | after,
                      np.take_along_axis(np.pad(j_s, ((0, 0), (0, 1))), sec_idx, axis=1),
                      0).astype(np.int32)

    # previous position: conj advances the walk by one step (to Nh)
    prev = np.concatenate([np.zeros((B, 1), np.int64), stop_pos[:, :-1]], axis=1)
    prev_kind = np.concatenate([np.full((B, 1), -1, np.int32), stop_kind[:, :-1]], axis=1)
    base = np.where(prev_kind == 1, Nh, prev)
    g = np.maximum(stop_pos - base, 0)                        # [B, S]
    k_full = g // w
    r = (g % w).astype(np.int32)
    # slots per stop: k_full pure autos + 1 stop op; the tail's and the
    # conjugation's remainders cannot merge -> one extra pure-auto slot
    extra_tail = ((stop_kind == 2) & (r > 0)).astype(np.int64)
    extra_conj = ((stop_kind == 1) & (r > 0)).astype(np.int64)
    slots = k_full + 1 + extra_tail + extra_conj
    off_end = np.cumsum(slots, axis=1)
    off = off_end - slots                                     # start slot
    T = int(off_end[:, -1].max())

    kinds = np.zeros((B, T), dtype=np.int32)
    p1 = np.zeros((B, T), dtype=np.int32)
    p2 = np.zeros((B, T), dtype=np.int32)
    rows = np.arange(B)
    for t in range(S):
        for u in range(int(k_full[:, t].max())):
            m = k_full[:, t] > u
            kinds[rows[m], off[m, t] + u] = 1
            p1[rows[m], off[m, t] + u] = w
        pos_op = off[:, t] + k_full[:, t]
        kt = stop_kind[:, t]
        # pure remainder auto for conj/tail stops
        m = ((kt == 1) | (kt == 2)) & (r[:, t] > 0)
        kinds[rows[m], pos_op[m]] = 1
        p1[rows[m], pos_op[m]] = r[m, t]
        pos_op = pos_op + m.astype(np.int64)
        # the stop op itself; the tail stop emits nothing further
        m_ext = kt == 0
        kinds[rows[m_ext], pos_op[m_ext]] = 2
        p1[rows[m_ext], pos_op[m_ext]] = r[m_ext, t]
        p2[rows[m_ext], pos_op[m_ext]] = stop_j[m_ext, t]
        m_conj = kt == 1
        kinds[rows[m_conj], pos_op[m_conj]] = 1
        p1[rows[m_conj], pos_op[m_conj]] = 0                  # conj key index 0
    return kinds, p1, p2, T


def lmk_branches(kinds: np.ndarray, p1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host: per slot, whether any ciphertext needs the keyed automorphism
    (a pure one, or an external product's pre-automorphism) and whether any
    needs the external product: ([T] bool, [T] bool).  Each branch run is
    one inverse and one forward NTT."""
    return (((kinds == 1) | ((kinds == 2) & (p1 > 0))).any(axis=0),
            (kinds == 2).any(axis=0))


def _lmk_perm_table(params: TfheParams) -> np.ndarray:
    """[w+2, N] automorphism index permutations: row 0 = X^{2N-5}, row
    k in [1, w] = X^{5^k}, row w+1 = identity (merged-auto power 0)."""
    N, M, w = params.N, 2 * params.N, params.num_auto_keys
    ks = [M - 5] + [pow(5, r, M) for r in range(1, w + 1)] + [1]
    return np.stack([_auto_perm(N, k) for k in ks])


def blind_rotate_lmkcdey_scan(params: TfheParams, rgsw_keys: torch.Tensor,
                              auto_keys: torch.Tensor, acc: torch.Tensor,
                              a_host: np.ndarray) -> torch.Tensor:
    """LMKCDEY accumulation over the host-compiled op stream (`lmk_schedule`):
    one loop iteration a slot, each ciphertext's op picked by masks (the
    step of fhe_tpu's `_lmk_scan_fn`).  Bit-identical to
    `blind_rotate_lmkcdey`: same op order, same leaf arithmetic.

    acc: [B, 2, N] int32 EVAL; a_host: [B, n] numpy mod q = 2N."""
    N, w = params.N, params.num_auto_keys
    dev = acc.device
    plan = nttmod.make_plan(N, params.Q, dev)
    kinds_np, p1_np, p2_np, T = lmk_schedule(params, np.asarray(a_host))
    run_auto, run_ext = lmk_branches(kinds_np, p1_np)
    kinds, p1, p2 = (torch.from_numpy(x.astype(np.int64)).to(dev)
                     for x in (kinds_np, p1_np, p2_np))
    perm_table = torch.from_numpy(_lmk_perm_table(params)).to(dev)

    # initial keyless body rotation by X^{2N-5} (the mask part is zero)
    acc = acc.to(torch.int32).clone()
    acc[:, 1] = acc[:, 1, perm_table[0]]
    for t in range(T):
        kind, pp1, pp2 = kinds[:, t], p1[:, t], p2[:, t]
        out, auto_out = acc, None
        if run_auto[t]:
            # kind 1: key index pp1 (0 conj, 1..w); kind 2: pre-auto power
            # pp1 (0 -> the identity row w+1 and, unused, key 0)
            prow = torch.where((kind == 1) | (pp1 > 0), pp1, w + 1)
            akey = torch.index_select(auto_keys, 0, torch.where(prow > w, 0, prow))
            auto_out = _automorphism(params, plan, _permute(acc, perm_table[prow]), akey)
            out = torch.where((kind == 1)[:, None, None], auto_out, acc)
        if run_ext[t]:
            ext_in = acc
            if auto_out is not None:
                ext_in = torch.where(((kind == 2) & (pp1 > 0))[:, None, None], auto_out, acc)
            ext_out = _external(params, plan, ext_in, torch.index_select(rgsw_keys, 0, pp2))
            out = torch.where((kind == 2)[:, None, None], ext_out, out)
        acc = out
    return acc
