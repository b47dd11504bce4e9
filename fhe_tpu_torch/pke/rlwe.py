"""RLWE core of the RNS schemes: keys, encryption, HYBRID key switching.
Port of fhe_tpu/pke/rlwe.py.

Reference semantics: the reference's keyswitch-hybrid.cpp
(KeySwitchGenInternal:48-137, P * s_old injected on each digit's limb
range; KeySwitchCore:322 and EvalKeySwitchPrecomputeCore:328-380, digit
split and ApproxModUp; EvalFastKeySwitchCore, inner products over QP then
ApproxModDown) and base-pke's encryption (c0 = b u + e0 + m, c1 = a u + e1
for a public key (b, a), b = -a s + e).

BV key switching (keyswitch-bv.cpp:48-336: `bv_evk_gen`, `bv_decompose`,
`bv_key_switch`) takes a `BvEvalKey`; `key_switch` dispatches on the key's
type.  For BGV (params.scheme) the ModDown lifts the dropped limbs' part to
a multiple of t, and `noise_scale = t` scales every noise draw.

The host draws keep fhe_tpu's `np.random.Generator` order, so a seed gives
byte-identical keys and ciphertexts.  Ring data lives on the device of the
keys (`keygen(..., device=)`); the NTTs are kernels 1-2 on a CUDA device
(`lattice.rns`), the basis switches and the digit inner products PyTorch
int64 ops, as fhe_tpu leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..lattice import rns
from ..lattice.rns import COEFF, EVAL, RnsPoly
from ..math.modmath import add_mod, sub_mod


@dataclasses.dataclass(frozen=True, eq=False)
class SecretKey:
    """Ternary secret as signed ints [N] and its EVAL residues on the full
    chain Q u P [L_full, N] (int32, on the device); a sub-chain is a slice."""
    s_signed: torch.Tensor
    s_eval_full: torch.Tensor
    moduli_full: tuple

    def eval_poly(self, moduli: tuple) -> RnsPoly:
        idx = [self.moduli_full.index(q) for q in moduli]
        rows = self.s_eval_full[torch.tensor(idx, device=self.s_eval_full.device)]
        return RnsPoly(rows, tuple(moduli), EVAL)


@dataclasses.dataclass(frozen=True, eq=False)
class PublicKey:
    b: RnsPoly    # -a s + e (EVAL, over Q)
    a: RnsPoly


@dataclasses.dataclass(frozen=True, eq=False)
class EvalKey:
    """HYBRID switching key: for each digit d, (b_d, a_d) over QP (EVAL),
    b and a int32 [dnum, L_qp, N]."""
    b: torch.Tensor
    a: torch.Tensor
    moduli_qp: tuple
    num_per_part: int


@dataclasses.dataclass(frozen=True, eq=False)
class PreparedEvalKey:
    """An EvalKey in the key switch's working form: b and a as int64
    [dnum, L_qp, N], so that a switch reads them without a cast.  fhe_tpu's
    PreparedEvalKey holds Montgomery-form words instead (its uint32 REDC
    path); both give the same ciphertexts.  Made once by `prepare_evk`;
    taken wherever an EvalKey is."""
    b: torch.Tensor
    a: torch.Tensor
    moduli_qp: tuple
    num_per_part: int


@dataclasses.dataclass(frozen=True, eq=False)
class BvEvalKey:
    """BV (digit decomposition) switching key (keyswitch-bv.cpp:48-137):
    one (b, a) RLWE pair over the full chain per row, b and a int32
    [n_rows, L, N] EVAL; row (i, k) encrypts B^k s_old_i on limb i only
    (B = 2^digit_bits; digit_bits = 0: one row a limb, the limb whole).
    rows_per_limb: the rows of each limb."""
    b: torch.Tensor
    a: torch.Tensor
    moduli: tuple
    digit_bits: int
    rows_per_limb: tuple


def sample_ternary(rng: np.random.Generator, N: int, h: int | None = None) -> np.ndarray:
    """Uniform ternary secret, or sparse ternary of Hamming weight h
    (SPARSE_TERNARY, for CKKS bootstrapping)."""
    if h is None:
        return rng.integers(-1, 2, size=N, dtype=np.int64)
    if not 0 < h <= N:
        raise ValueError(f"Hamming weight must be in (0, {N}], got {h}")
    s = np.zeros(N, dtype=np.int64)
    idx = rng.choice(N, size=h, replace=False)
    s[idx] = rng.choice(np.array([-1, 1], dtype=np.int64), size=h)
    return s


def sample_gauss(rng: np.random.Generator, N: int, std: float) -> np.ndarray:
    return np.rint(rng.normal(0.0, std, size=N)).astype(np.int64)


def signed_to_rns(v: np.ndarray, moduli: tuple, fmt=COEFF, device="cuda") -> RnsPoly:
    """Host signed integers [..., N] -> residues over `moduli` on the device."""
    limbs = np.stack([np.asarray(v) % q for q in moduli], axis=-2)
    return RnsPoly(torch.from_numpy(limbs.astype(np.int32)).to(device), tuple(moduli), fmt)


def uniform_poly(rng: np.random.Generator, moduli: tuple, N: int, fmt=EVAL,
                 device="cuda") -> RnsPoly:
    limbs = np.stack([rng.integers(0, q, size=N, dtype=np.int64) for q in moduli], axis=-2)
    return RnsPoly(torch.from_numpy(limbs.astype(np.int32)).to(device), tuple(moduli), fmt)


def _gauss_eval(params, rng, moduli: tuple, device, noise_scale: int = 1) -> RnsPoly:
    return rns.to_eval(signed_to_rns(noise_scale * sample_gauss(rng, params.N, params.std_dev),
                                     moduli, device=device))


def keygen(params, rng: np.random.Generator, h: int | None = None,
           device="cuda") -> SecretKey:
    all_mods = tuple(params.moduli) + tuple(params.special_mods)
    s = sample_ternary(rng, params.N, h)
    sp = rns.to_eval(signed_to_rns(s, all_mods, device=device))
    return SecretKey(s_signed=torch.from_numpy(s.astype(np.int32)).to(device),
                     s_eval_full=sp.data, moduli_full=all_mods)


def pubkey_gen(params, sk: SecretKey, rng: np.random.Generator,
               noise_scale: int = 1) -> PublicKey:
    mods = tuple(params.moduli)
    dev = sk.s_eval_full.device
    a = uniform_poly(rng, mods, params.N, device=dev)
    e = _gauss_eval(params, rng, mods, dev, noise_scale)
    b = rns.add(rns.neg(rns.mul(a, sk.eval_poly(mods))), e)
    return PublicKey(b=b, a=a)


def encrypt_pk(params, pk: PublicKey, m: RnsPoly, rng: np.random.Generator,
               noise_scale: int = 1) -> tuple[RnsPoly, RnsPoly]:
    """(c0, c1) = (b u + ns e0 + m, a u + ns e1); m in EVAL over pk's basis."""
    mods = pk.b.moduli
    dev = pk.b.data.device
    u = rns.to_eval(signed_to_rns(sample_ternary(rng, params.N), mods, device=dev))
    e0 = _gauss_eval(params, rng, mods, dev, noise_scale)
    e1 = _gauss_eval(params, rng, mods, dev, noise_scale)
    c0 = rns.add(rns.add(rns.mul(pk.b, u), e0), m)
    c1 = rns.add(rns.mul(pk.a, u), e1)
    return c0, c1


def encrypt_sk(params, sk: SecretKey, m: RnsPoly, rng: np.random.Generator,
               noise_scale: int = 1) -> tuple[RnsPoly, RnsPoly]:
    mods = m.moduli
    dev = sk.s_eval_full.device
    a = uniform_poly(rng, mods, params.N, device=dev)
    e = _gauss_eval(params, rng, mods, dev, noise_scale)
    c0 = rns.add(rns.add(rns.neg(rns.mul(a, sk.eval_poly(mods))), e), m)
    return c0, a


def decrypt_phase(sk: SecretKey, c0: RnsPoly, c1: RnsPoly) -> RnsPoly:
    """m + e = c0 + c1 s (EVAL in, COEFF out)."""
    return rns.to_coeff(rns.add(c0, rns.mul(c1, sk.eval_poly(c0.moduli))))


# ---------------------------------------------------------------------------
# HYBRID key switching
# ---------------------------------------------------------------------------

def _p_mod_q(p_mods: tuple, q_mods: tuple) -> list[int]:
    P = rns.modulus_product(p_mods)
    return [P % q for q in q_mods]


def _plain_mod(params) -> int | None:
    """t where the ModDown lifts to multiples of it (BGV), else None."""
    return params.plain_mod if params.scheme == "BGV" else None


def evk_gen(params, s_old: RnsPoly, sk_new: SecretKey, rng: np.random.Generator,
            noise_scale: int = 1, a_common: torch.Tensor | None = None) -> EvalKey:
    """Switching key s_old -> sk_new (keyswitch-hybrid.cpp:48-137); s_old
    EVAL over the full Q chain (s^2 for relinearization, s(X^k) for a
    rotation).  Digit d draws a, then e, as fhe_tpu does.

    a_common: [dnum, L_qp, N] `a` digits to reuse instead of drawing them
    (only e is drawn then): the multiparty joint-key protocol
    (base-multiparty.cpp MultiKeySwitchGen) puts every party's share on the
    same uniform digits, so that the b components sum."""
    q_mods, p_mods = tuple(params.moduli), tuple(params.special_mods)
    qp = q_mods + p_mods
    L, npp, N = len(q_mods), params.num_per_part, params.N
    dev = sk_new.s_eval_full.device
    s_new = sk_new.eval_poly(qp)
    pmodq = _p_mod_q(p_mods, qp)
    bs, as_ = [], []
    for d in range(params.num_part_q):
        if a_common is None:
            a = uniform_poly(rng, qp, N, device=dev)
        else:
            a = RnsPoly(a_common[d], qp, EVAL)
        e = _gauss_eval(params, rng, qp, dev, noise_scale)
        b = rns.add(rns.neg(rns.mul(a, s_new)), e)
        lo, hi = d * npp, min((d + 1) * npp, L)
        if lo < L:
            # P s_old on limbs [lo, hi) only
            sel = [pmodq[j] if lo <= j < hi else 0 for j in range(len(qp))]
            s_old_ext = torch.zeros(len(qp), N, dtype=torch.int32, device=dev)
            s_old_ext[:L] = s_old.data
            b = rns.add(b, rns.mul_scalar(RnsPoly(s_old_ext, qp, EVAL), sel))
        bs.append(b.data)
        as_.append(a.data)
    return EvalKey(b=torch.stack(bs), a=torch.stack(as_), moduli_qp=qp, num_per_part=npp)


def prepare_evk(params, evk: EvalKey) -> PreparedEvalKey:
    """The key in the switch's working form (int64), once per key."""
    return PreparedEvalKey(b=evk.b.to(torch.int64), a=evk.a.to(torch.int64),
                           moduli_qp=evk.moduli_qp, num_per_part=evk.num_per_part)


def _digits(L: int, npp: int):
    """(lo, hi) limb window of each digit of an L-limb input."""
    return [(lo, min(lo + npp, L)) for lo in range(0, L, npp)]


def key_switch_precompute(params, c: RnsPoly) -> RnsPoly:
    """Rotation-independent half of the HYBRID key switch
    (EvalKeySwitchPrecomputeCore, keyswitch-hybrid.cpp:328-380): the digit
    split and each digit's ApproxModUp onto Q_l + P (the basis switch of
    its limbs, its own limbs verbatim), every digit forward-transformed in
    one launch.  Returns the EVAL digits as one RnsPoly [..., dnum, M, N]
    over Q_l + P.  fhe_tpu transforms only the switched rows and reuses c's
    EVAL data for the digit's own; the NTT of those limbs is that data, so
    both give the same bytes.  An automorphism permutes EVAL points, so one
    precompute serves every rotation index."""
    q_mods = c.moduli
    ext_mods = q_mods + tuple(params.special_mods)
    x = rns.to_coeff(c).data
    ups = []
    for lo, hi in _digits(len(q_mods), params.num_per_part):
        up = rns.switch_crt_basis_approx(RnsPoly(x[..., lo:hi, :], q_mods[lo:hi], COEFF),
                                         ext_mods).data
        up[..., lo:hi, :] = x[..., lo:hi, :]                       # the exact limbs
        ups.append(up)
    plan = rns.make_rns_plan(c.N, ext_mods, c.data.device)
    return RnsPoly(rns.ntt_forward(plan, torch.stack(ups, dim=-3)), ext_mods, EVAL)


def _key_rows(evk, ext_mods: tuple, dnum: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The key's b and a digit stacks on the limbs ext_mods, int64
    [dnum, M, N] (a prepared key over exactly those limbs as it is)."""
    if isinstance(evk, PreparedEvalKey) and evk.moduli_qp == ext_mods:
        return evk.b[:dnum], evk.a[:dnum]
    idx = torch.tensor([evk.moduli_qp.index(q) for q in ext_mods], device=evk.b.device)
    return (evk.b[:dnum].index_select(1, idx).to(torch.int64),
            evk.a[:dnum].index_select(1, idx).to(torch.int64))


def key_switch_inner(params, evk, ups: RnsPoly) -> tuple[RnsPoly, RnsPoly]:
    """The inner-product half of EvalFastKeySwitchCore: digit sums against
    the key over the extended basis Q_l + P (the result carries a factor P;
    `key_switch_down_poly` divides it out); ups from `key_switch_precompute`."""
    ext_mods = ups.moduli
    d0, d1 = _inner_products(ups.data, *_key_rows(evk, ext_mods, ups.data.shape[-3]),
                             ups._q())
    return RnsPoly(d0.to(torch.int32), ext_mods, EVAL), RnsPoly(d1.to(torch.int32), ext_mods, EVAL)


def _inner_products(x: torch.Tensor, evb: torch.Tensor, eva: torch.Tensor, q: torch.Tensor):
    """sum_d x_d b_d and sum_d x_d a_d mod q: x [..., dnum, M, N] digits in
    EVAL, the key's int64 [dnum, M, N] stacks, q [M, 1]; int64 [..., M, N]."""
    x = x.to(torch.int64)
    return (x * evb % q).sum(dim=-3) % q, (x * eva % q).sum(dim=-3) % q


def key_switch_down_poly(params, c: RnsPoly) -> RnsPoly:
    """KeySwitchDown for one component: ModDown by P."""
    if c.fmt == EVAL:
        return mod_down_eval(params, c)
    p_mods = tuple(params.special_mods)
    q_mods = c.moduli[:len(c.moduli) - len(p_mods)]
    return rns.to_eval(rns.approx_mod_down(c, q_mods, p_mods, _plain_mod(params)))


def key_switch_ext_poly(params, c: RnsPoly) -> RnsPoly:
    """KeySwitchExt for one component: P c over Q_l + P, the Q limbs scaled
    by P mod q_i and the P limbs zero."""
    p_mods = tuple(params.special_mods)
    scaled = rns.mul_scalar(c, _p_mod_q(p_mods, c.moduli))
    zeros = scaled.data.new_zeros(scaled.data.shape[:-2] + (len(p_mods), scaled.N))
    return RnsPoly(torch.cat([scaled.data, zeros], dim=-2), c.moduli + p_mods, c.fmt)


def key_switch_apply(params, evk, ups: RnsPoly) -> tuple[RnsPoly, RnsPoly]:
    """Inner products with the key, then ModDown (EvalFastKeySwitchCore
    over precomputed digits)."""
    d0, d1 = key_switch_inner(params, evk, ups)
    return key_switch_down_poly(params, d0), key_switch_down_poly(params, d1)


def key_switch(params, evk, c: RnsPoly) -> tuple[RnsPoly, RnsPoly]:
    """Key switch of c over Q_l: (d0, d1) over c's basis with d0 + d1 s_new
    = c s_old + noise, by the key's type: BV (`bv_key_switch`) or HYBRID
    (`key_switch_core`)."""
    if isinstance(evk, BvEvalKey):
        return bv_key_switch(params, evk, c)
    return key_switch_fused(params, evk, c)


def mod_down_eval(params, t: RnsPoly, drop_q: int = 0) -> RnsPoly:
    """EVALUATION-domain ApproxModDown, optionally fused with the CKKS
    rescale: t over Q_l + P (EVAL) divided by P times the last `drop_q`
    q-limbs, EVAL over the shortened Q.  Only the dropped limbs are
    inverse-transformed; their switch to the kept limbs is transformed
    back and subtracted in EVAL.  With drop_q > 0 the switch is the exact
    one (floor-exact joint drop, as DropLastElementAndScale), else the
    approximate one (ApproxModDown's slack).  For BGV the dropped limbs'
    part is lifted to a multiple of t (times t^-1 before the inverse NTT,
    its switch times t), as the reference's tInvModq path."""
    ext_mods = t.moduli
    p_mods = tuple(params.special_mods)
    keep = len(ext_mods) - len(p_mods) - drop_q
    if ext_mods[keep + drop_q:] != p_mods or keep < 1:
        raise ValueError(f"mod_down_eval needs data over Q_l + P with more than {drop_q} "
                         f"q-limbs, got {ext_mods}")
    keep_mods, d_mods = ext_mods[:keep], ext_mods[keep:]
    dev = t.data.device
    tmod = _plain_mod(params)
    x_d = RnsPoly(t.data[..., keep:, :], d_mods, EVAL)
    if tmod is not None:
        x_d = rns.mul_scalar(x_d, [pow(tmod % m, -1, m) for m in d_mods])
    switch = rns.switch_crt_basis_exact if drop_q > 0 else rns.switch_crt_basis_approx
    sw = switch(rns.to_coeff(x_d), keep_mods)
    sw_eval = rns.ntt_forward(rns.make_rns_plan(t.N, keep_mods, dev), sw.data)
    if tmod is not None:
        sw_eval = rns.mul_scalar(RnsPoly(sw_eval, keep_mods, EVAL), tmod).data
    D = rns.modulus_product(d_mods)
    qk = rns.limb_constants(tuple(keep_mods), dev)
    dinv = rns.limb_constants(tuple(pow(D % q, -1, q) for q in keep_mods), dev)
    out = sub_mod(t.data[..., :keep, :], sw_eval, qk) * dinv % qk
    return RnsPoly(out.to(torch.int32), keep_mods, EVAL)


def key_switch_core(params, evk, c: RnsPoly, extra: tuple | None = None,
                    drop_q: int = 0) -> tuple[RnsPoly, RnsPoly]:
    """HYBRID KeySwitchCore in EVALUATION format (keyswitch-hybrid.cpp:
    322-380 and ApproxModDown, as fhe_tpu fuses them):

      * the digit split and ModUp (`key_switch_precompute`, one launch
        for all digits);
      * the digit inner products against the key;
      * `extra = (e0, e1)` (EVAL over Q_l) scaled by P and added to the
        extended-basis sums, so EvalMult's d0, d1 share the ModDown;
      * the ModDown in EVAL (`mod_down_eval`), also dropping the last
        `drop_q` q-limbs (the fused CKKS rescale).

    Returns (d0, d1) over Q_{l - drop_q} in EVAL.  With drop_q > 0 the
    joint drop is floor-exact, and the result is fhe_tpu's relinearize
    then rescale, byte for byte (fhe_tpu/pke/rlwe.py:504-507)."""
    q_mods = c.moduli
    L = len(q_mods)
    p_mods = tuple(params.special_mods)
    ext_mods = tuple(q_mods) + p_mods
    dev = c.data.device
    ups = key_switch_precompute(params, c)
    eq = ups._q()
    d0, d1 = _inner_products(ups.data, *_key_rows(evk, ext_mods, ups.data.shape[-3]), eq)
    if extra is not None:
        qk = eq[:L]
        pm = rns.limb_constants(tuple(_p_mod_q(p_mods, tuple(q_mods))), dev)
        d0[..., :L, :] = add_mod(d0[..., :L, :], extra[0].data.to(torch.int64) * pm % qk, qk)
        d1[..., :L, :] = add_mod(d1[..., :L, :], extra[1].data.to(torch.int64) * pm % qk, qk)
    both = RnsPoly(torch.stack([d0, d1]).to(torch.int32), ext_mods, EVAL)
    down = mod_down_eval(params, both, drop_q)
    out_mods = tuple(q_mods)[:L - drop_q]
    return RnsPoly(down.data[0], out_mods, EVAL), RnsPoly(down.data[1], out_mods, EVAL)


def key_switch_fused(params, evk, c: RnsPoly) -> tuple[RnsPoly, RnsPoly]:
    """KeySwitchCore with no extras and no rescale (key_switch_core)."""
    return key_switch_core(params, evk, c)


# ---------------------------------------------------------------------------
# BV key switching (digit decomposition; keyswitch-bv.cpp:48-336)
# ---------------------------------------------------------------------------

def _bv_windows(moduli: tuple, digit_bits: int) -> tuple:
    """Rows of each limb: ceil(bits(q_i) / w), or 1 where digit_bits = 0."""
    if digit_bits == 0:
        return tuple(1 for _ in moduli)
    return tuple(-(-q.bit_length() // digit_bits) for q in moduli)


def bv_evk_gen(params, s_old: RnsPoly, sk_new: SecretKey, rng: np.random.Generator,
               digit_bits: int = 0, noise_scale: int = 1) -> BvEvalKey:
    """BV switching key s_old -> sk_new (KeySwitchGenInternal,
    keyswitch-bv.cpp:50-123): row (i, k) is b = B^k s_old_i on limb i (zero
    on the others) - a s_new + ns e.  Each row draws a, then e, as fhe_tpu
    does."""
    q_mods = tuple(params.moduli)
    dev = sk_new.s_eval_full.device
    s_new = sk_new.eval_poly(q_mods)
    wins = _bv_windows(q_mods, digit_bits)
    bs, as_ = [], []
    for i, qi in enumerate(q_mods):
        for k in range(wins[i]):
            a = uniform_poly(rng, q_mods, params.N, device=dev)
            e = _gauss_eval(params, rng, q_mods, dev, noise_scale)
            b = rns.add(rns.neg(rns.mul(a, s_new)), e)
            pw = pow(2, digit_bits * k, qi)
            filt = torch.zeros_like(b.data)
            filt[i] = (s_old.data[i].to(torch.int64) * pw % qi).to(torch.int32)
            bs.append(rns.add(b, RnsPoly(filt, q_mods, EVAL)).data)
            as_.append(a.data)
    return BvEvalKey(b=torch.stack(bs), a=torch.stack(as_), moduli=q_mods,
                     digit_bits=digit_bits, rows_per_limb=wins)


def switch_key_gen(params, s_old: RnsPoly, sk_new: SecretKey, rng: np.random.Generator,
                   method: str = "hybrid", digit_bits: int = 0, noise_scale: int = 1):
    """The s_old -> sk_new key of a scheme's relin_key_gen / rotation_key_gen:
    HYBRID (`evk_gen`) or, with method="bv", BV (`bv_evk_gen`)."""
    if method == "bv":
        return bv_evk_gen(params, s_old, sk_new, rng, digit_bits, noise_scale)
    if method != "hybrid":
        raise ValueError(f"key switching method must be 'hybrid' or 'bv', got {method!r}")
    return evk_gen(params, s_old, sk_new, rng, noise_scale)


def bv_decompose(params, evk: BvEvalKey, c: RnsPoly) -> RnsPoly:
    """CRTDecompose (EvalKeySwitchPrecomputeCore, keyswitch-bv.cpp:304): each
    limb of c (or each base-2^w digit of it) re-embedded over c's basis, all
    digits forward-transformed in one launch.  Returns them as one RnsPoly
    [..., n_digits, L, N] over c's basis in EVAL, limb by limb, digit by
    digit (fhe_tpu's list, stacked)."""
    q_mods = c.moduli
    x = rns.to_coeff(c).data.to(torch.int64)
    w = evk.digit_bits
    digits = []
    for i in range(len(q_mods)):
        for k in range(evk.rows_per_limb[i]):
            d = x[..., i, :] if w == 0 else x[..., i, :] >> (w * k) & ((1 << w) - 1)
            digits.append(d)
    emb = torch.stack(digits, dim=-2)[..., None, :] % c._q()       # [..., D, L, N]
    plan = rns.make_rns_plan(c.N, q_mods, c.data.device)
    return RnsPoly(rns.ntt_forward(plan, emb.to(torch.int32)), q_mods, EVAL)


def bv_key_switch(params, evk: BvEvalKey, c: RnsPoly) -> tuple[RnsPoly, RnsPoly]:
    """BV KeySwitchCore (keyswitch-bv.cpp:298-336): the digits' products with
    the key's rows, summed; the key truncated to c's basis, a prefix of the
    chain (DropLastElements)."""
    q_mods = c.moduli
    L = len(q_mods)
    if evk.moduli[:L] != q_mods:
        raise ValueError(f"BV key switch needs a prefix of the key's chain {evk.moduli}, "
                         f"got {q_mods}")
    rows = sum(evk.rows_per_limb[:L])
    digits = bv_decompose(params, evk, c)
    d0, d1 = _inner_products(digits.data, evk.b[:rows, :L].to(torch.int64),
                             evk.a[:rows, :L].to(torch.int64), c._q())
    return RnsPoly(d0.to(torch.int32), q_mods, EVAL), RnsPoly(d1.to(torch.int32), q_mods, EVAL)
