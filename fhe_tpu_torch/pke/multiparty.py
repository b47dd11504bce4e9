"""Multiparty (threshold) PKE: joint keygen, lead/main partial decryption
with noise flooding, fusion, joint evaluation keys and interactive
bootstrapping.  Port of fhe_tpu/pke/multiparty.py.

Reference semantics: the reference's base-multiparty.cpp
(MultipartyKeyGen:52-120, additive secret sharing, each party
re-randomizing the running public key) and rns-multiparty.cpp
(MultipartyDecryptLead:45, b = c0 + s c1 + ns e_flood;
MultipartyDecryptMain:111, s c1 + ns e_flood; the fusion sums the shares).

Every host draw keeps fhe_tpu's `np.random.Generator` order, so a seed
gives byte-identical keys, joint keys, ciphertexts and interactive-
bootstrap shares.  The flooding deviate is the one exception: fhe_tpu
samples it on its device with jax.random threefry, keyed by one
`rng.integers(1 << 62)` draw a share (or a pipeline).  The port takes the
same single draw, so the host stream stays in step with fhe_tpu's for
every later draw, and seeds an explicit `torch.Generator` on the
ciphertext's device with it (`_flood`): round(normal x MP_SD) in int64,
reduced per limb.  Only the deviate's statistical size matters (it hides
the share's own noise), so a share equals fhe_tpu's byte for byte with
the flood set to 0 (`_share`, `_pipeline` take the deviates).

A share is pointwise ring ops on the data's device and one forward NTT
of its flood (the limb-stacked kernel 1 on a CUDA device); the fusion is
modular adds and one inverse NTT (kernel 2).  `threshold_decrypt_pipeline`
does every party's share and the fusion at once: one forward launch for
the P floods [P, L, N], one inverse for the sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..lattice import rns
from ..lattice.rns import COEFF, EVAL, RnsPoly
from ..math.modmath import add_mod
from . import rlwe

MP_SD = 1048576.0   # NoiseFlooding::MP_SD (utils/noise_flooding.h): 2^20


@dataclasses.dataclass(frozen=True, eq=False)
class PartialDecryption:
    """One party's share: an RnsPoly (EVAL) to be summed at fusion."""
    share: RnsPoly
    is_lead: bool


def _noise_scale(params) -> int:
    return params.plain_mod if params.scheme == "BGV" else 1


def multiparty_keygen(params, n_parties: int, rng: np.random.Generator, device="cuda"):
    """n-party joint keygen: party i draws s_i and re-randomizes the
    accumulated public key under the SAME uniform `a` (base-multiparty.cpp
    MultipartyKeyGen(publicKey, ...)).  Joint secret = sum_i s_i.

    Returns (sks, joint_pk)."""
    mods = tuple(params.moduli)
    ns = _noise_scale(params)
    sks = [rlwe.keygen(params, rng, device=device) for _ in range(n_parties)]
    a = rlwe.uniform_poly(rng, mods, params.N, device=device)
    b = None
    for sk in sks:
        e = rns.to_eval(rlwe.signed_to_rns(ns * rlwe.sample_gauss(rng, params.N, params.std_dev),
                                           mods, device=device))
        term = rns.add(rns.neg(rns.mul(a, sk.eval_poly(mods))), e)
        b = term if b is None else rns.add(b, term)
    return sks, rlwe.PublicKey(b=b, a=a)


def _flood_noise(params, moduli: tuple, rng: np.random.Generator, sd: float = MP_SD,
                 device="cuda") -> RnsPoly:
    """Large-deviation Gaussian for noise flooding (MP_SD = 2^20,
    rns-multiparty.cpp:100-106), host-side (numpy rng), EVAL."""
    e = np.rint(rng.normal(0.0, sd, size=params.N)).astype(np.int64)
    return rns.to_eval(rlwe.signed_to_rns(e, moduli, device=device))


def _flood(seed: int, shape: tuple, sd: float, device) -> torch.Tensor:
    """The flooding deviates round(normal x sd), int64 [shape], from a
    torch.Generator on `device` seeded with `seed` (fhe_tpu: threefry keyed
    by the same seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    return torch.round(x * sd).to(torch.int64)


def _flood_eval(e: torch.Tensor, moduli: tuple, ns: int) -> RnsPoly:
    """Signed deviates [..., N] -> ns e over `moduli` in EVAL [..., L, N]:
    one forward NTT launch for every row."""
    planes = e[..., None, :] % rns.limb_constants(tuple(moduli), e.device)
    ev = rns.to_eval(RnsPoly(planes.to(torch.int32), tuple(moduli), COEFF))
    return ev if ns == 1 else rns.mul_scalar(ev, ns)


def _share(moduli: tuple, ns: int, lead: bool, s_data: torch.Tensor, c1_data: torch.Tensor,
           c0_data: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The whole share (fhe_tpu's jitted `_share_fn`): s c1 (+ c0 for the
    lead) + ns e, EVAL data over `moduli`; e the int64 deviates [N]."""
    share = rns.mul(RnsPoly(s_data, moduli, EVAL), RnsPoly(c1_data, moduli, EVAL))
    if lead:
        share = rns.add(RnsPoly(c0_data, moduli, EVAL), share)
    return rns.add(share, _flood_eval(e, moduli, ns)).data


def decrypt_lead(params, sk: rlwe.SecretKey, c0: RnsPoly, c1: RnsPoly,
                 rng: np.random.Generator) -> PartialDecryption:
    """Lead share: c0 + s c1 + ns e_flood (rns-multiparty.cpp:45-108)."""
    s = sk.eval_poly(c0.moduli)
    e = _flood(int(rng.integers(1 << 62)), (params.N,), MP_SD, c0.data.device)
    data = _share(tuple(c0.moduli), _noise_scale(params), True, s.data, c1.data, c0.data, e)
    return PartialDecryption(share=RnsPoly(data, c0.moduli, EVAL), is_lead=True)


def decrypt_main(params, sk: rlwe.SecretKey, c1: RnsPoly,
                 rng: np.random.Generator) -> PartialDecryption:
    """Non-lead share: s c1 + ns e_flood (rns-multiparty.cpp:111-164)."""
    s = sk.eval_poly(c1.moduli)
    e = _flood(int(rng.integers(1 << 62)), (params.N,), MP_SD, c1.data.device)
    data = _share(tuple(c1.moduli), _noise_scale(params), False, s.data, c1.data, c1.data, e)
    return PartialDecryption(share=RnsPoly(data, c1.moduli, EVAL), is_lead=False)


def fuse(shares: list[PartialDecryption]) -> RnsPoly:
    """MultipartyDecryptFusion: the sum of all shares = m + total noise,
    COEFF.  Exactly one share must be the lead."""
    leads = sum(1 for s in shares if s.is_lead)
    if leads != 1:
        raise ValueError(f"fusion needs exactly one lead share, got {leads} of {len(shares)}")
    acc = shares[0].share
    for s in shares[1:]:
        acc = rns.add(acc, s.share)
    return rns.to_coeff(acc)


# ---------------------------------------------------------------------------
# Joint evaluation-key generation (threshold eval keys):
# base-multiparty.cpp MultiKeySwitchGen / MultiMultEvalKey and the
# cryptocontext.h MultiAdd* aggregators.  All shares ride the SAME uniform
# `a` digits (evk_gen's a_common), so the b components sum into a key for
# the joint secret s = sum_i s_i:
#
#   relin key (threshold-fhe.cpp round structure):
#     party 1: evk1 = evk_gen(s_1, sk_1)                  (s_1 -> s_1)
#     party 2: evk2 = multi_key_switch_gen(s_2, sk_2, evk1)
#     evkAB   = multi_add_eval_keys(evk1, evk2)           (s -> s)
#     party i: evk_i* = multi_mult_eval_key(evkAB, sk_i)  (s_i * evkAB)
#     rlk     = multi_add_eval_mult_keys(evk1*, evk2*)    (s^2 -> s)
#
#   rotation/sum keys: each party adds -a_d s_i + P qhat sigma_k(s_i);
#   sigma_k is linear so the shares sum to a key for sigma_k(s) -> s.
# ---------------------------------------------------------------------------


def multi_key_switch_gen(params, s_old_share: RnsPoly, sk_share, prior_evk: rlwe.EvalKey,
                         rng: np.random.Generator) -> rlwe.EvalKey:
    """MultiKeySwitchGen (base-multiparty.cpp): this party's switching-key
    share over the SAME `a` digits as prior_evk."""
    return rlwe.evk_gen(params, s_old_share, sk_share, rng, a_common=prior_evk.a)


def _same_qp(k1: rlwe.EvalKey, k2: rlwe.EvalKey) -> None:
    if k1.moduli_qp != k2.moduli_qp:
        raise ValueError(f"keys over different bases: {k1.moduli_qp} and {k2.moduli_qp}")


def _evk_add_b(k1: rlwe.EvalKey, k2: rlwe.EvalKey) -> torch.Tensor:
    qp = k1.moduli_qp
    return rns.add(RnsPoly(k1.b, qp, EVAL), RnsPoly(k2.b, qp, EVAL)).data


def _pipeline(moduli: tuple, ns: int, s_stack: torch.Tensor, c0_data: torch.Tensor,
              c1_data: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The whole threshold decrypt (fhe_tpu's jitted `_pipeline_fn`): every
    party's share s_i c1 + ns e_i at once (s_stack [P, L, N] EVAL, e the
    int64 deviates [P, N]), their modular sum plus c0, to COEFF."""
    total = rns.add(rns.mul(RnsPoly(s_stack, moduli, EVAL), RnsPoly(c1_data, moduli, EVAL)),
                    _flood_eval(e, moduli, ns))
    q = total._q()
    acc = total.data[0]
    for i in range(1, total.data.shape[0]):
        acc = add_mod(acc, total.data[i], q)
    acc = add_mod(acc, c0_data, q)
    return rns.to_coeff(RnsPoly(acc.to(torch.int32), moduli, EVAL)).data


def threshold_decrypt_pipeline(params, sks: list, c0: RnsPoly, c1: RnsPoly,
                               rng: np.random.Generator) -> RnsPoly:
    """Whole-protocol threshold decrypt in one call (the in-process form of
    MultipartyDecryptLead/Main/Fusion; the same noise model as
    decrypt_lead / decrypt_main, one seed draw for all parties' floods)."""
    mods = tuple(c0.moduli)
    s_stack = torch.stack([sk.eval_poly(mods).data for sk in sks])
    e = _flood(int(rng.integers(1 << 62)), (len(sks), params.N), MP_SD, c0.data.device)
    return RnsPoly(_pipeline(mods, _noise_scale(params), s_stack, c0.data, c1.data, e), mods,
                   COEFF)


def multi_add_eval_keys(k1: rlwe.EvalKey, k2: rlwe.EvalKey) -> rlwe.EvalKey:
    """MultiAddEvalKeys: sum the b shares; the `a` digits are common."""
    _same_qp(k1, k2)
    return rlwe.EvalKey(b=_evk_add_b(k1, k2), a=k1.a, moduli_qp=k1.moduli_qp,
                        num_per_part=k1.num_per_part)


def multi_mult_eval_key(params, evk: rlwe.EvalKey, sk_share,
                        rng: np.random.Generator) -> rlwe.EvalKey:
    """MultiMultEvalKey: this party's (s_i b_d + e0, s_i a_d + e1) share;
    summed over parties it turns an (s -> s) key into the (s^2 -> s)
    relinearization key."""
    qp = evk.moduli_qp
    dev = evk.b.device
    s = sk_share.eval_poly(qp)
    bs, as_ = [], []
    for d in range(evk.b.shape[0]):
        e0 = rlwe._gauss_eval(params, rng, qp, dev)
        e1 = rlwe._gauss_eval(params, rng, qp, dev)
        bs.append(rns.add(rns.mul(RnsPoly(evk.b[d], qp, EVAL), s), e0).data)
        as_.append(rns.add(rns.mul(RnsPoly(evk.a[d], qp, EVAL), s), e1).data)
    return rlwe.EvalKey(b=torch.stack(bs), a=torch.stack(as_), moduli_qp=qp,
                        num_per_part=evk.num_per_part)


def multi_add_eval_mult_keys(k1: rlwe.EvalKey, k2: rlwe.EvalKey) -> rlwe.EvalKey:
    """MultiAddEvalMultKeys: sum BOTH components (each party's
    multi_mult_eval_key share randomizes b and a)."""
    _same_qp(k1, k2)
    qp = k1.moduli_qp
    a = rns.add(RnsPoly(k1.a, qp, EVAL), RnsPoly(k2.a, qp, EVAL))
    return rlwe.EvalKey(b=_evk_add_b(k1, k2), a=a.data, moduli_qp=qp,
                        num_per_part=k1.num_per_part)


def multi_add_pub_keys(pk1: rlwe.PublicKey, pk2: rlwe.PublicKey) -> rlwe.PublicKey:
    """MultiAddPubKeys: joint public key from shares under a common `a`."""
    return rlwe.PublicKey(b=rns.add(pk1.b, pk2.b), a=pk1.a)


def multi_eval_automorphism_key_gen(params, sk_share, prior_keys: dict, galois_elts: dict,
                                    rng: np.random.Generator) -> dict:
    """MultiEvalAutomorphismKeyGen / MultiEvalAtIndexKeyGen /
    MultiEvalSumKeyGen: this party's automorphism-key shares over the SAME
    `a` digits as the prior party's key map.

    galois_elts: index -> galois element k (the caller decides the 5^r slot
    convention or the sum-tree powers)."""
    s = sk_share.eval_poly(tuple(params.moduli))
    return {idx: rlwe.evk_gen(params, rns.automorphism(s, k), sk_share, rng,
                              a_common=prior_keys[idx].a)
            for idx, k in galois_elts.items()}


def multi_add_eval_automorphism_keys(m1: dict, m2: dict) -> dict:
    """MultiAddEvalAutomorphismKeys / MultiAddEvalSumKeys."""
    if m1.keys() != m2.keys():
        raise ValueError(f"key maps over different indices: {sorted(m1)} and {sorted(m2)}")
    return {k: multi_add_eval_keys(m1[k], m2[k]) for k in m1}


# ---------------------------------------------------------------------------
# 2-party interactive bootstrapping (IntBoot*, cryptocontext.h:3422-3468;
# rns-multiparty.cpp IntBootDecrypt :373, IntBootEncrypt :405,
# IntBootAdd :483, PolynomialRound :241; flow per
# examples/interactive-bootstrapping.cpp:115-135):
#
#   ct = int_boot_adjust_scale(ct, extra_limbs=0)   # 2 towers, Qc = q0*q1
#   server: h1 = int_boot_decrypt(params, sk1, ct.c0, ct.c1)  # rnd(c0+c1*s1)
#   client: h2 = int_boot_decrypt(params, sk2, ct.c1)         # rnd(c1*s2)
#   client: ct' = int_boot_encrypt(params, joint_pk, h2, ct)  # Enc_Q(lift h2)
#   server: out = int_boot_add(params, ct', h1)               # + lift h1
#
# h1 + h2 = m + e (mod Qc) is tiny, so h2 = -h1 + small: their mod-Qc
# representatives sit in mirrored quadrants, and PolynomialRound's
# conditional +Qc/2 (where the CRT value lies in (Qc/4, 3Qc/4]) fires on
# both shares or neither (w.h.p.).  After it both centered representatives
# lie in (-Qc/4, Qc/4], so the sum of the centered lifts over Z is m + e
# exactly: no q I wrap survives at the big modulus Q.
# ---------------------------------------------------------------------------


def _polynomial_round(p: RnsPoly) -> RnsPoly:
    """PolynomialRound (rns-multiparty.cpp:241): for a 2-limb COEFF poly,
    add Qc/2 to the coefficients whose CRT value lies in (Qc/4, 3Qc/4].

    Garner digit y = (x1 - x0) q0^-1 mod q1 gives x = x0 + q0 y; (y, x0) is
    compared lexicographically with the mixed-radix digits of Qc/4 and
    3Qc/4.  Host numpy int64 (every product is below 2^62), once a
    protocol on one small polynomial."""
    if len(p.moduli) != 2 or p.fmt != COEFF:
        raise ValueError(f"PolynomialRound needs a 2-limb COEFF poly, got {len(p.moduli)} limbs "
                         f"in {p.fmt}")
    q0, q1 = (int(q) for q in p.moduli)
    Qc = q0 * q1
    lo_d, lo_r = divmod(Qc // 4, q0)
    hi_d, hi_r = divmod(3 * Qc // 4, q0)
    data = p.data.cpu().numpy().astype(np.int64)
    x0, x1 = data[..., 0, :], data[..., 1, :]
    y = (x1 - x0) % q1 * pow(q0, -1, q1) % q1
    gt_lo = (y > lo_d) | ((y == lo_d) & (x0 > lo_r))
    le_hi = (y < hi_d) | ((y == hi_d) & (x0 <= hi_r))
    shift = gt_lo & le_hi
    n0 = np.where(shift, (x0 + (Qc // 2) % q0) % q0, x0)
    n1 = np.where(shift, (x1 + (Qc // 2) % q1) % q1, x1)
    out = torch.from_numpy(np.stack([n0, n1], axis=-2).astype(np.int32)).to(p.data.device)
    return RnsPoly(out, p.moduli, COEFF)


def int_boot_decrypt(params, sk: rlwe.SecretKey, c0: RnsPoly,
                     c1: RnsPoly | None = None) -> RnsPoly:
    """IntBootDecrypt: masked decryption share rnd(c0 + c1 s), or, for the
    client's 1-poly slice, rnd(c0 s) (rns-multiparty.cpp:373-404).  Returns
    a rounded COEFF poly over the compressed 2-limb basis."""
    s = sk.eval_poly(c0.moduli)
    cs = rns.mul(c0, s) if c1 is None else rns.add(rns.mul(c1, s), c0)
    return _polynomial_round(rns.to_coeff(cs))


def int_boot_encrypt(params, pk: rlwe.PublicKey, h: RnsPoly, ct_low,
                     rng: np.random.Generator):
    """IntBootEncrypt: centered-lift the rounded share to the full basis
    and encrypt it under the (joint) public key (rns-multiparty.cpp:
    405-480)."""
    from .ckks import Ciphertext
    m_full = rns.to_eval(_centered_lift(h, tuple(params.moduli)))
    c0, c1 = rlwe.encrypt_pk(params, pk, m_full, rng)
    return Ciphertext(c0, c1, ct_low.scale)


def int_boot_add(params, ct_full, h: RnsPoly):
    """IntBootAdd: centered-lift the server's rounded share and add it to
    the refreshed ciphertext's c0 (rns-multiparty.cpp:483-506)."""
    from .ckks import Ciphertext
    h_full = rns.to_eval(_centered_lift(h, tuple(params.moduli)))
    return Ciphertext(rns.add(ct_full.c0, h_full), ct_full.c1, ct_full.scale)


# ---------------------------------------------------------------------------
# Interactive multiparty bootstrapping (IntMPBoot*, cryptocontext.h:3422-3507;
# ckksrns-multiparty.cpp IntMPBootDecrypt :352, IntMPBootEncrypt :407,
# IntMPBootAdjustScale :452)
# ---------------------------------------------------------------------------
#
# Encryption-to-Share / Share-to-Encryption (party i, joint secret
# s = sum_i s_i), over the compressed basis Qc of the input ciphertext:
#   h0_i = (s_i c1 + e0_i - M_i) mod Qc     (masked decryption share)
#   h1_i = -s_i a + e1_i + M_i              (re-encryption share, mod Q)
# with integer masks M_i uniform in [0, Qc/(8n)).  The mod-Qc arithmetic in
# h0 kills the q I phase wrap, and with the masks' bound and |m + e| < Qc/8
# the centered representative of w = (c0 + sum h0_i) mod Qc is
# m + e - sum M_i exactly.  Lifting w to the full basis and adding
# sum h1_i cancels the masks: c0' = lift(w) + sum h1_i, c1' = a,
# c0' + a s = m + e.
#
# Statistical hiding (the reference's M_i uniform over R_{q 2^lambda},
# ckksrns-multiparty.cpp GenerateMi :288-299 and the exact lift of
# ExpandCRTBasis :313-325): the compressed basis keeps `extra_limbs` limbs
# above the base rescale block (int_boot_adjust_scale), so the mask range
# Qc/(8n) exceeds the value bound |m + e| ~ scale by
# lambda = log2(Qc / (8n scale)) bits.


@dataclasses.dataclass(frozen=True, eq=False)
class IntBootShares:
    h0: RnsPoly     # masked decryption share over Qc (EVAL)
    h1: RnsPoly     # re-encryption share over Q (EVAL)
    n_parties: int


def _centered_lift(p: RnsPoly, to_mods: tuple) -> RnsPoly:
    """Host: centered CRT lift of a COEFF poly to another basis."""
    big = rns.to_bigint(p)
    Qc = rns.modulus_product(p.moduli)
    half = Qc // 2
    signed = np.array([int(x) - Qc if int(x) > half else int(x) for x in big], dtype=object)
    return rlwe.signed_to_rns(signed, to_mods, device=p.data.device)


def int_boot_adjust_scale(ctx, ct, extra_limbs: int = 2):
    """IntBootAdjustScale: compress the ciphertext to the base rescale
    block plus `extra_limbs` statistical-hiding limbs (Compress(...),
    ckksrns-multiparty.cpp:452)."""
    from .ckks import Ciphertext
    keep = min(ctx.cd + extra_limbs, len(ct.moduli))
    drop = len(ct.moduli) - keep
    if drop <= 0:
        return ct
    return Ciphertext(rns.level_reduce(ct.c0, drop), rns.level_reduce(ct.c1, drop), ct.scale)


def int_mp_boot_random_gen(params, rng: np.random.Generator, device="cuda") -> RnsPoly:
    """IntMPBootRandomElementGen: the common random polynomial `a` over the
    full chain (a CRS, drawn once and shared)."""
    return rlwe.uniform_poly(rng, tuple(params.moduli), params.N, device=device)


def _bounded_mask(rng: np.random.Generator, N: int, bound: int) -> np.ndarray:
    """N integers uniform in [0, bound) as Python ints, drawn in base-2^62
    chunks in fhe_tpu's order."""
    out = np.empty(N, dtype=object)
    for i in range(N):
        v = 0
        b = bound
        while b > 0:
            chunk = min(b, 1 << 62)
            v = v * chunk + int(rng.integers(0, chunk))
            b //= 1 << 62
        out[i] = v % bound
    return out


def int_mp_boot_decrypt(params, sk: rlwe.SecretKey, ct_low, a: RnsPoly,
                        rng: np.random.Generator, n_parties: int = 2) -> IntBootShares:
    """IntMPBootDecrypt: one party's (masked decryption, re-encryption)
    share pair."""
    full_mods = tuple(params.moduli)
    qc_mods = ct_low.moduli
    dev = a.data.device
    m_coeffs = _bounded_mask(rng, params.N, rns.modulus_product(qc_mods) // (8 * n_parties))
    m_qc = rns.to_eval(rlwe.signed_to_rns(m_coeffs, qc_mods, device=dev))
    m_full = rns.to_eval(rlwe.signed_to_rns(m_coeffs, full_mods, device=dev))
    e0 = rlwe._gauss_eval(params, rng, qc_mods, dev)
    h0 = rns.sub(rns.add(rns.mul(sk.eval_poly(qc_mods), ct_low.c1), e0), m_qc)
    e1 = rlwe._gauss_eval(params, rng, full_mods, dev)
    h1 = rns.add(rns.add(rns.neg(rns.mul(sk.eval_poly(full_mods), a)), e1), m_full)
    return IntBootShares(h0=h0, h1=h1, n_parties=n_parties)


def int_mp_boot_add(shares: list[IntBootShares]) -> IntBootShares:
    """IntMPBootAdd: aggregate all parties' share pairs."""
    h0, h1 = shares[0].h0, shares[0].h1
    for s in shares[1:]:
        h0 = rns.add(h0, s.h0)
        h1 = rns.add(h1, s.h1)
    return IntBootShares(h0=h0, h1=h1, n_parties=shares[0].n_parties)


def int_mp_boot_encrypt(params, ct_low, agg: IntBootShares, a: RnsPoly):
    """IntMPBootEncrypt: the refreshed full-level ciphertext
    c0' = lift(c0 + h0) + h1, c1' = a."""
    from .ckks import Ciphertext
    w = rns.add(ct_low.c0, agg.h0)
    w_full = rns.to_eval(_centered_lift(rns.to_coeff(w), tuple(params.moduli)))
    return Ciphertext(rns.add(w_full, agg.h1), a, ct_low.scale)
