"""Scheme switching between CKKS and FHEW/TFHE.  Port of
fhe_tpu/pke/schemeswitch.py.

Reference semantics: ckksrns-schemeswitching.h:64-114 (EvalCKKStoFHEWSetup/
KeyGen/EvalCKKStoFHEW, EvalFHEWtoCKKSSetup/KeyGen/EvalFHEWtoCKKS,
EvalCompareSwitchPrecompute/EvalCompareSchemeSwitching,
EvalMin/MaxSchemeSwitching); implementation ckksrns-schemeswitching.cpp.

Pipeline:
* CKKS -> FHEW: SlotsToCoeffs with the target-modulus scaling folded into
  the E_lo matrix -> LevelReduce to one limb -> per-coefficient LWE
  extraction -> ModSwitch to the FHEW gate modulus -> (optional) LWE
  KeySwitch to the FHEW key.
* FHEW -> CKKS: the LWE phase b - <a, s> is computed homomorphically with
  a CKKS encryption of the FHEW secret (one BSGS plaintext-matrix
  transform of A against the encrypted key), then the discretized message
  is recovered with a Chebyshev sine interpolation, riding the same
  primitives as bootstrapping.
* Compare/Sign/Min/Max: difference -> CKKS->FHEW -> EvalSign (functional
  bootstrap, eprint 2021/1337) -> FHEW->CKKS if values are needed.

The CKKS side issues fhe_tpu's CkksContext ops in fhe_tpu's order on the
ciphertexts' device (kernels 1-2 under every NTT on a CUDA device); the
FHEW side is the port's tfhe package (kernels 3-5 under EvalSign's
bootstraps).  Where fhe_tpu gathers all N extractions through cached
[N, N] index and sign tables, the port builds only the rows the caller
keeps, as one gather on the ciphertext's device (the same rows).  The
plaintext matrices and their diagonals stay on the host, as in fhe_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..lattice import rns
from ..tfhe import lwe as tlwe
from ..tfhe.params import TfheParams
from . import rlwe
from .advanced import eval_chebyshev_series_ps, mul_aligned
from .bootstrap import _E_lo, _bsgs_rotations, _double_angle, _sine_cheb_coeffs, \
    bsgs_linear_transform
from .ckks import Ciphertext, CkksContext


# ---------------------------------------------------------------------------
# LWE extraction from RLWE (sample extract)
# ---------------------------------------------------------------------------

def extract_lwe_all(ct_c0: torch.Tensor, ct_c1: torch.Tensor, q: int,
                    pt_mod: int = 4, num: int | None = None) -> tlwe.LweCiphertext:
    """All-coefficient LWE extraction from a single-limb RLWE pair
    (COEFF, [N] residues mod q): a batch of LWE ciphertexts over the ring
    secret, with the b - <a, s> phase convention of lwe.decrypt.  Row j
    is a_j[k] = -c1[j - k] for k <= j and c1[N + j - k] above (the
    negacyclic wrap); with num, only the rows j < num are built."""
    N = ct_c1.shape[-1]
    num = N if num is None else num
    dev = ct_c1.device
    r = ct_c1.to(torch.int64).flip(0)
    # window i of [r, r] is r[i:i + N]; row j is window N - 1 - j:
    # c1[(j - k) mod N] = r[(N - 1 - j + k) mod N]
    g = torch.cat([r, r]).unfold(0, N, 1)[N - num:N].flip(0)
    j = torch.arange(num, device=dev)[:, None]
    k = torch.arange(N, device=dev)[None, :]
    a = torch.where(k <= j, (q - g) % q, g)
    return tlwe.LweCiphertext(a=a.to(torch.int32), b=ct_c0[:num].to(torch.int32),
                              modulus=q, pt_mod=pt_mod)


# ---------------------------------------------------------------------------
# CKKS -> FHEW
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CkksToFhewKey:
    rot_keys: dict            # CKKS rotation keys for the StC transform
    ksk: "tlwe.LweSwitchingKey | None"   # ring-key -> FHEW-key LWE switch
    bsgs_g: int
    slots: int
    scale_cf: float = 1.0     # EvalCompareSwitchPrecompute extra factor


def ckks_to_fhew_setup(ctx: CkksContext, sk: rlwe.SecretKey,
                       fhew_params: TfheParams | None,
                       fhew_sk: "tlwe.LweSecretKey | None",
                       rng: np.random.Generator) -> CkksToFhewKey:
    """EvalCKKStoFHEWSetup/KeyGen (ckksrns-schemeswitching.h:64-80):
    StC rotation keys + LWE switching key from the CKKS ring secret to
    the FHEW secret (drawn on the host in fhe_tpu's order, on the FHEW
    secret's device)."""
    n = ctx.params.N // 2
    g, rots = _bsgs_rotations(n)
    rot_keys = ctx.rotation_key_gen(sk, rots, rng)
    ksk = None
    if fhew_params is not None and fhew_sk is not None:
        ring_sk = tlwe.LweSecretKey(s=sk.s_signed.to(torch.int32))
        ksk = tlwe.key_switch_gen(fhew_params, fhew_sk, ring_sk, rng)
    return CkksToFhewKey(rot_keys=rot_keys, ksk=ksk, bsgs_g=g, slots=n)


def eval_ckks_to_fhew(ctx: CkksContext, key: CkksToFhewKey, ct: Ciphertext,
                      p: int = 4, num_values: int | None = None,
                      fhew_params: TfheParams | None = None,
                      keep_large_modulus: bool = False
                      ) -> tlwe.LweCiphertext:
    """EvalCKKStoFHEW (ckksrns-schemeswitching.h:82): slots hold small
    integers in [0, p); returns LWE encryptions of them.

    The q_b/p discretization is folded into the StC matrix so the RLWE
    coefficients land directly on the LWE encoding grid."""
    N = ctx.params.N
    n = key.slots
    num = num_values or n
    # StC matrix pre-scaled so coefficient j lands on the LWE encoding
    # grid: p_out = S_stc * alpha * z = (q_b / p) * z  (q_b = limb 0)
    q_b = int(ctx.params.moduli[0])
    s_out = ctx.level_scale(len(ct.moduli) - ctx.cd)
    alpha = q_b / (p * s_out) * key.scale_cf
    out = bsgs_linear_transform(
        ctx, ct, _E_lo(N) * alpha, key.rot_keys, key.bsgs_g)
    # drop to the base limb: RLWE mod q_b
    drop = len(out.moduli) - 1
    c0 = rns.to_coeff(rns.level_reduce(out.c0, drop) if drop else out.c0)
    c1 = rns.to_coeff(rns.level_reduce(out.c1, drop) if drop else out.c1)
    cts = extract_lwe_all(c0.data[0], c1.data[0], q_b, p, num=num)
    if fhew_params is not None and key.ksk is not None:
        if keep_large_modulus:
            # stay at qKS for the large-precision sign/compare pipeline
            cts = tlwe.key_switch(fhew_params, key.ksk,
                                  tlwe.mod_switch(cts, fhew_params.q_ks))
        else:
            # ModSwitch(qKS) -> KeySwitch(N->n) -> ModSwitch(q), mirroring
            # lwe-pke.cpp SwitchCTtoqn:170-178
            cts = tlwe.switch_ct_to_qn(fhew_params, key.ksk, cts)
    return cts


# ---------------------------------------------------------------------------
# FHEW -> CKKS
# ---------------------------------------------------------------------------

def _neg(ct: Ciphertext) -> Ciphertext:
    return Ciphertext(rns.neg(ct.c0), rns.neg(ct.c1), ct.scale)


@dataclasses.dataclass
class FhewToCkksKey:
    enc_sk: Ciphertext        # CKKS encryption of the FHEW secret (slots)
    rot_keys: dict
    bsgs_g: int


def fhew_to_ckks_setup(ctx: CkksContext, sk: rlwe.SecretKey,
                       fhew_sk: "tlwe.LweSecretKey",
                       pk: rlwe.PublicKey,
                       rng: np.random.Generator) -> FhewToCkksKey:
    """EvalFHEWtoCKKSSetup/KeyGen (:94-104): encrypt the FHEW secret into
    CKKS slots + rotation keys for the A-matrix transform."""
    slots = ctx.params.N // 2
    s = fhew_sk.s.cpu().numpy().astype(np.float64)
    z = np.zeros(slots)
    z[:len(s)] = s
    enc_sk = ctx.encrypt(pk, z, rng)
    g, rots = _bsgs_rotations(slots)
    rot_keys = ctx.rotation_key_gen(sk, rots, rng)
    return FhewToCkksKey(enc_sk=enc_sk, rot_keys=rot_keys, bsgs_g=g)


def eval_fhew_to_ckks(ctx: CkksContext, key: FhewToCkksKey,
                      cts: tlwe.LweCiphertext, evk,
                      p: int = 4, pmin: float = 0.0,
                      pmax: float = 1.0) -> Ciphertext:
    """EvalFHEWtoCKKS (:106): homomorphically compute the LWE phases
    (b - A s)/q in CKKS slots, then interpolate the message with a
    Chebyshev sine series (1/2pi)*sin(2*pi*x) ~ frac(x), scaled by p."""
    slots = ctx.params.N // 2
    q = cts.modulus
    B = int(np.prod(cts.batch_shape)) if cts.batch_shape else 1
    a = cts.a.reshape(B, -1).cpu().numpy().astype(np.float64)
    b = cts.b.reshape(B).cpu().numpy().astype(np.float64)
    n_f = a.shape[1]
    assert B <= slots and n_f <= slots
    # The phase b - <a, s> is computed over the REALS (no mod-q wrap), so
    # it equals encode(m)/q + e/q + integer drift of magnitude up to
    # ~||s||_1; the periodic sine absorbs the drift exactly like the
    # bootstrap's mod-raise integers.  Normalize by a range bound K.
    K = int(3 * np.sqrt(n_f)) + 8
    M = np.zeros((slots, slots))
    M[:B, :n_f] = a / (q * K)
    As = bsgs_linear_transform(ctx, key.enc_sk, M, key.rot_keys,
                               key.bsgs_g)
    bz = np.zeros(slots)
    bz[:B] = b / (q * K)
    phase = ctx.add_plain(_neg(As), bz)
    # Sine interpolation of the phase (reference EvalFHEWtoCKKS,
    # ckksrns-schemeswitching.cpp:1550-1690).  p <= 4 (binary gate
    # outputs at {0, q/4}): sin(2*pi*x) maps {0, 1/4} to {0, 1} with a
    # FLAT response at 1 (cos(pi/2) = 0); post-scale 2*pi.  p > 4
    # (p-ary): post-scale p, giving y ~ (p/2pi)*sin(2*pi*m/p) -- the
    # reference's documented p-ary contract (exact near m = 0 mod p,
    # sinc-attenuated further out; callers with centered ranges pass
    # pmin/pmax for the affine remap, :1663-1676).
    coeffs = _sine_cheb_coeffs(K, r=3, tol=1e-7)
    y = eval_chebyshev_series_ps(ctx, phase, coeffs, -1.0, 1.0, evk)
    y = _double_angle(ctx, y, evk, 3)
    post_scale = 2.0 * np.pi if 1 <= p <= 4 else float(p)
    post_bias = 0.0
    if pmin != 0.0:
        post_scale *= (pmax - pmin) / 4.0
        post_bias = (pmax - pmin) / 4.0
    # zero-fill beyond the B decoded values (the reference's post-scale
    # plaintext has length numValues, :1671-1675) so junk slots vanish --
    # required by the min/max tournament masks
    sc = np.zeros(slots)
    sc[:B] = post_scale
    # rescale so the result lands ON the level-target scale: without it
    # the ~2^52 product scale poisons every downstream mul_plain
    out = ctx.rescale(ctx.mul_plain(y, sc))
    if post_bias:
        bias = np.zeros(slots)
        bias[:B] = post_bias
        out = ctx.add_plain(out, bias)
    return out


# ---------------------------------------------------------------------------
# comparison / sign / min / max via scheme switching
# ---------------------------------------------------------------------------

def eval_sign_scheme_switching(ctx: CkksContext, key: CkksToFhewKey,
                               ct_diff: Ciphertext, tfhe_ctx,
                               tfhe_key, p: int = 8,
                               num_values: int | None = None
                               ) -> tlwe.LweCiphertext:
    """EvalSignSchemeSwitching-style: CKKS difference -> FHEW at the
    large key-switch modulus -> EvalSign (large-precision MSB via
    iterated flooring, eprint 2021/1337).  p must exceed twice the
    difference range so negatives land in the upper half."""
    lwe_cts = eval_ckks_to_fhew(ctx, key, ct_diff, p=p,
                                num_values=num_values,
                                fhew_params=tfhe_ctx.params,
                                keep_large_modulus=True)
    return tfhe_ctx.eval_sign(tfhe_key, lwe_cts)


def _tournament_select(ctx: CkksContext, key: CkksToFhewKey,
                       k2: FhewToCkksKey, ct: Ciphertext, tfhe_ctx,
                       tfhe_key, evk, rot_keys: dict, num_values: int, p: int,
                       want_min: bool) -> tuple[Ciphertext, Ciphertext]:
    """Shared EvalMin/MaxSchemeSwitching body (reference
    ckksrns-schemeswitching.cpp:1930-2014 / :2094+): log2(numValues)
    rounds of [compare first half vs rotated second half -> FHEW sign
    bootstrap -> selector back in CKKS -> masked select], tracking a
    one-hot argmin/argmax indicator alongside."""
    slots = ctx.params.N // 2
    n_ind = np.zeros(slots)
    n_ind[:num_values] = 1.0
    c_ind = None                      # becomes a ciphertext on first mult
    h = num_values // 2
    while h >= 1:
        rot_b = ctx.rotate(ct, h, rot_keys)
        diff = ctx.sub(ct, rot_b)
        lwe_cts = eval_ckks_to_fhew(ctx, key, diff, p=p, num_values=h,
                                    fhew_params=tfhe_ctx.params,
                                    keep_large_modulus=True)
        # scheme_switch=True encodes the sign at +-q/4 (reference
        # EvalSign(ct, true)), decoded by the (p=4, pmin=-1, pmax=1)
        # affine sine map to a clean {0,1} selector:
        # 1 in slot j iff ct_j < ct_{j+h} (junk slots zeroed)
        lwe_sign = tfhe_ctx.eval_sign(tfhe_key, lwe_cts,
                                      scheme_switch=True)
        csel = eval_fhew_to_ckks(ctx, k2, lwe_sign, evk, p=4,
                                 pmin=-1.0, pmax=1.0)
        if not want_min:
            ones_h = np.zeros(slots)
            ones_h[:h] = 1.0
            csel = ctx.add_plain(_neg(csel), ones_h)   # 1 - c: keep the LARGER first value
        # mask = [keep-first ; keep-second] over 2h slots, 0 elsewhere
        ones_h = np.zeros(slots)
        ones_h[:h] = 1.0
        inv = ctx.add_plain(_neg(csel), ones_h)
        mask = ctx.add(csel, ctx.rotate(inv, -h, rot_keys))
        # replicate the 2h-pattern across all numValues lanes
        j = 2 * h
        while j < num_values:
            mask = ctx.add(mask, ctx.rotate(mask, -j, rot_keys))
            j <<= 1
        ct = mul_aligned(ctx, ct, mask, evk)       # rescales internally
        ct = ctx.add(ct, ctx.rotate(ct, h, rot_keys))
        if c_ind is None:
            c_ind = ctx.rescale(ctx.mul_plain(mask, n_ind))
        else:
            c_ind = mul_aligned(ctx, c_ind, mask, evk)
        h //= 2
    return ct, c_ind


def eval_min_scheme_switching(ctx: CkksContext, key: CkksToFhewKey,
                              k2: FhewToCkksKey, ct: Ciphertext,
                              tfhe_ctx, tfhe_key, evk,
                              rot_keys: dict, num_values: int,
                              p: int = 8) -> tuple[Ciphertext, Ciphertext]:
    """EvalMinSchemeSwitching: returns (min ciphertext -- slot 0 holds
    min(ct[0:numValues]) -- , one-hot argmin indicator).  numValues must
    be a power of two; rot_keys needs indices {+-h, -2h...} for
    h = numValues/2, ..., 1."""
    return _tournament_select(ctx, key, k2, ct, tfhe_ctx, tfhe_key, evk,
                              rot_keys, num_values, p, want_min=True)


def eval_max_scheme_switching(ctx: CkksContext, key: CkksToFhewKey,
                              k2: FhewToCkksKey, ct: Ciphertext,
                              tfhe_ctx, tfhe_key, evk,
                              rot_keys: dict, num_values: int,
                              p: int = 8) -> tuple[Ciphertext, Ciphertext]:
    """EvalMaxSchemeSwitching (:2094): the max-variant tournament."""
    return _tournament_select(ctx, key, k2, ct, tfhe_ctx, tfhe_key, evk,
                              rot_keys, num_values, p, want_min=False)


def _tournament_select_alt(ctx: CkksContext, key: CkksToFhewKey,
                           k2: FhewToCkksKey, ct: Ciphertext, tfhe_ctx,
                           tfhe_key, evk, rot_keys: dict, num_values: int, p: int,
                           want_min: bool) -> tuple[Ciphertext, Ciphertext]:
    """EvalMin/MaxSchemeSwitchingAlt (ckksrns-schemeswitching.cpp:2013-2174):
    the full numValues-wide selector is assembled in the FHEW domain by
    duplicating each sign bit and its NEGATION (EvalAddConstEq b += q/2
    flips the +-q/4 encoding), so ONE FHEW->CKKS conversion of numValues
    LWE ciphertexts replaces the non-Alt complement-and-rotate CKKS mask
    expansion -- more work in the batched conversion, fewer CKKS
    rotations."""
    slots = ctx.params.N // 2
    n_ind = np.zeros(slots)
    n_ind[:num_values] = 1.0
    c_ind = None
    h = num_values // 2
    while h >= 1:
        rot_b = ctx.rotate(ct, h, rot_keys)
        diff = ctx.sub(ct, rot_b)
        lwe_cts = eval_ckks_to_fhew(ctx, key, diff, p=p, num_values=h,
                                    fhew_params=tfhe_ctx.params,
                                    keep_large_modulus=True)
        lwe_sign = tfhe_ctx.eval_sign(tfhe_key, lwe_cts,
                                      scheme_switch=True)
        # duplicate sign / negated-sign across the num_values lanes:
        # groups of h alternate [keep-first, keep-second] -- the Alt
        # LWESign[i*h + j] layout (:2054-2061)
        a = lwe_sign.a.to(torch.int64)                 # [h, n]
        b = lwe_sign.b.to(torch.int64)                 # [h]
        q = int(lwe_sign.modulus)
        b_neg = (b + q // 2) % q
        reps = num_values // h
        first, second = (b, b_neg) if want_min else (b_neg, b)
        a_full = a.repeat(reps, 1)
        b_full = torch.cat([first if (i % 2 == 0) else second
                            for i in range(reps)])
        sel_lwe = tlwe.LweCiphertext(a=a_full.to(torch.int32), b=b_full.to(torch.int32),
                                     modulus=q, pt_mod=lwe_sign.pt_mod)
        mask = eval_fhew_to_ckks(ctx, k2, sel_lwe, evk, p=4,
                                 pmin=-1.0, pmax=1.0)
        ct = mul_aligned(ctx, ct, mask, evk)
        ct = ctx.add(ct, ctx.rotate(ct, h, rot_keys))
        if c_ind is None:
            c_ind = ctx.rescale(ctx.mul_plain(mask, n_ind))
        else:
            c_ind = mul_aligned(ctx, c_ind, mask, evk)
        h //= 2
    return ct, c_ind


def eval_min_scheme_switching_alt(ctx: CkksContext, key: CkksToFhewKey,
                                  k2: FhewToCkksKey, ct: Ciphertext,
                                  tfhe_ctx, tfhe_key, evk,
                                  rot_keys: dict, num_values: int,
                                  p: int = 8
                                  ) -> tuple[Ciphertext, Ciphertext]:
    """EvalMinSchemeSwitchingAlt (:2013)."""
    return _tournament_select_alt(ctx, key, k2, ct, tfhe_ctx, tfhe_key,
                                  evk, rot_keys, num_values, p,
                                  want_min=True)


def eval_max_scheme_switching_alt(ctx: CkksContext, key: CkksToFhewKey,
                                  k2: FhewToCkksKey, ct: Ciphertext,
                                  tfhe_ctx, tfhe_key, evk,
                                  rot_keys: dict, num_values: int,
                                  p: int = 8
                                  ) -> tuple[Ciphertext, Ciphertext]:
    """EvalMaxSchemeSwitchingAlt (:2174)."""
    return _tournament_select_alt(ctx, key, k2, ct, tfhe_ctx, tfhe_key,
                                  evk, rot_keys, num_values, p,
                                  want_min=False)


def eval_compare_switch_precompute(key: CkksToFhewKey,
                                   scale_sign: float = 1.0,
                                   unit: bool = False) -> CkksToFhewKey:
    """EvalCompareSwitchPrecompute (ckksrns-schemeswitching.cpp:1878):
    fold an extra scaling of the comparison difference into the CKKS->FHEW
    transform (the 1/pLWE part is already alpha's /p; scale_sign shrinks
    large-range differences into the sign bootstrap's clean range).
    unit=True means the messages are pre-scaled to [0,1), so only
    scale_sign applies -- identical contract, functional style: returns a
    key with the factor set."""
    return dataclasses.replace(key, scale_cf=float(scale_sign))


def min_max_rotation_indices_alt(num_values: int) -> list[int]:
    """Rotation-key indices the Alt tournament needs (only +h per round --
    no mask-expansion rotations)."""
    idx = set()
    h = num_values // 2
    while h >= 1:
        idx.add(h)
        h //= 2
    return sorted(idx)


def min_max_rotation_indices(num_values: int) -> list[int]:
    """Rotation-key indices the tournament needs."""
    idx = set()
    h = num_values // 2
    while h >= 1:
        idx.update([h, -h])
        j = 2 * h
        while j < num_values:
            idx.add(-j)
            j <<= 1
        h //= 2
    return sorted(idx)


def eval_compare_scheme_switching(ctx: CkksContext, key: CkksToFhewKey,
                                  ct1: Ciphertext, ct2: Ciphertext,
                                  tfhe_ctx, tfhe_key, scale: float = 1.0,
                                  p: int = 8,
                                  num_values: int | None = None
                                  ) -> tlwe.LweCiphertext:
    """EvalCompareSchemeSwitching (:100): sign(ct1 - ct2) as FHEW bits
    (1 if ct1 < ct2, matching the reference's convention of returning the
    sign of the difference)."""
    diff = ctx.sub(ct1, ct2)
    if scale != 1.0:
        diff = ctx.rescale(ctx.mul_plain(diff, np.full(
            ctx.params.N // 2, scale)))
    return eval_sign_scheme_switching(ctx, key, diff, tfhe_ctx, tfhe_key,
                                      p, num_values)
