"""CKKS functional bootstrapping (FBT): arbitrary lookup-table evaluation
over RLWE-encrypted digits via trigonometric Hermite interpolation
(Alexandru-Kim-Polyakov, CRYPTO 2025 / eprint 2024/1623).  Port of
fhe_tpu/pke/fbt.py.

Reference: the reference's ckksrns-fhe.cpp -- EvalFBTSetup (:2533),
EvalMVBPrecompute (:2724; raise, CoeffsToSlots, complex-exponential
Chebyshev + double-angle squarings, EvalPowers), EvalMVBNoDecoding (:3006;
Hermite power series + real part), EvalHomDecoding (:2681; SlotsToCoeffs
+ post scaling); coefficients: hermite.cpp GetHermiteTrigCoefficients;
schemelet: rlwe-mp.cpp (EncryptCoeff/DecryptCoeff/ConvertRLWEToCKKS/
ConvertCKKSToRLWE).

Pipeline: an RLWE ciphertext over Z_Bigq[X]/(X^N+1) (Bigq a power of two,
secret shared with the CKKS context) encodes digits m_t in Z_PIn as
coefficients m_t * Bigq/PIn.  Conversion to CKKS is a modulus switch to
the base block q0.  eval_fbt then raises to the full chain (coefficients
w + q0*I), runs CoeffsToSlots (slot values x = c/(K*q0)), evaluates
z = exp(2*pi*i*K*x) = exp(2*pi*i*m/PIn + noise) by a complex Chebyshev
series + r squarings (the overflow integers I vanish in the exponential),
computes the power basis z^j once (reusable across LUTs: multi-value
bootstrapping), evaluates the Hermite trigonometric interpolation
sum_j a_j z^j whose real part is f(m)/scale_thi, and SlotsToCoeffs back to
a coefficient encoding.

As in fhe_tpu: scales are float64 labels on the ciphertext, so the
reference's correction multiply and post-scaling integer multiply are an
encode-scale target and one final relabel; the exponential's Chebyshev
table is fitted at setup for the exact K; the sparse path (slots < N/2)
folds the partial-sum factor d into the conversion scale and shares the
sparse bootstrap's rectangular transforms.

The host setup (coefficients, fits, E_lo) is numpy, fhe_tpu's copied.
The schemelet keeps fhe_tpu's exact Python integers (object arrays on the
host), but its negacyclic product a*s, an object-dtype convolution in
fhe_tpu, is computed here by NTTs over enough 31-bit primes to hold it
(kernels 1-2 on a CUDA device, the plain NTT on the CPU) and a centred
CRT: the same integers.  The evaluation issues fhe_tpu's CkksContext ops
in fhe_tpu's order on the ciphertexts' device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from ..lattice import rns
from ..math import primes
from . import rlwe
from .advanced import add_aligned, eval_chebyshev_series_ps, mul_aligned
from .bootstrap import (_E_lo, _bsgs_rotations, _conjugate_split, _q0, _raise,
                        bsgs_linear_transform, bsgs_rect_transform)
from .ckks import Ciphertext, CkksContext


# ---------------------------------------------------------------------------
# Hermite trigonometric interpolation coefficients (host, float64)
# ---------------------------------------------------------------------------

def get_hermite_trig_coefficients(func, p: int, order: int = 1,
                                  scale: float = 1.0) -> np.ndarray:
    """Complex power-series coefficients a_j such that
    f(m)/scale ~= 2*Re(sum_j a_j z^j), z = exp(2*pi*i*m/p), matching the
    value (order>=1), first (order>=2) and second (order 3) derivatives
    of the trigonometric interpolant at the p interpolation points --
    which is what makes the LUT robust to the encrypted phase noise.

    Port of GetHermiteTrigCoefficients (hermite.cpp:54-185; same
    normalization: coefficients pre-divided by 2 for the final real-part
    extraction, a_0 halved once more)."""
    if p <= 0:
        raise ValueError("p must be positive")
    if order not in (1, 2, 3):
        raise ValueError("order must be 1, 2, or 3")
    j = np.arange(p)
    y = np.array([float(func(int(v))) for v in j])

    # DFT sums F_i = sum_j f(j) e^{-2 pi i * i * j / p} for any integer i
    def F(i):
        return np.sum(y * np.exp(-2j * np.pi * i * j / p))

    delta = 2.0 ** -32
    if order == 1:
        coeffs = np.zeros(p, dtype=np.complex128)
        for i in range(p):
            coeffs[i] = F(i) * (p - i) / (p * p) / scale
        coeffs[0] /= 2.0
    elif order == 2:
        pby2 = p >> 1
        total = p + pby2 + 1
        coeffs = np.zeros(total, dtype=np.complex128)
        alpha = np.array([F(i) * 2.0 * (p - i) / (p * p) / 2.0 / scale
                          for i in range(p)])
        alpha[0] /= 2.0
        gamma = np.zeros(pby2)
        if p % 2 == 0 and pby2 > 0:
            gamma[-1] = 1.0
        beta = np.zeros(pby2, dtype=np.complex128)
        dlt = np.zeros(pby2, dtype=np.complex128)
        omg = np.zeros(pby2, dtype=np.complex128)
        for i in range(1, pby2 + 1):
            factor = ((2.0 - gamma[i - 1]) * i * (p - i)
                      / (p * p) / p / 2.0 / scale)
            beta[i - 1] = F(i) * factor
            dlt[i - 1] = F(p + i) * factor / 2.0
            omg[i - 1] = F(p - i) * factor / 2.0
        coeffs[0] = alpha[0]
        for i in range(1, total):
            if i < p:
                coeffs[i] = alpha[i]
            if i <= pby2:
                coeffs[i] += beta[i - 1]
            if pby2 <= i < p:
                coeffs[i] -= omg[p - i - 1]
            if i > p:
                coeffs[i] -= dlt[i - p - 1]
    else:  # order == 3
        total = 2 * p
        coeffs = np.zeros(total, dtype=np.complex128)
        alpha = np.array([F(i) * 2.0 * (p - i) / (p * p) / 2.0 / scale
                          for i in range(p)])
        alpha[0] /= 2.0
        beta = np.zeros(p - 1, dtype=np.complex128)
        dlt = np.zeros(p - 1, dtype=np.complex128)
        omg = np.zeros(p - 1, dtype=np.complex128)
        for i in range(1, p):
            factor = (2.0 * i * (p - i) * (2.0 * p - i) / 3.0
                      / (p * p) / (p * p) / 2.0 / scale)
            beta[i - 1] = F(i) * factor
            dlt[i - 1] = F(p + i) * factor / 2.0
            omg[i - 1] = F(p - i) * factor / 2.0
        coeffs[0] = alpha[0]
        for i in range(1, total):
            if i < p:
                coeffs[i] = alpha[i]
            if i <= p - 1:
                coeffs[i] += beta[i - 1]
            if 1 <= i < p:
                coeffs[i] -= omg[p - i - 1]
            if i > p:
                coeffs[i] -= dlt[i - p - 1]
    # trim trailing ~zero coefficients (reference IsNotEqualZero walk)
    deg = 0
    for i in range(len(coeffs)):
        if abs(coeffs[i].real) >= delta or abs(coeffs[i].imag) >= delta:
            deg = i
    return coeffs[:deg + 1]


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FbtPrecom:
    """Duck-compatible with bootstrap.BootstrapPrecom for keygen: same
    rot_indices / E_lo / slots fields, but the Chebyshev series is the
    complex exponential (exp_coeffs) instead of the scaled cosine."""
    slots: int
    K: int
    r: int
    exp_coeffs: list            # complex Chebyshev coeffs of exp stage
    E_lo: np.ndarray
    rot_indices: list
    bsgs_g: int


def _exp_cheb_coeffs(K: int, r: int, tol: float = 1e-10,
                     max_deg: int = 2048) -> list[complex]:
    """Chebyshev coefficients (T_k on [-1,1]) of
    g(y) = exp(2*pi*i*K*y / 2^r); after r squarings: exp(2*pi*i*K*y).
    (The reference ships fixed tables coeff_exp_{16,25}_double_*,
    ckksrns-fhe.h; here fitted numerically for the actual K.)"""
    a = 2.0 * np.pi * K / (1 << r)

    def f(y):
        return np.exp(1j * a * y)

    grid = np.linspace(-1, 1, 4001)
    deg = max(8, int(a) + 8)
    while deg <= max_deg:
        jj = np.arange(deg + 1)
        nodes = np.cos(np.pi * (jj + 0.5) / (deg + 1))
        fv = f(nodes)
        coeffs = [2.0 / (deg + 1) * np.sum(fv * np.cos(k * np.arccos(nodes)))
                  for k in range(deg + 1)]
        coeffs[0] /= 2
        approx = np.polynomial.chebyshev.chebval(grid, coeffs)
        if np.max(np.abs(approx - f(grid))) < tol:
            return [complex(c) for c in coeffs]
        deg += max(8, deg // 4)
    raise ValueError("exp Chebyshev fit did not converge")


def setup(ctx: CkksContext, h: int, r: int = 2, tol: float = 1e-10,
          slots: int | None = None) -> FbtPrecom:
    """EvalFBTSetup: linear-transform matrices + complex-exponential
    approximation for a sparse secret of Hamming weight h (FBT requires
    sparse or encapsulated secrets).  slots < N/2 selects the sparsely
    packed pipeline."""
    N = ctx.params.N
    n = N // 2
    s = slots or n
    if n % s or s > n:
        raise ValueError("slots must be a power-of-two divisor of N/2")
    d = n // s
    K = (h + 1) // 2 + 4
    if d > 1:
        K = int(math.ceil(K * math.sqrt(d)))
    coeffs = _exp_cheb_coeffs(K, r, tol)
    if d == 1:
        E = _E_lo(N)
        g, rots = _bsgs_rotations(n)
    else:
        E = _E_lo(2 * s)
        g, rots = _bsgs_rotations(s)
        part = [s << i for i in range((n // s).bit_length() - 1)]
        rots = sorted(set(rots + part + [s]))
    return FbtPrecom(slots=s, K=K, r=r, exp_coeffs=coeffs, E_lo=E,
                     rot_indices=rots, bsgs_g=g)


def get_fbt_depth(p_in: int, order: int = 2, h: int = 4, r: int = 2,
                  levels_after: int = 0) -> int:
    """Multiplicative depth consumed by eval_fbt (the reference's
    GetFBTDepth, ckksrns-fhe.h): CtS (1) + Chebyshev exp series
    (Paterson-Stockmeyer, ~log2(deg)+2) + r squarings + Hermite power
    basis (log2(deg)) + series multiply (1) + StC (1) + levels_after.
    Use as num_levels when building the CKKS context."""
    K = (h + 1) // 2 + 4
    exp_deg = len(_exp_cheb_coeffs(K, r)) - 1
    herm_deg = max(1, {1: p_in - 1, 2: p_in + p_in // 2,
                       3: 2 * p_in - 1}[order])
    cheb_depth = max(1, math.ceil(math.log2(max(2, exp_deg)))) + 2
    pow_depth = max(1, math.ceil(math.log2(max(2, herm_deg))))
    return 1 + cheb_depth + r + pow_depth + 1 + 1 + levels_after


def keygen(ctx: CkksContext, sk: rlwe.SecretKey, precom: FbtPrecom, rng,
           encapsulate_h: int | None = None) -> dict:
    """Same key set as the ordinary bootstrap (EvalBootstrapKeyGen)."""
    from . import bootstrap
    return bootstrap.keygen(ctx, sk, precom, rng,
                            encapsulate_h=encapsulate_h)


# ---------------------------------------------------------------------------
# RLWE multiprecision schemelet (SchemeletRLWEMP, rlwe-mp.cpp)
# ---------------------------------------------------------------------------

# the product's primes: q = 1 mod 2^17 (an NTT of every N up to 2^16), the
# largest below 2^31, as many as a product needs (mul_primes)
_MUL_PRIME_M = 1 << 17


@functools.lru_cache(maxsize=None)
def mul_primes(count: int) -> tuple[int, ...]:
    """The first `count` primes of the exact product, descending."""
    return primes.ntt_primes(count, _MUL_PRIME_M // 2, 1 << 31)


def _max_abs(v: np.ndarray) -> int:
    return max((abs(int(x)) for x in v), default=0)


def _negacyclic_mul(a: np.ndarray, b: np.ndarray, device="cuda") -> np.ndarray:
    """Exact negacyclic product of integer coefficient vectors (object
    dtype, Python ints), fhe_tpu's object-dtype convolution computed by
    NTTs: every coefficient of a*b lies within N max|a| max|b|, so forward
    NTTs of a and b over enough primes (q = 1 mod 2^17, below 2^31) to
    exceed twice that, a pointwise product and an inverse NTT give its
    residues, and the centred CRT gives the integers themselves
    (`rns.negacyclic_product`, shared with math/ntt_arb.py).  On a CUDA
    device the NTTs are kernels 1-2 (one limb-stacked launch each way for
    a and b together; one launch each way a prime below N = 512)."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    N = len(a)
    if len(b) != N or N > _MUL_PRIME_M // 2 or N & (N - 1):
        raise ValueError(f"negacyclic product of lengths {len(a)}, {len(b)}: a power of two "
                         f"up to {_MUL_PRIME_M // 2} each")
    bound = 2 * N * _max_abs(a) * _max_abs(b)
    count = 1
    while rns.modulus_product(mul_primes(count)) <= bound:
        count += 1
    mods = mul_primes(count)
    big = rns.negacyclic_product(a, b, mods, device)
    P = rns.modulus_product(mods)
    half = P // 2
    return np.array([x - P if x > half else x for x in big], dtype=object)


def _uniform_mod(rng: np.random.Generator, q: int, N: int) -> np.ndarray:
    nbytes = (q.bit_length() + 7) // 8 + 8   # 64 bits of rejection margin
    raw = rng.bytes(nbytes * N)
    return np.array([int.from_bytes(raw[i * nbytes:(i + 1) * nbytes],
                                    "little") % q
                     for i in range(N)], dtype=object)


def _round_div(a: int, b: int) -> int:
    """Round-to-nearest a/b for python ints (ties toward +inf)."""
    return (2 * a + b) // (2 * b)


@dataclasses.dataclass
class RlweMpCiphertext:
    """Coefficient-encoded RLWE ciphertext over Z_q[X]/(X^N+1), q a
    power of two; decrypt phase = c0 + c1*s (same convention as rlwe.py).
    delta = scaling factor of the digits (q/PIn at encryption).  c0, c1
    are Python integers on the host (object arrays), as in fhe_tpu."""
    c0: np.ndarray      # object ints mod q
    c1: np.ndarray
    q: int
    delta: float


def _secret(sk: rlwe.SecretKey) -> np.ndarray:
    return np.asarray(sk.s_signed.cpu().numpy(), dtype=object)


def encrypt_coeff(ctx: CkksContext, sk: rlwe.SecretKey, msg, big_q: int,
                  p_in: int, rng: np.random.Generator,
                  std: float = 3.19) -> RlweMpCiphertext:
    """SchemeletRLWEMP::EncryptCoeff: m_t * big_q/p_in + e in the
    coefficients, under the CKKS secret key."""
    N = ctx.params.N
    msg = np.asarray(msg, dtype=np.int64)
    if len(msg) < N:
        msg = np.concatenate([msg, np.zeros(N - len(msg), dtype=np.int64)])
    delta = big_q // p_in
    s = _secret(sk)
    a = _uniform_mod(rng, big_q, N)
    e = np.rint(rng.normal(0.0, std, size=N)).astype(np.int64)
    b = (np.array([int(m) * delta for m in msg], dtype=object)
         + e - _negacyclic_mul(a, s, ctx.device)) % big_q
    return RlweMpCiphertext(c0=b, c1=a, q=big_q, delta=float(delta))


def decrypt_coeff(ctx: CkksContext, sk: rlwe.SecretKey,
                  ct: RlweMpCiphertext, p_out: int) -> np.ndarray:
    """SchemeletRLWEMP::DecryptCoeff: round phase/delta mod p_out."""
    s = _secret(sk)
    ph = (ct.c0 + _negacyclic_mul(ct.c1, s, ctx.device)) % ct.q
    half = ct.q // 2
    out = np.empty(len(ph), dtype=np.int64)
    for i, x in enumerate(ph):
        v = int(x) - ct.q if int(x) > half else int(x)
        out[i] = int(np.rint(v / ct.delta)) % p_out
    return out


def mod_switch(ct: RlweMpCiphertext, new_q: int) -> RlweMpCiphertext:
    """Power-of-two modulus switch (the reference's QBFVInit -> Bigq
    drop, rlwe-mp.cpp ModSwitch)."""
    f = [_round_div(int(x) * new_q, ct.q) % new_q for x in ct.c0]
    g = [_round_div(int(x) * new_q, ct.q) % new_q for x in ct.c1]
    return RlweMpCiphertext(np.array(f, dtype=object),
                            np.array(g, dtype=object), new_q,
                            ct.delta * new_q / ct.q)


def convert_rlwe_to_ckks(ctx: CkksContext, ct: RlweMpCiphertext,
                         num_values: int | None = None) -> Ciphertext:
    """SchemeletRLWEMP::ConvertRLWEToCKKS: modulus switch big_q -> q0
    (the CKKS base block) and re-tag as a CKKS ciphertext whose scale
    label is the digit scaling delta_in = q0/p_in -- or q0/(d*p_in) for
    the sparse pipeline (num_values < N: the partial-sum fold multiplies
    the message by d = N/(2*slots); pre-dividing the conversion keeps the
    exponential argument at m/p_in)."""
    q0 = _q0(ctx)
    base = tuple(ctx.params.moduli[:ctx.cd])
    N = ctx.params.N
    d = 1
    if num_values is not None and num_values < N:
        d = N // max(1, num_values)

    def switch(c):
        out = np.empty(N, dtype=np.int64 if q0 < 2**62 else object)
        half = ct.q // 2
        for i, x in enumerate(c):
            v = int(x) - ct.q if int(x) > half else int(x)
            out[i] = _round_div(v * q0, ct.q * d)
        return rns.to_eval(rlwe.signed_to_rns(
            np.asarray(out, dtype=object), base, device=ctx.device))

    scale = ct.delta * q0 / (ct.q * d)
    return Ciphertext(switch(ct.c0), switch(ct.c1), scale)


def convert_ckks_to_rlwe(ctx: CkksContext, ct: Ciphertext, big_q: int,
                         target_delta: float | None = None
                         ) -> RlweMpCiphertext:
    """SchemeletRLWEMP::ConvertCKKSToRLWE: exact-rational modulus switch
    of both polys from the RNS chain product to the power-of-two big_q.

    target_delta: land the digit scaling near a requested value (e.g.
    big_q/p_out): the ciphertext is first compressed (value-preserving
    LevelReduce) so the base placement scale*big_q/Q sits below the
    target, then an integer pre-multiplier u tops it up (the
    modulus-switch multiplier must be u*big_q/Q for the wrap terms k*Q
    to vanish mod big_q).  Relative placement error <= 1/(2u)."""
    u = 1
    if target_delta is not None:
        # drop limbs while the placement still needs boosting by >= 2^20
        while len(ct.moduli) > ctx.cd:
            Qr = 1
            for q in ct.moduli[:-1]:
                Qr *= q
            if ct.scale * big_q / Qr > target_delta / (1 << 20):
                break
            ct = Ciphertext(rns.level_reduce(ct.c0, 1),
                            rns.level_reduce(ct.c1, 1), ct.scale)
    Q = 1
    for q in ct.moduli:
        Q *= q
    half = Q // 2
    if target_delta is not None:
        u = max(1, round(target_delta * Q / (ct.scale * big_q)))

    def switch(p: rns.RnsPoly):
        big = rns.to_bigint(rns.to_coeff(p))
        out = []
        for x in big:
            v = int(x) - Q if int(x) > half else int(x)
            out.append(_round_div(v * u * big_q, Q) % big_q)
        return np.array(out, dtype=object)

    return RlweMpCiphertext(switch(ct.c0), switch(ct.c1), big_q,
                            ct.scale * u * big_q / Q)


# ---------------------------------------------------------------------------
# power basis (EvalPowers / seriesPowers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SeriesPowers:
    """Precomputed z^j ciphertexts (reference seriesPowers,
    ckksrns-fhe.h): reusable across LUTs (multi-value bootstrapping)."""
    powers_re: dict            # j -> Ciphertext (first branch)
    powers_im: dict | None     # second branch (fully packed only)
    slots: int                 # CKKS slot count of the pipeline


def eval_powers(ctx: CkksContext, z: Ciphertext, deg: int, evk) -> dict:
    """z^1..z^deg by balanced product chains (depth ceil(log2 deg)); with
    float scale labels a flat dict is enough."""
    powers = {1: z}
    for j in range(2, deg + 1):
        a = j // 2
        b = j - a
        powers[j] = mul_aligned(ctx, powers[a], powers[b], evk)
    return powers


def _hermite_eval(ctx: CkksContext, powers: dict, coeffs: np.ndarray,
                  keys: dict) -> Ciphertext:
    """2*Re(sum_j a_j z^j): plaintext-weighted sum over the power basis
    + conjugate-add (the reference's EvalPolyWithPrecomp + Conjugate,
    EvalMVBNoDecoding :3055-3075; a_j are pre-divided by 2)."""
    slots = ctx.params.N // 2
    acc = None
    for jj in range(1, len(coeffs)):
        c = complex(coeffs[jj])
        if abs(c) < 2.0 ** -40:
            continue
        term = ctx.rescale(ctx.mul_plain(powers[jj], np.full(slots, c)))
        acc = term if acc is None else add_aligned(ctx, acc, term)
    if acc is None:
        raise ValueError("constant-only Hermite series")
    c0 = complex(coeffs[0])
    if abs(c0) > 2.0 ** -40:
        acc = ctx.add_plain(acc, np.full(slots, c0))
    return ctx.add(acc, ctx.conjugate(acc, keys["conj"]))


# ---------------------------------------------------------------------------
# FBT pipeline
# ---------------------------------------------------------------------------

def _exp_stage(ctx: CkksContext, x: Ciphertext, precom: FbtPrecom,
               keys: dict) -> Ciphertext:
    """z = exp(2*pi*i*K*x) via Chebyshev series + r squarings (the
    double-angle of the exponential is a plain square)."""
    z = eval_chebyshev_series_ps(ctx, x, precom.exp_coeffs, -1.0, 1.0,
                                 keys["evk"])
    for _ in range(precom.r):
        z = ctx.rescale(ctx.mul(z, z, keys["evk"]))
    return z


def eval_mvb_precompute(ctx: CkksContext, ct: Ciphertext,
                        precom: FbtPrecom, keys: dict,
                        deg: int) -> SeriesPowers:
    """EvalMVBPrecompute: raise -> CoeffsToSlots -> complex exponential
    -> power basis z^1..z^deg.  Everything downstream of this is
    plaintext-weighted sums, so multiple LUTs reuse it."""
    N = ctx.params.N
    n = N // 2
    s = precom.slots

    raised = _raise(ctx, ct, keys)

    if s == n:
        # ---- fully packed: CtS + conjugate split into two real branches
        M1 = precom.E_lo.conj().T / (N * precom.K)
        enc = bsgs_linear_transform(ctx, raised, M1, keys["rot"],
                                    precom.bsgs_g)
        enc_re, enc_im = _conjugate_split(ctx, enc, keys)
        z_re = _exp_stage(ctx, enc_re, precom, keys)
        z_im = _exp_stage(ctx, enc_im, precom, keys)
        return SeriesPowers(eval_powers(ctx, z_re, deg, keys["evk"]),
                            eval_powers(ctx, z_im, deg, keys["evk"]), s)

    # ---- sparsely packed: partial sum + vertical rect CtS, one branch
    d = n // s
    j = 1
    while j < d:
        raised = ctx.add(raised, ctx.rotate(raised, j * s, keys["rot"]))
        j <<= 1
    E = precom.E_lo
    V = np.vstack([E.conj().T, -1j * E.conj().T]) / (s * 2 * precom.K)
    enc = bsgs_rect_transform(ctx, raised, V, keys["rot"], precom.bsgs_g)
    enc = ctx.add(enc, ctx.conjugate(enc, keys["conj"]))
    z = _exp_stage(ctx, enc, precom, keys)
    return SeriesPowers(eval_powers(ctx, z, deg, keys["evk"]), None, s)


def eval_mvb_no_decoding(ctx: CkksContext, sp: SeriesPowers,
                         coeffs: np.ndarray, precom: FbtPrecom,
                         keys: dict) -> Ciphertext:
    """EvalMVBNoDecoding: Hermite series on the precomputed powers; the
    fully packed case recombines the two coefficient halves as re + i*im
    (monomial X^{N/2})."""
    N = ctx.params.N
    out = _hermite_eval(ctx, sp.powers_re, coeffs, keys)
    if sp.powers_im is not None:
        im = _hermite_eval(ctx, sp.powers_im, coeffs, keys)
        im = Ciphertext(rns.mul_monomial(im.c0, N // 2),
                        rns.mul_monomial(im.c1, N // 2), im.scale)
        out = add_aligned(ctx, out, im)
    return out


def eval_hom_decoding(ctx: CkksContext, ct: Ciphertext, precom: FbtPrecom,
                      keys: dict, post_scale: float = 1.0) -> Ciphertext:
    """EvalHomDecoding: SlotsToCoeffs (+ sparse rotate-fold); post_scale
    (the Hermite scale_thi) is restored by scale relabel instead of the
    reference's physical MultByInteger."""
    n = ctx.params.N // 2
    s = precom.slots
    if s == n:
        out = bsgs_linear_transform(ctx, ct, precom.E_lo, keys["rot"],
                                    precom.bsgs_g)
    else:
        H = np.hstack([precom.E_lo, 1j * precom.E_lo])
        out = bsgs_rect_transform(ctx, ct, H, keys["rot"], precom.bsgs_g)
        out = ctx.add(out, ctx.rotate(out, s, keys["rot"]))
    return Ciphertext(out.c0, out.c1, out.scale / post_scale)


def eval_fbt(ctx: CkksContext, ct: Ciphertext, coeffs: np.ndarray,
             precom: FbtPrecom, keys: dict,
             post_scale: float = 1.0) -> Ciphertext:
    """EvalFBT = precompute + series + decoding: returns a CKKS
    ciphertext whose COEFFICIENTS encode f(m_t) at scale ct_out.scale.
    Convert back with convert_ckks_to_rlwe for the exact RLWE result."""
    sp = eval_mvb_precompute(ctx, ct, precom, keys, len(coeffs) - 1)
    enc = eval_mvb_no_decoding(ctx, sp, coeffs, precom, keys)
    return eval_hom_decoding(ctx, enc, precom, keys, post_scale)


def eval_fbt_no_decoding(ctx: CkksContext, ct: Ciphertext,
                         coeffs: np.ndarray, precom: FbtPrecom,
                         keys: dict) -> Ciphertext:
    """EvalFBTNoDecoding: stop before SlotsToCoeffs so leveled CKKS
    computation can run on the slot values; finish with
    eval_hom_decoding."""
    sp = eval_mvb_precompute(ctx, ct, precom, keys, len(coeffs) - 1)
    return eval_mvb_no_decoding(ctx, sp, coeffs, precom, keys)


def eval_hermite_trig_series(ctx: CkksContext, ct: Ciphertext,
                             cheb_coeffs, a: float, b: float,
                             herm_coeffs, keys: dict,
                             r: int = 0) -> Ciphertext:
    """EvalHermiteTrigSeries (ckksrns-fhe.cpp:3189): Chebyshev series of
    the complex exponential on the slot values (+ optional r squarings),
    then the Hermite power series with real-part extraction -- the
    mid-pipeline of eval_fbt exposed for direct slot-domain use."""
    z = eval_chebyshev_series_ps(ctx, ct, cheb_coeffs, a, b, keys["evk"])
    for _ in range(r):
        z = ctx.rescale(ctx.mul(z, z, keys["evk"]))
    powers = eval_powers(ctx, z, len(herm_coeffs) - 1, keys["evk"])
    return _hermite_eval(ctx, powers, np.asarray(herm_coeffs), keys)


# ---------------------------------------------------------------------------
# multiprecision sign (digit-decomposition FBT chain)
# ---------------------------------------------------------------------------

def eval_sign_multiprecision(ctx: CkksContext, ct: RlweMpCiphertext,
                             p_in: int, p_digit: int, big_q: int,
                             precom: FbtPrecom, keys: dict,
                             order: int = 2, scale_thi: float = 1.0
                             ) -> RlweMpCiphertext:
    """Sign (msb) of digits in Z_{p_in} too large for one LUT, via
    homomorphic digit decomposition (MultiPrecisionSign,
    functional-bootstrapping-ckks.cpp:483-720): repeatedly extract the
    low digit mod big_q, clean it with an x-mod-p_digit FBT, subtract,
    divide by p_digit (exact power-of-two modulus switch); the final
    digit is mapped through the step LUT x >= p_digit/2.

    Requires log2(p_digit) | log2(p_in) and ct.q/p_in == big_q/p_digit.
    Returns an RLWE ciphertext of the sign bit with delta = q_out/2."""
    Q = ct.q
    db = p_digit.bit_length() - 1
    if Q // p_in != big_q // p_digit:
        raise ValueError("need Q/p_in == big_q/p_digit")
    func_mod = lambda x: x % p_digit
    func_step = lambda x: 1 if (x % p_in) >= p_digit // 2 else 0
    coeffs_mod = get_hermite_trig_coefficients(func_mod, p_digit, order,
                                               scale_thi)
    coeffs_step = get_hermite_trig_coefficients(func_step, p_digit, order,
                                                1.0)
    p_cur = p_in
    coeffs, post = coeffs_mod, scale_thi
    step = False
    go = Q > big_q
    while go:
        dig = RlweMpCiphertext(ct.c0 % big_q, ct.c1 % big_q, big_q,
                               float(big_q // p_digit))
        cin = convert_rlwe_to_ckks(ctx, dig)
        out = eval_fbt(ctx, cin, coeffs, precom, keys, post_scale=post)
        if not step:
            # place the cleaned digit at its position Q/p_cur and subtract
            polys = convert_ckks_to_rlwe(ctx, out, Q,
                                         target_delta=Q / p_cur)
            c0 = (ct.c0 - polys.c0) % Q
            c1 = (ct.c1 - polys.c1) % Q
            # exact power-of-two modulus switch Q -> Q >> db
            Qn = Q >> db
            ct = mod_switch(RlweMpCiphertext(c0, c1, Q, Q / p_cur), Qn)
            Q >>= db
            p_cur >>= db
            ct = RlweMpCiphertext(ct.c0, ct.c1, Q, float(Q // p_cur))
            go = Q > big_q
            if p_digit > 2 and not go:
                coeffs, post = coeffs_step, 1.0
                step = True
                go = True
        else:
            return convert_ckks_to_rlwe(ctx, out, Q, target_delta=Q / 2)
    # p_digit == 2: the last mod-2 digit IS the sign bit
    dig = RlweMpCiphertext(ct.c0 % big_q, ct.c1 % big_q, big_q,
                           float(big_q // p_digit))
    cin = convert_rlwe_to_ckks(ctx, dig)
    out = eval_fbt(ctx, cin, coeffs_mod, precom, keys, post_scale=scale_thi)
    return convert_ckks_to_rlwe(ctx, out, big_q, target_delta=big_q / 2)
