"""CKKS bootstrapping: raise to the full modulus chain, CoeffsToSlots,
approximate modular reduction by a Chebyshev sine series with double-angle
iterations, SlotsToCoeffs.  Port of fhe_tpu/pke/bootstrap.py.

Reference pipeline: the reference's ckksrns-fhe.cpp -- EvalBootstrapSetup
(:85), EvalBootstrapKeyGen (:246), EvalBootstrap (:401; CoeffsToSlots
:632, Chebyshev :658, double-angle :671 / ApplyDoubleAngleIterations
:2070, SlotsToCoeffs :699).

As in fhe_tpu:

* Scales are exact float64 bookkeeping on the ciphertext, so every
  constant (1/(N*K), q0/scale ratios) folds into the CoeffsToSlots /
  SlotsToCoeffs matrices and a final scale relabel -- no extra ciphertext
  multiplications (the reference's correction factor).

* Both linear transforms use the half embedding E_lo[j,k] =
  exp(i*pi*(2*t_j+1)*k/N) (k < N/2, t_j the 5^j-orbit slot exponents, all
  even, so X^{N/2} is an exact slot-wise *i): CoeffsToSlots is
  E_lo^H/(N*K) and SlotsToCoeffs E_lo, each one BSGS diagonal pass, or,
  with a level budget above 1, the special FFT's butterfly stages
  collapsed into `budget` diagonal-sparse BSGS passes.

* The sine's Chebyshev coefficients are fitted at setup to a requested
  tolerance (the reference ships fixed tables, ckksrns-fhe.h:405-477).

The precomputation (setup, the diagonals, the sine fit) is numpy on the
host, fhe_tpu's copied; the evaluation is the port's CKKS ops on the
ciphertexts' device (on a CUDA device every NTT is the limb-stacked
kernels 1-2), issuing fhe_tpu's ops in fhe_tpu's order, so a seed gives
the same ciphertexts byte for byte.  Each plaintext diagonal is encoded
on the host when it is multiplied (`_mul_plain_raw`), as in fhe_tpu.
One difference: with a level budget above 1, setup leaves
`BootstrapPrecom.E_lo` None (fhe_tpu builds the dense [N/2, N/2] matrix
there, 16 GiB at N = 2^16, and nothing on that path reads it).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from ..lattice import rns
from . import rlwe
from .advanced import add_aligned, adjust_to, eval_chebyshev_series_ps
from .ckks import Ciphertext, CkksContext, _embedding_tables, encode


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BootstrapPrecom:
    slots: int               # N/2 (fully packed) or s < N/2 (sparse)
    K: int                   # sine range: |v| <= K*q0
    r: int                   # double-angle iterations
    cheb_coeffs: list        # Chebyshev coeffs of the scaled cosine
    E_lo: np.ndarray | None  # [n, n] (full) / [s, s] small embedding (sparse);
    #                          None with a level budget above 1
    rot_indices: list        # rotation keys needed (BSGS baby+giant)
    bsgs_g: int              # baby-step count
    cts_levels: list | None = None   # level-budget>1: CoeffsToSlots diag
    #                                  dicts (application order)
    stc_levels: list | None = None   # SlotsToCoeffs diag dicts


def _sine_cheb_coeffs(K: int, r: int, tol: float = 1e-9,
                      max_deg: int = 512) -> list[float]:
    """Chebyshev-interpolation coefficients (T_k basis on [-1,1]) of
    f(y) = (1/2pi)^(1/2^r) * cos((2*pi*K*y - pi/2)/2^r); after r
    double-angle iterations this becomes (1/2pi)*sin(2*pi*K*y)."""
    amp = (1.0 / (2.0 * np.pi)) ** (1.0 / 2 ** r)

    def f(y):
        return amp * np.cos((2.0 * np.pi * K * y - np.pi / 2) / 2 ** r)

    grid = np.linspace(-1, 1, 4001)
    deg = 8
    while deg <= max_deg:
        # interpolation at Chebyshev nodes: exact DCT-based coefficients
        j = np.arange(deg + 1)
        nodes = np.cos(np.pi * (j + 0.5) / (deg + 1))
        fv = f(nodes)
        coeffs = [2.0 / (deg + 1) * np.sum(fv * np.cos(k * np.arccos(nodes)))
                  for k in range(deg + 1)]
        coeffs[0] /= 2
        approx = np.polynomial.chebyshev.chebval(grid, coeffs)
        if np.max(np.abs(approx - f(grid))) < tol:
            return [float(c) for c in coeffs]
        deg += max(8, deg // 4)
    raise ValueError("sine Chebyshev fit did not converge")


def _bsgs_rotations(n: int) -> tuple[int, list[int]]:
    g = max(1, int(math.isqrt(n)))
    b = -(-n // g)
    rots = sorted(set(list(range(1, g)) + [j * g for j in range(1, b)]))
    return g, rots


@functools.lru_cache(maxsize=None)
def _E_lo(N: int) -> np.ndarray:
    """E_lo[j,k] = exp(i*pi*(2*t_j+1)*k/N), j,k < N/2.  Satisfies
    E_lo^H E_lo = (N/2) I and E[:, k+N/2] = i*E[:, k] (t_j even)."""
    t, _, _ = _embedding_tables(N)
    n = N // 2
    j = t[:n].astype(np.float64)
    k = np.arange(n, dtype=np.float64)
    return np.exp(1j * np.pi * np.outer(2 * j + 1, k) / N)


# ---------------------------------------------------------------------------
# Level-budget > 1: collapsed special-FFT factorization
# (EvalBootstrapSetup levelBudget, ckksrns-fhe.cpp:147-148 /
# ckksrns-utils.cpp CoeffEncoding/DecodingOneLevel :434-516 +
# Coeff*Collapse :518-698).  The half embedding E_lo[j,k] = ksi^{g_j k}
# (ksi of order 4n, g_j = 5^j mod 4n) factors into log2(n) radix-2
# butterfly stages, each a THREE-diagonal matrix at offsets {0, +-m/2};
# consecutive stages are composed symbolically into `budget` grouped
# matrices, each applied with one diagonal-sparse BSGS transform
# (one level consumed per group instead of one level for the dense n-
# diagonal matrix).  The DIT bit-reversal is never materialized: the
# encode direction is the hermitian-transposed stage sequence, so
# StC(sine(CtS(x))) sees the permutation cancel exactly.
# ---------------------------------------------------------------------------

def _diag_add(d: dict, o: int, v: np.ndarray) -> None:
    o = o % len(v)
    d[o] = d.get(o, 0) + v


@functools.lru_cache(maxsize=None)
def _decode_stages(n: int) -> tuple:
    """Radix-2 DIT butterfly stages of the special FFT: applying them in
    order to a bit-reversed coefficient vector yields E_lo @ x.  Stage for
    block size m: out[i+j] = in[i+j] + w_j*in[i+j+h], out[i+j+h] =
    in[i+j] - w_j*in[i+j+h], with h = m/2 and twiddle
    w_j = ksi^{(g_j mod 4m) * (4n/4m)} (the sub-transform's own rotGroup
    ordering — verified E_lo-exact for all n)."""
    g = np.zeros(n, dtype=np.int64)
    cur = 1
    for j in range(n):
        g[j] = cur
        cur = (cur * 5) % (4 * n)
    ksi = np.exp(2j * np.pi / (4 * n))
    stages = []
    m = 2
    while m <= n:
        h = m // 2
        lenq = 4 * m
        d0 = np.zeros(n, dtype=complex)
        dp = np.zeros(n, dtype=complex)
        dm = np.zeros(n, dtype=complex)
        w = ksi ** ((g[:h] % lenq) * (4 * n // lenq))
        for i in range(0, n, m):
            d0[i:i + h] = 1.0
            dp[i:i + h] = w
            d0[i + h:i + m] = -w
            dm[i + h:i + m] = 1.0
        d = {}
        _diag_add(d, 0, d0)
        _diag_add(d, h, dp)
        _diag_add(d, -h, dm)
        stages.append(d)
        m <<= 1
    return tuple(stages)


def _herm_diags(d: dict, n: int) -> dict:
    """Hermitian transpose in diagonal form: (M^H)_{-o}[j] =
    conj(diag_o[(j-o) mod n])."""
    out = {}
    for o, v in d.items():
        _diag_add(out, -o, np.conj(np.roll(v, o)))
    return out


def _compose_diags(A: dict, B: dict) -> dict:
    """C = A·B (B applied first): C_{oa+ob} += A_{oa} * roll(B_{ob}, -oa)."""
    out = {}
    for oa, va in A.items():
        for ob, vb in B.items():
            _diag_add(out, oa + ob, va * np.roll(vb, -oa))
    return out


def _collapse(stages: list, budget: int) -> list:
    """Group consecutive stages into `budget` matrices (application
    order preserved).  The remainder goes to the LATER groups: a group of
    k stages costs ~2^k diagonals regardless of position, and the later
    (large-m) groups wrap mod n, merging offsets."""
    L = len(stages)
    budget = min(budget, L)
    base, rem = divmod(L, budget)
    sizes = [base + (1 if i >= budget - rem else 0) for i in range(budget)]
    groups = []
    k = 0
    for sz in sizes:
        g = stages[k]
        for st in stages[k + 1:k + sz]:
            g = _compose_diags(st, g)
        groups.append(g)
        k += sz
    return groups


def _budget_transforms(n: int, budget_enc: int, budget_dec: int,
                       enc_scalar: complex) -> tuple[list, list]:
    """(CoeffsToSlots level list, SlotsToCoeffs level list).

    StC = the decode stages collapsed; CtS = hermitian stages in reverse
    order collapsed, times enc_scalar distributed as a per-level root so
    every level's plaintexts stay O(1) (the reference's scaleEnc
    k-th-root splitting)."""
    stages = list(_decode_stages(n))
    stc = _collapse(stages, budget_dec)
    herm = [_herm_diags(d, n) for d in reversed(stages)]
    cts = _collapse(herm, budget_enc)
    per = enc_scalar ** (1.0 / len(cts))
    cts = [{o: v * per for o, v in lvl.items()} for lvl in cts]
    return cts, stc


def _diag_bsgs(diags: dict, n: int) -> tuple[int, list[int]]:
    """BSGS split of a diagonal set: g ~ sqrt(#diags-spread); returns
    (g, rotation indices needed)."""
    offs = sorted(diags.keys())
    g = max(1, 1 << (max(1, math.isqrt(len(offs))).bit_length()))
    rots = set()
    for o in offs:
        i, j = o % g, o // g
        if i:
            rots.add(i)
        if j:
            rots.add(j * g)
    return g, sorted(rots)


def bsgs_diagonal_transform(ctx: CkksContext, ct: Ciphertext, diags: dict,
                            rot_keys: dict, g: int) -> Ciphertext:
    """Diagonal-sparse BSGS matrix-vector product: like
    bsgs_linear_transform but touching ONLY the present offsets
    (EvalCoeffsToSlots one level, ckksrns-fhe.cpp:1352-1460).  Extended-
    basis accumulation, one KeySwitchDown per live giant step."""
    n = ctx.params.N // 2
    by_giant: dict[int, list] = {}
    for o in diags:
        by_giant.setdefault(o // g, []).append(o % g)
    hoist = ctx.fast_rotation_precompute(ct)
    ext_mods = ct.moduli + tuple(ctx.params.special_mods)
    pt_scale = _mul_plain_scale(ctx, ct)
    babies: dict[int, Ciphertext] = {}
    out = None
    for j in sorted(by_giant):
        inner = None
        for i in sorted(by_giant[j]):
            o = j * g + i
            if i not in babies:
                babies[i] = ctx.fast_rotation_ext(ct, i, rot_keys, hoist)
            term = _mul_plain_raw(ctx, babies[i],
                                  np.roll(diags[o], j * g),
                                  ext_mods, pt_scale)
            inner = term if inner is None else ctx.add(inner, term)
        inner = ctx.key_switch_down(inner)
        if j:
            inner = ctx.rotate(inner, j * g, rot_keys)
        out = inner if out is None else ctx.add(out, inner)
    return ctx.rescale(out)


def setup(ctx: CkksContext, h: int, r: int = 3,
          tol: float = 1e-9, slots: int | None = None,
          level_budget: tuple[int, int] = (1, 1)) -> BootstrapPrecom:
    """EvalBootstrapSetup: build LT matrices + sine approximation for a
    sparse-ternary secret of Hamming weight h.

    slots=s < N/2 precomputes the SPARSELY PACKED pipeline
    (ckksrns-fhe.cpp:703-790): the partial sum multiplies the message by
    d = N/(2s) and folds the q0-overflow integers of d automorphism
    images into each subring coefficient, so the sine range K grows by
    ~sqrt(d) (random-walk heuristic on the folded I coefficients).

    level_budget=(enc, dec): levels to spend on CoeffsToSlots /
    SlotsToCoeffs (EvalBootstrapSetup's levelBudget).  (1,1) applies the
    dense E_lo matrices (n diagonals, cheapest in levels); budgets > 1
    use the collapsed special-FFT factorization — ~budget * 2^(log2(n)/
    budget) plaintext mults instead of n (full packing only); E_lo is then
    None (fhe_tpu builds it; that path never reads it)."""
    N = ctx.params.N
    n = N // 2
    s = slots or n
    if n % s or s > n:
        raise ValueError("slots must be a power-of-two divisor of N/2")
    d = n // s
    K = (h + 1) // 2 + 4            # |c0 + c1*s|/q0 <= (h+1)/2, plus margin
    if d > 1:
        K = int(math.ceil(K * math.sqrt(d)))
    coeffs = _sine_cheb_coeffs(K, r, tol)
    if d == 1 and max(level_budget) > 1:
        cts, stc = _budget_transforms(n, level_budget[0], level_budget[1],
                                      1.0 / (N * K))
        rots: set = set()
        cts_levels, stc_levels = [], []
        for lvl in cts:
            g, rr = _diag_bsgs(lvl, n)
            cts_levels.append((lvl, g))
            rots.update(rr)
        for lvl in stc:
            g, rr = _diag_bsgs(lvl, n)
            stc_levels.append((lvl, g))
            rots.update(rr)
        return BootstrapPrecom(slots=s, K=K, r=r, cheb_coeffs=coeffs,
                               E_lo=None, rot_indices=sorted(rots), bsgs_g=1,
                               cts_levels=cts_levels,
                               stc_levels=stc_levels)
    if d == 1:
        E = _E_lo(N)
        # sanity: sqrt(N/2)-unitarity of the half-embedding
        err = np.abs(E.conj().T @ E - (N / 2) * np.eye(n)).max()
        if not err < 1e-6 * N:
            raise ValueError(f"E_lo not unitary: {err}")
        g, rots = _bsgs_rotations(n)
    else:
        E = _E_lo(2 * s)            # small-ring half embedding [s, s]
        g, rots = _bsgs_rotations(s)
        part = [s << i for i in range((n // s).bit_length() - 1)]
        rots = sorted(set(rots + part + [s]))
    return BootstrapPrecom(slots=s, K=K, r=r, cheb_coeffs=coeffs,
                           E_lo=E, rot_indices=rots, bsgs_g=g)


def keygen(ctx: CkksContext, sk: rlwe.SecretKey, precom: BootstrapPrecom,
           rng: np.random.Generator,
           encapsulate_h: int | None = None) -> dict:
    """EvalBootstrapKeyGen: BSGS rotation keys + conjugation + relin.

    encapsulate_h enables SPARSE_ENCAPSULATED mode (ckksrns-fhe.cpp
    :270-281, :534-557): the main secret stays DENSE (uniform ternary)
    for security; keygen draws a weight-h sparse helper secret and two
    switching keys (the reference reserves automorphism slots M-4/M-2
    for them).  eval_bootstrap switches to the sparse secret just for
    the modulus raise -- bounding the overflow integers by the sparse
    weight, so the sine range K stays small -- then switches back."""
    keys = {
        "rot": ctx.rotation_key_gen(sk, precom.rot_indices, rng),
        "conj": ctx.conj_key_gen(sk, rng),
        "evk": ctx.relin_key_gen(sk, rng),
    }
    if encapsulate_h is not None:
        mods = tuple(ctx.params.moduli)
        sk2 = rlwe.keygen(ctx.params, rng, h=encapsulate_h, device=sk.s_eval_full.device)
        keys["swk_down"] = rlwe.evk_gen(ctx.params, sk.eval_poly(mods),
                                        sk2, rng)       # dense -> sparse
        keys["swk_up"] = rlwe.evk_gen(ctx.params, sk2.eval_poly(mods),
                                      sk, rng)          # sparse -> dense
    return keys


# ---------------------------------------------------------------------------
# BSGS homomorphic linear transform
# ---------------------------------------------------------------------------

def bsgs_linear_transform(ctx: CkksContext, ct: Ciphertext, M: np.ndarray,
                          rot_keys: dict, g: int,
                          tol: float = 0.0) -> Ciphertext:
    """y = M @ slots(ct) by the BSGS diagonal method
    (EvalLinearTransform / EvalCoeffsToSlots with level budget 1):
    y = sum_j rot_{jg}( sum_i rot_{-jg}(diag_{jg+i}) * rot_i(x) ).
    Plaintext diagonals ride mul_plain's level-scale targeting; the
    result is rescaled once and lands on the level target scale.
    Baby rotations share ONE hoisted digit decomposition
    (EvalFastRotationPrecompute -- the reference's hoisting,
    keyswitch-hybrid.cpp EvalKeySwitchPrecomputeCore)."""
    n = M.shape[0]
    b = -(-n // g)
    idx = np.arange(n)
    # cache baby rotations, hoisting the decompose+ModUp of ct once;
    # babies live over the EXTENDED basis QP (EvalFastRotationExt) so the
    # inner sums accumulate WITHOUT per-rotation ModDowns — one
    # KeySwitchDown per giant step (the ckksrns-fhe.cpp CoeffsToSlots
    # EvalMultExt/EvalFastRotationExt pattern)
    hoist = ctx.fast_rotation_precompute(ct) if g > 1 else None
    ext_mods = ct.moduli + tuple(ctx.params.special_mods)
    pt_scale = _mul_plain_scale(ctx, ct)
    babies = {}
    out = None
    for j in range(b):
        inner = None
        for i in range(g):
            d = j * g + i
            if d >= n:
                break
            diag = M[idx, (idx + d) % n]
            if tol and np.max(np.abs(diag)) <= tol:
                continue
            if i not in babies:
                babies[i] = ctx.fast_rotation_ext(ct, i, rot_keys, hoist)
            term = _mul_plain_raw(ctx, babies[i], np.roll(diag, j * g),
                                  ext_mods, pt_scale)
            inner = term if inner is None else ctx.add(inner, term)
        if inner is None:
            continue
        inner = ctx.key_switch_down(inner)
        if j > 0:
            inner = ctx.rotate(inner, j * g, rot_keys)
        out = inner if out is None else ctx.add(out, inner)
    return ctx.rescale(out)


def _mul_plain_scale(ctx: CkksContext, ct: Ciphertext) -> float:
    """The FLEXIBLEAUTO plaintext encode scale mul_plain would pick
    (lands the post-rescale product on the level-target scale)."""
    L = len(ct.moduli)
    if L - ctx.cd >= ctx.cd:
        q_block = 1.0
        for q in ct.moduli[-ctx.cd:]:
            q_block *= float(q)
        return ctx.level_scale(L - ctx.cd) * q_block / ct.scale
    return ctx.scale


def _mul_plain_raw(ctx: CkksContext, ct: Ciphertext, z, mods: tuple,
                   pt_scale: float, slots: int | None = None) -> Ciphertext:
    """mul_plain against a ciphertext over an arbitrary (e.g. extended
    QP) basis: encode at the given scale over `mods` and multiply."""
    m = encode(z, ctx.params.N, pt_scale, slots=slots)
    mp = rns.to_eval(rlwe.signed_to_rns(m, mods, device=ct.c0.data.device))
    return Ciphertext(rns.mul(ct.c0, mp), rns.mul(ct.c1, mp),
                      ct.scale * pt_scale)


def bsgs_rect_transform(ctx: CkksContext, ct: Ciphertext, A: np.ndarray,
                        rot_keys: dict, g: int) -> Ciphertext:
    """Rectangular diagonal-method transform for the sparse bootstrap
    (EvalLinearTransformPrecompute two-matrix variant,
    ckksrns-fhe.cpp:1047-1134).  A is [R, C] with min(R, C) = s diagonals
    of length L = max(R, C); diagonal idx is vec[k] = A[k % R, (k+idx) % C]
    encoded as an L-slot (period-L replicated) plaintext.  On a ciphertext
    whose slot vector is C-periodic this computes, in slot j:
    out_j = sum_idx A[j % R, (j+idx) % C] * x_{(j+idx) % C}
    -- the vertical stack [M; M'] maps s-periodic inputs to 2s-periodic
    outputs (rows split across slot blocks); the horizontal [M | M'] needs
    the caller's final rotate(s)+add to complete each row sum."""
    R, C = A.shape
    L = max(R, C)
    s = min(R, C)
    b = -(-s // g)
    kk = np.arange(L)
    hoist = ctx.fast_rotation_precompute(ct) if g > 1 else None
    ext_mods = ct.moduli + tuple(ctx.params.special_mods)
    pt_scale = _mul_plain_scale(ctx, ct)
    babies = {}
    out = None
    for j in range(b):
        inner = None
        for i in range(g):
            idx = j * g + i
            if idx >= s:
                break
            diag = A[kk % R, (kk + idx) % C]
            if i not in babies:
                babies[i] = ctx.fast_rotation_ext(ct, i, rot_keys, hoist)
            term = _mul_plain_raw(ctx, babies[i], np.roll(diag, j * g),
                                  ext_mods, pt_scale, slots=L)
            inner = term if inner is None else ctx.add(inner, term)
        if inner is None:
            continue
        inner = ctx.key_switch_down(inner)
        if j > 0:
            inner = ctx.rotate(inner, j * g, rot_keys)
        out = inner if out is None else ctx.add(out, inner)
    return ctx.rescale(out)


# ---------------------------------------------------------------------------
# bootstrap pieces
# ---------------------------------------------------------------------------

def _q0(ctx: CkksContext) -> int:
    """Base modulus: product of the first composite_degree limbs."""
    q0 = 1
    for q in ctx.params.moduli[:ctx.cd]:
        q0 *= q
    return q0


def _raise_to_full(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    """Drop to the base block q0 (cd limbs), lift coefficients (centered)
    and re-embed over the full chain (ckksrns-fhe.cpp raising :523: only
    the level-0 tower is used; here the level-0 composite block).

    The centered lift runs on the device as the exact HPS basis switch
    with the [-q0/2, q0/2) representative (`rns.switch_crt_basis_exact`,
    centered=True), as in fhe_tpu."""
    full_mods = tuple(ctx.params.moduli)
    cd = ctx.cd
    q0 = _q0(ctx)
    drop = len(ct.moduli) - cd
    c0 = rns.level_reduce(ct.c0, drop) if drop else ct.c0
    c1 = rns.level_reduce(ct.c1, drop) if drop else ct.c1

    def lift(p: rns.RnsPoly) -> rns.RnsPoly:
        ext = rns.switch_crt_basis_exact(rns.to_coeff(p), full_mods,
                                         centered=True)
        return rns.to_eval(ext)

    # value = w/q0 + I with w = scale*z + e; scale relabel happens at the end
    return Ciphertext(lift(c0), lift(c1), float(q0))


def _raise(ctx: CkksContext, ct: Ciphertext, keys: dict) -> Ciphertext:
    """Modulus raise, with the SPARSE_ENCAPSULATED detour when the keygen
    provided switching keys (ckksrns-fhe.cpp:534-557): switch the base-
    block ciphertext to the sparse helper secret, raise under it (small
    overflow integers), then switch back to the dense secret."""
    if "swk_down" not in keys:
        return _raise_to_full(ctx, ct)
    drop = len(ct.moduli) - ctx.cd
    c0 = rns.level_reduce(ct.c0, drop) if drop else ct.c0
    c1 = rns.level_reduce(ct.c1, drop) if drop else ct.c1
    d0, d1 = rlwe.key_switch(ctx.params, keys["swk_down"], c1)
    low = Ciphertext(rns.add(c0, d0), d1, ct.scale)
    raised = _raise_to_full(ctx, low)
    u0, u1 = rlwe.key_switch(ctx.params, keys["swk_up"], raised.c1)
    return Ciphertext(rns.add(raised.c0, u0), u1, raised.scale)


def _conjugate_split(ctx: CkksContext, enc: Ciphertext, keys: dict
                     ) -> tuple[Ciphertext, Ciphertext]:
    """enc -> (real part * 2, imag part * 2) via conjugation;
    imag extraction multiplies by -i = X^{3N/2} (t_j even)."""
    N = ctx.params.N
    conj = ctx.conjugate(enc, keys["conj"])
    enc_re = ctx.add(enc, conj)
    diff = ctx.sub(enc, conj)
    enc_im = Ciphertext(rns.mul_monomial(diff.c0, 3 * N // 2),
                        rns.mul_monomial(diff.c1, 3 * N // 2), diff.scale)
    return enc_re, enc_im


def _double_angle(ctx: CkksContext, ct: Ciphertext, evk: rlwe.EvalKey,
                  r: int) -> Ciphertext:
    """ApplyDoubleAngleIterations (ckksrns-fhe.cpp:2070):
    y <- 2y^2 - (1/2pi)^(2^(j-r)), turning the scaled cosine into
    (1/2pi) sin."""
    slots = ctx.params.N // 2
    for j in range(1, r + 1):
        sq = ctx.rescale(ctx.mul(ct, ct, evk))
        sq = Ciphertext(rns.mul_scalar(sq.c0, 2), rns.mul_scalar(sq.c1, 2),
                        sq.scale)
        scalar = -((1.0 / (2.0 * np.pi)) ** (2.0 ** (j - r)))
        ct = ctx.add_plain(sq, np.full(slots, scalar))
    return ct


def eval_bootstrap_iterative(ctx: CkksContext, ct: Ciphertext,
                             precom: BootstrapPrecom, keys: dict,
                             precision_bits: int = 10) -> Ciphertext:
    """Two-iteration (META-BTS) bootstrap (ckksrns-fhe.cpp EvalBootstrap
    numIterations=2 path :427-474): bootstrap once, measure the
    bootstrapping error PHYSICALLY amplified by 2^p (integer multiply --
    the reference's MultByIntegerInPlace/AdjustCiphertext machinery),
    bootstrap the error, and subtract.  The amplification must be
    physical: the bootstrap's own error is a fixed fraction of q0, so
    only values made 2^p LARGER relative to q0 see that error shrink
    2^p-fold after the final divide-by-2^p relabel.  (A scale relabel
    alone leaves the torus values unchanged and gains nothing -- found
    empirically: e2 ~= e1 under relabel-only amplification.)"""
    p2 = float(1 << precision_bits)
    b1 = eval_bootstrap(ctx, ct, precom, keys)
    # bring the first bootstrap down to the input basis at the input scale
    b1_low = adjust_to(ctx, b1, ct.moduli, ct.scale)
    # error ciphertext: (b1 - ct) * 2^p (physical integer multiply; the
    # error is tiny, so the amplified values stay far below q0)
    amp = 1 << precision_bits
    err = Ciphertext(rns.mul_scalar(rns.sub(b1_low.c0, ct.c0), amp),
                     rns.mul_scalar(rns.sub(b1_low.c1, ct.c1), amp),
                     ct.scale)
    b2 = eval_bootstrap(ctx, err, precom, keys)
    # subtract the re-scaled error estimate: b2 holds e1*2^p
    b2_scaled = Ciphertext(b2.c0, b2.c1, b2.scale * p2)
    neg = Ciphertext(rns.neg(b2_scaled.c0), rns.neg(b2_scaled.c1),
                     b2_scaled.scale)
    return add_aligned(ctx, b1, neg)


def _eval_bootstrap_sparse(ctx: CkksContext, ct: Ciphertext,
                           precom: BootstrapPrecom, keys: dict
                           ) -> Ciphertext:
    """Sparsely packed bootstrap (ckksrns-fhe.cpp:703-790): partial sum
    folds the raised ciphertext onto the subring (message scaled by d);
    CoeffsToSlots = vertical [E^H; -iE^H] placing ALL 2s subring
    coefficients as real values in 2s slots, so ONE sine branch suffices;
    SlotsToCoeffs = horizontal [E | iE] completed by a rotate(s)+add."""
    N = ctx.params.N
    s = precom.slots
    n = N // 2
    d = n // s
    q0 = float(_q0(ctx))
    delta_in = ct.scale

    raised = _raise(ctx, ct, keys)

    # ---- PartialSum: project onto the subring Z[X^{N/(2s)}]; message
    # coefficients gain a factor d, overflow integers stay integers.
    j = 1
    while j < d:
        raised = ctx.add(raised, ctx.rotate(raised, j * s, keys["rot"]))
        j <<= 1

    E = precom.E_lo                     # [s, s] small-ring half embedding
    # ---- CoeffsToSlots: slot values become c_t/(2K*q0), t < 2s
    V = np.vstack([E.conj().T, -1j * E.conj().T]) / (s * 2 * precom.K)
    enc = bsgs_rect_transform(ctx, raised, V, keys["rot"], precom.bsgs_g)
    # conj-add doubles the real part: values c_t/(K*q0)
    enc = ctx.add(enc, ctx.conjugate(enc, keys["conj"]))

    # ---- single-branch approximate mod reduction
    y = eval_chebyshev_series_ps(ctx, enc, precom.cheb_coeffs,
                                 -1.0, 1.0, keys["evk"])
    y = _double_angle(ctx, y, keys["evk"], precom.r)

    # ---- SlotsToCoeffs + rotate(s)-add to complete the row sums
    H = np.hstack([E, 1j * E])
    out = bsgs_rect_transform(ctx, y, H, keys["rot"], precom.bsgs_g)
    out = ctx.add(out, ctx.rotate(out, s, keys["rot"]))

    # subring coefficients now hold d*delta_in*v/q0 at scale out.scale
    return Ciphertext(out.c0, out.c1, out.scale * d * delta_in / q0)


def eval_bootstrap_jit(ctx: CkksContext, precom: BootstrapPrecom,
                       keys: dict):
    """fhe_tpu's jitted bootstrap entry point: returns ct -> ct, a closure
    that runs eval_bootstrap with these keys.  Nothing is compiled or
    captured (no torch.compile, no CUDA graph): each call issues the
    bootstrap's ops as eval_bootstrap does, and gives its bytes."""
    return lambda ct: eval_bootstrap(ctx, ct, precom, keys)


def eval_bootstrap(ctx: CkksContext, ct: Ciphertext,
                   precom: BootstrapPrecom, keys: dict) -> Ciphertext:
    """EvalBootstrap: returns a ciphertext encrypting the same message
    with the level budget refreshed.  Dispatches to the sparsely packed
    pipeline when precom was set up with slots < N/2."""
    params = ctx.params
    N = params.N
    n = precom.slots
    if n < N // 2:
        return _eval_bootstrap_sparse(ctx, ct, precom, keys)
    cd = ctx.cd
    q0 = float(_q0(ctx))
    delta_in = ct.scale

    raised = _raise(ctx, ct, keys)

    # ---- CoeffsToSlots: M1 = E_lo^H / (N*K); mul_plain's level-scale
    # targeting absorbs the q0-vs-delta mismatch of the raised ciphertext,
    # so the output lands exactly on the level target scale (the reference
    # needs a correction factor here; float bookkeeping does not).
    if precom.cts_levels is not None:
        enc = raised
        for diags, g in precom.cts_levels:
            enc = bsgs_diagonal_transform(ctx, enc, diags, keys["rot"], g)
    else:
        M1 = precom.E_lo.conj().T / (N * precom.K)
        enc = bsgs_linear_transform(ctx, raised, M1, keys["rot"],
                                    precom.bsgs_g)

    enc_re, enc_im = _conjugate_split(ctx, enc, keys)

    # ---- approximate mod reduction on both parts
    def sine(c: Ciphertext) -> Ciphertext:
        c = eval_chebyshev_series_ps(ctx, c, precom.cheb_coeffs,
                                     -1.0, 1.0, keys["evk"])
        return _double_angle(ctx, c, keys["evk"], precom.r)

    s_re = sine(enc_re)
    s_im = sine(enc_im)

    # recombine y = s_re + i*s_im  (i = X^{N/2}); align levels first
    if len(s_re.moduli) != len(s_im.moduli) or \
            abs(s_re.scale - s_im.scale) > 1e-6 * s_re.scale:
        # identical pipelines => identical levels; guard anyway
        s_im = Ciphertext(s_im.c0, s_im.c1, s_re.scale)
    y = add_aligned(ctx, s_re, Ciphertext(
        rns.mul_monomial(s_im.c0, N // 2),
        rns.mul_monomial(s_im.c1, N // 2), s_im.scale))

    # ---- SlotsToCoeffs: M2 = E_lo
    if precom.stc_levels is not None:
        out = y
        for diags, g in precom.stc_levels:
            out = bsgs_diagonal_transform(ctx, out, diags, keys["rot"], g)
    else:
        out = bsgs_linear_transform(ctx, y, precom.E_lo, keys["rot"],
                                    precom.bsgs_g)

    # The slots now hold E*w/q0 where w = delta_in*z + e: relabel the scale
    # so the plaintext value is exactly z again (replaces the reference's
    # correction-factor machinery).  The conjugate-split doubling (enc+conj)
    # contributed *2 on both parts, matched by the 1/2 inside M1's 1/(2K)
    # ... folded as: value after sine = 2 * w/(2*q0) = w/q0.
    return Ciphertext(out.c0, out.c1, out.scale * delta_in / q0)
