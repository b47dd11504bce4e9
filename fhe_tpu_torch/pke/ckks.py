"""CKKS (RNS): canonical-embedding encoding, leveled arithmetic,
rescaling, rotations, conjugation.  Port of fhe_tpu/pke/ckks.py.

Reference semantics: the reference's ckksrns-leveledshe.cpp (rescale =
DropLastElementAndScale :162-183), ckkspackedencoding.cpp (canonical
embedding over the 5^j subgroup), HYBRID key switching (`rlwe`).

Ciphertexts are RnsPoly pairs [..., L, N] on the context's device (any
leading batch dimensions); every leveled op is a pointwise PyTorch op, a
rotation an EVAL permutation and one key switch, and the NTTs under them
kernels 1-2 on a CUDA device (`lattice.rns`).  Encode and decode run on
the host in float64, copied from fhe_tpu (as the reference's
double-precision DFT).  The context defaults to the card
(`CkksContext.create(..., device="cuda")`); pass device="cpu" for the
plain versions.  Relinearization and rotation keys are HYBRID, or BV with
`method="bv"` (`rlwe.bv_evk_gen`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..lattice import rns
from ..lattice.rns import RnsPoly
from . import rlwe
from .params import PkeParams, make_ckks_params


# ---------------------------------------------------------------------------
# canonical embedding (host, float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _embedding_tables(N: int):
    """Slot order: g_j = 5^j mod 2N, j in [0, N/2); t_j = (g_j - 1) / 2."""
    slots = N // 2
    g = np.zeros(slots, dtype=np.int64)
    cur = 1
    for j in range(slots):
        g[j] = cur
        cur = (cur * 5) % (2 * N)
    t = (g - 1) // 2
    t_conj = ((2 * N - g) - 1) // 2
    zeta_pow = np.exp(1j * np.pi * np.arange(N) / N)   # zeta^k
    return t, t_conj, zeta_pow


def encode(z, N: int, scale: float, slots: int | None = None) -> np.ndarray:
    """Complex slots -> integer coefficients [N] (signed int64).

    Default (slots=None): fully packed, N/2 slots, short inputs zero-padded.
    Explicit slots=s < N/2: SPARSE packing (ckkspackedencoding.cpp:115-192 +
    FitToNativeVector gap placement :522-530) -- the message is encoded on
    the subring Z[Y]/(Y^{2s}+1), Y = X^{N/(2s)}: the 2s small-ring
    coefficients land on a stride-N/(2s) grid, and the full-ring slot view
    is the s-slot message replicated N/(2s) times (period s)."""
    s = slots or N // 2
    n2 = 2 * s                           # small-ring dimension
    d = N // n2                          # coefficient stride (gap)
    z = np.asarray(z, dtype=np.complex128)
    if z.shape[-1] < s:
        z = np.concatenate([z, np.zeros(s - z.shape[-1],
                                        dtype=np.complex128)])
    t, t_conj, zeta = _embedding_tables(n2)
    F = np.zeros(n2, dtype=np.complex128)
    F[t] = z
    F[t_conj] = np.conj(z)
    w = np.fft.fft(F) / n2               # inverse of S = n2 * ifft(w)
    v = np.real(w / zeta) * scale        # small-ring real coefficients [2s]
    if d == 1:
        m = v
    else:
        m = np.zeros(N, dtype=np.float64)
        m[::d] = v
    return np.rint(m).astype(np.int64)


def decode(m: np.ndarray, N: int, scale: float, slots: int | None = None,
           sparse: bool = False) -> np.ndarray:
    """Signed coefficients [N] -> complex slots.

    sparse=True with slots=s reads the stride-N/(2s) subring coefficients
    (the reference decode's gap walk, ckkspackedencoding.cpp:341-401);
    sparse=False decodes fully packed and truncates to `slots`."""
    if sparse and slots and slots < N // 2:
        d = N // (2 * slots)
        m = m[::d]                       # [2*slots] small-ring coefficients
        N = 2 * slots
    t, _t_conj, zeta = _embedding_tables(N)
    w = m.astype(np.float64) * zeta
    S = N * np.fft.ifft(w)
    out = S[t] / scale
    return out[:slots] if slots else out


def _center(big, Q: int) -> np.ndarray:
    out = np.empty(len(big), dtype=np.float64)
    half = Q // 2
    for i, x in enumerate(big):
        x = int(x)
        out[i] = float(x - Q) if x > half else float(x)
    return out


def _center_int(big, Q: int) -> list[int]:
    half = Q // 2
    return [int(x) - Q if int(x) > half else int(x) for x in big]


# ---------------------------------------------------------------------------
# ciphertext + context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """CKKS ciphertext: polys in EVAL over the current chain; the scale is
    host bookkeeping (FLEXIBLEAUTO)."""
    c0: RnsPoly
    c1: RnsPoly
    scale: float
    c2: RnsPoly | None = None     # degree-2 component before relinearization
    c_rest: tuple = ()            # degree >= 3 components (EvalMultNoRelin chains)

    def components(self) -> list:
        """All polynomial components [c0, c1, c2, ...]."""
        out = [self.c0, self.c1]
        if self.c2 is not None:
            out.append(self.c2)
        out.extend(self.c_rest)
        return out

    @property
    def moduli(self) -> tuple:
        return self.c0.moduli

    @property
    def level_limbs(self) -> int:
        return len(self.c0.moduli)


@functools.lru_cache(maxsize=None)
def _level_scales(params) -> dict:
    cd = params.composite_degree
    mods = params.moduli
    L = len(mods)
    out = {L: float(1 << params.scale_bits)}
    s = out[L]
    while L - cd >= cd:
        qb = 1.0
        for q in mods[L - cd:L]:
            qb *= float(q)
        s = s * s / qb
        L -= cd
        out[L] = s
    return out


def _check_same(a: Ciphertext, b: Ciphertext) -> None:
    if abs(a.scale - b.scale) >= 1e-6 * a.scale or a.moduli != b.moduli:
        raise ValueError(f"ciphertexts differ in scale ({a.scale}, {b.scale}) or level "
                         f"({len(a.moduli)}, {len(b.moduli)} limbs)")


def _check_level(a: Ciphertext, b: Ciphertext) -> None:
    if a.moduli != b.moduli:
        raise ValueError(f"ciphertexts at different levels ({len(a.moduli)}, "
                         f"{len(b.moduli)} limbs)")


@dataclasses.dataclass
class CkksContext:
    params: PkeParams
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    @classmethod
    def create(cls, N: int = 1 << 12, num_levels: int = 6, scale_bits: int = 28,
               dnum: int = 3, composite_degree: int = 1, first_bits: int | None = None,
               device="cuda") -> "CkksContext":
        fb = first_bits if first_bits is not None else \
            (30 if composite_degree == 1 else 30 * composite_degree)
        return cls(make_ckks_params(N=N, num_levels=num_levels, scale_bits=scale_bits,
                                    dnum=dnum, composite_degree=composite_degree,
                                    first_bits=fb), torch.device(device))

    @property
    def scale(self) -> float:
        return float(1 << self.params.scale_bits)

    @property
    def cd(self) -> int:
        """Limbs dropped per rescale (composite scaling degree)."""
        return self.params.composite_degree

    def level_scale(self, num_limbs: int) -> float:
        """Target scale of ciphertexts with `num_limbs` limbs left
        (FLEXIBLEAUTO: S_{l+1} = S_l^2 / q_block(l))."""
        return _level_scales(self.params)[num_limbs]

    # -- keys ---------------------------------------------------------------
    def keygen(self, rng: np.random.Generator, h: int | None = None):
        """(sk, pk); h: sparse-ternary Hamming weight."""
        sk = rlwe.keygen(self.params, rng, h, device=self.device)
        pk = rlwe.pubkey_gen(self.params, sk, rng)
        return sk, pk

    def relin_key_gen(self, sk: rlwe.SecretKey, rng, method: str = "hybrid",
                      digit_bits: int = 0):
        """The s^2 -> s switching key: HYBRID (keyswitch-hybrid.cpp) or, with
        method="bv", BV (keyswitch-bv.cpp, relinWindow = digit_bits)."""
        s = sk.eval_poly(tuple(self.params.moduli))
        return rlwe.switch_key_gen(self.params, rns.mul(s, s), sk, rng, method, digit_bits)

    def rotation_key_gen(self, sk: rlwe.SecretKey, rots, rng, method: str = "hybrid",
                         digit_bits: int = 0) -> dict:
        """Keys for slot rotations (EvalRotateKeyGen): index r -> galois
        element 5^r mod 2N; HYBRID or BV, as relin_key_gen."""
        N = self.params.N
        s = sk.eval_poly(tuple(self.params.moduli))
        return {r: rlwe.switch_key_gen(self.params, rns.automorphism(s, pow(5, r % (2 * N), 2 * N)),
                                       sk, rng, method, digit_bits) for r in rots}

    def conj_key_gen(self, sk: rlwe.SecretKey, rng) -> rlwe.EvalKey:
        s_k = rns.automorphism(sk.eval_poly(tuple(self.params.moduli)), 2 * self.params.N - 1)
        return rlwe.evk_gen(self.params, s_k, sk, rng)

    def relin_keys_gen(self, sk: rlwe.SecretKey, rng,
                       max_degree: int = 3) -> dict[int, rlwe.EvalKey]:
        """EvalMultKeysGen: switching keys for s^2 .. s^max_degree."""
        s = sk.eval_poly(tuple(self.params.moduli))
        out, s_pow = {}, s
        for d in range(2, max_degree + 1):
            s_pow = rns.mul(s_pow, s)
            out[d] = rlwe.evk_gen(self.params, s_pow, sk, rng)
        return out

    def automorphism_key_gen(self, sk: rlwe.SecretKey, ks, rng) -> dict[int, rlwe.EvalKey]:
        """EvalAutomorphismKeyGen: keys for raw galois elements."""
        s = sk.eval_poly(tuple(self.params.moduli))
        return {k: rlwe.evk_gen(self.params, rns.automorphism(s, k), sk, rng) for k in ks}

    # -- encode/encrypt -----------------------------------------------------
    def make_plaintext(self, z, level_mods: tuple | None = None, scale: float | None = None,
                       slots: int | None = None) -> tuple[RnsPoly, float]:
        mods = level_mods or tuple(self.params.moduli)
        scale = scale or self.scale
        m = encode(z, self.params.N, scale, slots=slots)
        return rns.to_eval(rlwe.signed_to_rns(m, mods, device=self.device)), scale

    def encrypt(self, pk: rlwe.PublicKey, z, rng, slots: int | None = None) -> Ciphertext:
        """slots=s < N/2 encrypts sparsely packed (subring encoding)."""
        m, scale = self.make_plaintext(z, slots=slots)
        c0, c1 = rlwe.encrypt_pk(self.params, pk, m, rng)
        return Ciphertext(c0=c0, c1=c1, scale=scale)

    def decrypt(self, sk: rlwe.SecretKey, ct: Ciphertext, slots: int | None = None,
                sparse: bool = False, flood_rng: np.random.Generator | None = None,
                flood_sd: float = float(1 << 20)) -> np.ndarray:
        """Decrypt one ciphertext (no batch dimension) and decode; with
        flood_rng, Gaussian noise of std flood_sd is added to the phase
        first (NOISE_FLOODING_DECRYPT; the result is then public)."""
        ph = rlwe.decrypt_phase(sk, ct.c0, ct.c1)
        if flood_rng is not None:
            e = np.rint(flood_rng.normal(0.0, flood_sd, size=self.params.N)).astype(np.int64)
            ph = rns.add(ph, rlwe.signed_to_rns(e, ph.moduli, device=ph.data.device))
        comps = ct.components()
        if len(comps) > 2:
            s = sk.eval_poly(ct.moduli)
            s_pow = rns.mul(s, s)
            for c in comps[2:]:
                ph = rns.add(ph, rns.to_coeff(rns.mul(c, s_pow)))
                s_pow = rns.mul(s_pow, s)
        m = _center(rns.to_bigint(ph), rns.modulus_product(ct.moduli))
        return decode(m, self.params.N, ct.scale, slots, sparse=sparse)

    # -- leveled ops ----------------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        _check_same(a, b)
        return Ciphertext(rns.add(a.c0, b.c0), rns.add(a.c1, b.c1), a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        _check_same(a, b)
        return Ciphertext(rns.sub(a.c0, b.c0), rns.sub(a.c1, b.c1), a.scale)

    def add_plain(self, a: Ciphertext, z, slots: int | None = None) -> Ciphertext:
        m, _ = self.make_plaintext(z, a.moduli, a.scale, slots=slots)
        return Ciphertext(rns.add(a.c0, m), a.c1, a.scale)

    def mul_plain(self, a: Ciphertext, z, slots: int | None = None) -> Ciphertext:
        """Plaintext multiply, encoded at the scale that lands the caller's
        rescale exactly on the level's target scale."""
        L = len(a.moduli)
        if L - self.cd >= self.cd:
            q_block = 1.0
            for q in a.moduli[-self.cd:]:
                q_block *= float(q)
            pt_scale = self.level_scale(L - self.cd) * q_block / a.scale
        else:
            pt_scale = self.scale
        m, sc = self.make_plaintext(z, a.moduli, pt_scale, slots=slots)
        return Ciphertext(rns.mul(a.c0, m), rns.mul(a.c1, m), a.scale * sc)

    def mul(self, a: Ciphertext, b: Ciphertext, evk=None) -> Ciphertext:
        """Tensor product; relinearizes if evk is given, else keeps c2."""
        _check_level(a, b)
        d0 = rns.mul(a.c0, b.c0)
        d1 = rns.add(rns.mul(a.c0, b.c1), rns.mul(a.c1, b.c0))
        d2 = rns.mul(a.c1, b.c1)
        scale = a.scale * b.scale
        if evk is None:
            return Ciphertext(d0, d1, scale, c2=d2)
        k0, k1 = rlwe.key_switch(self.params, evk, d2)
        return Ciphertext(rns.add(d0, k0), rns.add(d1, k1), scale)

    def square(self, a: Ciphertext, evk) -> Ciphertext:
        return self.mul(a, a, evk)

    def mul_rescale(self, a: Ciphertext, b: Ciphertext, evk) -> Ciphertext:
        """Fused EvalMult + relinearize + rescale: the tensor product's d0, d1
        ride the key switch's extended-basis sums (scaled by P) and one
        EVAL-domain basis change divides by P times the last composite
        block; byte-equal to `relinearize` then `rescale`.  evk: an EvalKey
        or a PreparedEvalKey."""
        _check_level(a, b)
        if a.c1 is b.c1 and a.c0 is b.c0:
            d0 = rns.mul(a.c0, a.c0)
            cross = rns.mul(a.c0, a.c1)
            d1 = rns.add(cross, cross)
            d2 = rns.mul(a.c1, a.c1)
        else:
            d0 = rns.mul(a.c0, b.c0)
            d1 = rns.add(rns.mul(a.c0, b.c1), rns.mul(a.c1, b.c0))
            d2 = rns.mul(a.c1, b.c1)
        scale = a.scale * b.scale
        k0, k1 = rlwe.key_switch_core(self.params, evk, d2, extra=(d0, d1), drop_q=self.cd)
        for qd in a.moduli[len(a.moduli) - self.cd:]:
            scale /= qd
        return Ciphertext(k0, k1, scale)

    def mul_no_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """EvalMultNoRelin for any input degrees: the full component
        convolution (degree da + db); no key switch."""
        _check_level(a, b)
        ca, cb = a.components(), b.components()
        out = [None] * (len(ca) + len(cb) - 1)
        for i, x in enumerate(ca):
            for j, y in enumerate(cb):
                t = rns.mul(x, y)
                out[i + j] = t if out[i + j] is None else rns.add(out[i + j], t)
        return Ciphertext(out[0], out[1], a.scale * b.scale,
                          c2=out[2] if len(out) > 2 else None, c_rest=tuple(out[3:]))

    def relinearize(self, a: Ciphertext, evks) -> Ciphertext:
        """Key-switch every component of degree >= 2 onto (c0, c1) with the
        s^d keys of relin_keys_gen (a bare key serves degree 2)."""
        comps = a.components()
        if len(comps) <= 2:
            return a
        if not isinstance(evks, dict):
            evks = {2: evks}
        d0, d1 = comps[0], comps[1]
        for d, c in enumerate(comps[2:], start=2):
            k0, k1 = rlwe.key_switch(self.params, evks[d], c)
            d0 = rns.add(d0, k0)
            d1 = rns.add(d1, k1)
        return Ciphertext(d0, d1, a.scale)

    def mul_and_relinearize(self, a: Ciphertext, b: Ciphertext, evks) -> Ciphertext:
        """EvalMultAndRelinearize: tensor product of any-degree inputs, then
        full relinearization back to degree 1."""
        return self.relinearize(self.mul_no_relin(a, b), evks)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """ModReduce: drop the last composite_degree limbs and divide the
        scale by their product (ckksrns-leveledshe.cpp:162-183)."""
        c0, c1 = rns.to_coeff(a.c0), rns.to_coeff(a.c1)
        scale = a.scale
        for _ in range(self.cd):
            q_last = c0.moduli[-1]
            c0 = rns.drop_last_element_and_scale(c0)
            c1 = rns.drop_last_element_and_scale(c1)
            scale /= q_last
        return Ciphertext(rns.to_eval(c0), rns.to_eval(c1), scale)

    def automorphism(self, a: Ciphertext, k: int, evk) -> Ciphertext:
        """EvalAutomorphism: X -> X^k and its key switch (rotate and
        conjugate are the 5^r and 2N - 1 cases)."""
        c0 = rns.automorphism(a.c0, k)
        c1 = rns.automorphism(a.c1, k)
        d0, d1 = rlwe.key_switch(self.params, evk, c1)
        return Ciphertext(rns.add(c0, d0), d1, a.scale)

    def rotate(self, a: Ciphertext, r: int, rot_keys: dict) -> Ciphertext:
        """EvalRotate: slot rotation by r (automorphism 5^r + key switch)."""
        N = self.params.N
        return self.automorphism(a, pow(5, r % (2 * N), 2 * N), rot_keys[r])

    def conjugate(self, a: Ciphertext, conj_key) -> Ciphertext:
        return self.automorphism(a, 2 * self.params.N - 1, conj_key)

    def fast_rotation_precompute(self, a: Ciphertext) -> RnsPoly:
        """EvalFastRotationPrecompute: the digit split and ModUp of c1,
        once, as EVAL digits [..., dnum, M, N]; every fast_rotation of this
        ciphertext reuses it."""
        return rlwe.key_switch_precompute(self.params, a.c1)

    def fast_rotation(self, a: Ciphertext, r: int, rot_keys: dict, precomp: RnsPoly) -> Ciphertext:
        """EvalFastRotation: the automorphism applied to the hoisted EVAL
        digits, then only the inner products and the ModDown per index."""
        if r == 0:
            return a
        N = self.params.N
        k = pow(5, r % (2 * N), 2 * N)
        digs = rns.automorphism(precomp, k)
        d0, d1 = rlwe.key_switch_apply(self.params, rot_keys[r], digs)
        return Ciphertext(rns.add(rns.automorphism(a.c0, k), d0), d1, a.scale)

    def key_switch_ext(self, a: Ciphertext, add_first: bool = True) -> Ciphertext:
        """KeySwitchExt: P ct over Q_l + P, to be added to
        fast_rotation_ext sums; add_first=False extends only c1."""
        c1 = rlwe.key_switch_ext_poly(self.params, a.c1)
        if add_first:
            c0 = rlwe.key_switch_ext_poly(self.params, a.c0)
        else:
            c0 = RnsPoly(torch.zeros_like(c1.data), c1.moduli, c1.fmt)
        return Ciphertext(c0, c1, a.scale)

    def key_switch_down(self, a: Ciphertext) -> Ciphertext:
        """KeySwitchDown: ModDown an extended (Q_l + P) ciphertext to Q_l."""
        return Ciphertext(rlwe.key_switch_down_poly(self.params, a.c0),
                          rlwe.key_switch_down_poly(self.params, a.c1), a.scale)

    def fast_rotation_ext(self, a: Ciphertext, r: int, rot_keys: dict, precomp: RnsPoly,
                          add_first: bool = True) -> Ciphertext:
        """EvalFastRotationExt: fast_rotation without the ModDown, over
        Q_l + P with a factor P; a sum of them pays one key_switch_down.
        add_first: include P sigma_k(c0) in the extended c0."""
        if r == 0:
            return self.key_switch_ext(a, add_first)
        N = self.params.N
        k = pow(5, r % (2 * N), 2 * N)
        digs = rns.automorphism(precomp, k)
        d0, d1 = rlwe.key_switch_inner(self.params, rot_keys[r], digs)
        if add_first:
            d0 = rns.add(d0, rlwe.key_switch_ext_poly(self.params, rns.automorphism(a.c0, k)))
        return Ciphertext(d0, d1, a.scale)

