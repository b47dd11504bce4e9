"""BFV (RNS): scale-invariant exact integers mod t, HPS or BEHZ
multiplication.  Port of fhe_tpu/pke/bfv.py.

Reference semantics: the reference's bfvrns-leveledshe.cpp (EvalMultCore,
HPS :222-236 and :368-384: ExpandCRTBasis Q -> QR, tensor product,
ScaleAndRound by t/Q into R, SwitchCRTBasis R -> Q; BEHZ :299-321:
FastBaseConvqToBskMontgomery, FastRNSFloorq, FastBaseConvSK) and bfvrns-pke
(Delta = floor(Q/t) encoding).  The auxiliary basis R has len(Q) + 2
limbs, so the tensor product stays below Q R; both basis conversions of
HPS are the exact ones (`modmath.fraction_round_v`'s integer rounding, not
the reference's doubles).

Ciphertexts are RnsPoly pairs [..., L, N] on the context's device.  Each
pass of a product transforms all its ring elements in one launch of the
limb-stacked NTT kernels 1-2 on a CUDA device: HPS inverse-transforms the
four input polynomials over Q, forward-transforms their extension over Q
u R, inverse-transforms the three tensor terms over Q u R and
forward-transforms two of the results over Q (one launch each); the key
switch of `rlwe` takes the third in COEFFICIENT form.  BEHZ likewise over
Q, Bsk and Q u Bsk.  Between them
is PyTorch int64 arithmetic.  The packed slot encoding runs the
single-modulus kernels with q = t (`bgv.encode`).  The context defaults to
the card (`BfvContext.create(..., device="cuda")`); pass device="cpu" for
the plain versions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..lattice import rns
from ..lattice.rns import COEFF, EVAL, RnsPoly
from ..math import primes
from . import bgv, rlwe
from . import encodings as enc
from .params import PkeParams, make_bfv_params


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    c0: RnsPoly
    c1: RnsPoly
    c2: RnsPoly | None = None

    @property
    def moduli(self) -> tuple:
        return self.c0.moduli


@functools.lru_cache(maxsize=None)
def aux_basis(params: PkeParams) -> tuple:
    """R (HPS) and Bsk (BEHZ, m_sk its last limb): len(Q) + 2 primes below
    2^30, = 1 mod 2N, disjoint from Q and P."""
    two_n = 2 * params.N
    avoid = set(params.moduli) | set(params.special_mods)
    out = []
    q = (1 << 30) - 1
    while len(out) < len(params.moduli) + 2:
        p = primes.prev_prime_congruent(q, two_n)
        if p not in avoid:
            out.append(p)
        q = p - 1
    return tuple(out)


def round_t_over_q(big, Q: int, t: int) -> np.ndarray:
    """BFV decryption of a phase's exact coefficients in [0, Q):
    round(t x / Q) mod t in exact integer arithmetic."""
    return np.array([(2 * int(x) * t + Q) // (2 * Q) % t for x in big], dtype=np.int64)


def _cat(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    """a's limbs then b's (disjoint bases, one format)."""
    return RnsPoly(torch.cat([a.data, b.data], dim=-2), a.moduli + b.moduli, a.fmt)


def _limbs(p: RnsPoly, lo: int, hi: int) -> RnsPoly:
    return RnsPoly(p.data[..., lo:hi, :], p.moduli[lo:hi], p.fmt)


def _tensor(x: RnsPoly, same: bool) -> RnsPoly:
    """The tensor product's d0 = a0 b0, d1 = a0 b1 + a1 b0, d2 = a1 b1 of x
    = the stack (a0, a1, b0, b1) (or (a0, a1) where b is a), EVAL, as one
    stack [3, ...]."""
    row = lambda i: RnsPoly(x.data[i], x.moduli, EVAL)
    a0, a1 = row(0), row(1)
    b0, b1 = (a0, a1) if same else (row(2), row(3))
    return rns.stack([rns.mul(a0, b0), rns.add(rns.mul(a0, b1), rns.mul(a1, b0)),
                       rns.mul(a1, b1)])


@dataclasses.dataclass
class BfvContext:
    params: PkeParams
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    @classmethod
    def create(cls, N: int = 1 << 10, num_limbs: int = 3, plain_mod: int = 65537,
               mod_bits: int = 28, dnum: int = 2, device="cuda") -> "BfvContext":
        return cls(make_bfv_params(N=N, num_limbs=num_limbs, plain_mod=plain_mod,
                                   mod_bits=mod_bits, dnum=dnum), torch.device(device))

    @property
    def t(self) -> int:
        return self.params.plain_mod

    @property
    def Q(self) -> int:
        return rns.modulus_product(self.params.moduli)

    # -- keys ---------------------------------------------------------------
    def keygen(self, rng: np.random.Generator):
        sk = rlwe.keygen(self.params, rng, device=self.device)
        return sk, rlwe.pubkey_gen(self.params, sk, rng)

    def relin_key_gen(self, sk: rlwe.SecretKey, rng, method: str = "hybrid",
                      digit_bits: int = 0):
        """The s^2 -> s key: HYBRID, or BV with method="bv"
        (relinWindow = digit_bits)."""
        s = sk.eval_poly(tuple(self.params.moduli))
        return rlwe.switch_key_gen(self.params, rns.mul(s, s), sk, rng, method, digit_bits)

    def rotation_key_gen(self, sk: rlwe.SecretKey, rots, rng, method: str = "hybrid",
                         digit_bits: int = 0) -> dict:
        """Keys for slot rotations: index r -> galois element 5^r mod 2N."""
        N = self.params.N
        s = sk.eval_poly(tuple(self.params.moduli))
        return {r: rlwe.switch_key_gen(self.params, rns.automorphism(s, pow(5, r % (2 * N), 2 * N)),
                                       sk, rng, method, digit_bits) for r in rots}

    # -- encode/encrypt -----------------------------------------------------
    def make_plaintext(self, m, scaled: bool = True, encoding: str = "packed") -> RnsPoly:
        """Delta encode(m) over Q in EVAL (scaled), or encode(m) (for mul_plain)."""
        mods = tuple(self.params.moduli)
        pt = rlwe.signed_to_rns(self._encode(m, encoding), mods, device=self.device)
        if scaled:
            delta = self.Q // self.t
            pt = rns.mul_scalar(pt, [delta % q for q in mods])
        return rns.to_eval(pt)

    def _encode(self, m, encoding: str) -> np.ndarray:
        if encoding == "packed":
            return bgv.encode(m, self.t, self.params.N, self.device)
        if encoding == "coef":
            return enc.encode_coef_packed(m, self.t, self.params.N)
        if encoding == "string":
            return enc.encode_string(m, self.params.N, self.t)
        raise ValueError(f"unknown encoding {encoding!r}")

    def _decode(self, coeffs: np.ndarray, encoding: str):
        if encoding == "packed":
            return bgv.decode(coeffs, self.t, self.params.N, self.device)
        if encoding == "coef":
            return enc.decode_coef_packed(coeffs, self.t)
        if encoding == "string":
            return enc.decode_string(coeffs, self.t)
        raise ValueError(f"unknown encoding {encoding!r}")

    def encrypt(self, pk: rlwe.PublicKey, m, rng, encoding: str = "packed") -> Ciphertext:
        c0, c1 = rlwe.encrypt_pk(self.params, pk, self.make_plaintext(m, encoding=encoding), rng)
        return Ciphertext(c0, c1)

    def decrypt(self, sk: rlwe.SecretKey, ct: Ciphertext, encoding: str = "packed"):
        """Decrypt one ciphertext (no batch dimension) and decode."""
        ph = rlwe.decrypt_phase(sk, ct.c0, ct.c1)
        if ct.c2 is not None:
            s = sk.eval_poly(ct.moduli)
            ph = rns.add(ph, rns.to_coeff(rns.mul(rns.mul(ct.c2, s), s)))
        return self._decode(round_t_over_q(rns.to_bigint(ph), self.Q, self.t), encoding)

    # -- ops --------------------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(rns.add(a.c0, b.c0), rns.add(a.c1, b.c1))

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(rns.sub(a.c0, b.c0), rns.sub(a.c1, b.c1))

    def add_plain(self, a: Ciphertext, m) -> Ciphertext:
        return Ciphertext(rns.add(a.c0, self.make_plaintext(m)), a.c1)

    def mul_plain(self, a: Ciphertext, m) -> Ciphertext:
        pt = self.make_plaintext(m, scaled=False)
        return Ciphertext(rns.mul(a.c0, pt), rns.mul(a.c1, pt))

    def _inputs(self, a: Ciphertext, b: Ciphertext) -> tuple[RnsPoly, bool]:
        """(a0, a1, b0, b1) stacked, or (a0, a1) where b is a; and whether
        b is a."""
        same = a is b
        return rns.stack([a.c0, a.c1] if same else [a.c0, a.c1, b.c0, b.c1]), same

    def _relinearized(self, e: RnsPoly, evk) -> Ciphertext:
        """(e0, e1, e2), COEFF -> the ciphertext, relinearized with evk if
        given.  The key switch takes e2 as it is (it would inverse-transform
        an EVAL input first), so only e0 and e1 are forward-transformed."""
        if evk is None:
            e0, e1, e2 = (RnsPoly(x, e.moduli, EVAL) for x in rns.to_eval(e).data)
            return Ciphertext(e0, e1, c2=e2)
        e01 = rns.to_eval(RnsPoly(e.data[:2], e.moduli, COEFF))
        k0, k1 = rlwe.key_switch(self.params, evk, RnsPoly(e.data[2], e.moduli, COEFF))
        return Ciphertext(rns.add(RnsPoly(e01.data[0], e.moduli, EVAL), k0),
                          rns.add(RnsPoly(e01.data[1], e.moduli, EVAL), k1))

    def mul(self, a: Ciphertext, b: Ciphertext, evk=None, technique: str = "hps") -> Ciphertext:
        """EvalMultCore with the multiplicationTechnique of
        bfvrns-leveledshe.cpp:551-574, relinearized if evk (HYBRID or BV) is
        given:

        - "hps": the exact centered extension Q -> Q u R, the tensor
          product, round(t V / Q) into R, the exact centered switch back
          to Q (the smallest noise);
        - "behz": the Montgomery conversion q -> Bsk with the mtilde
          correction, the tensor product over q u Bsk, FastRNSFloorq,
          then Shenoy-Kumaresan back to q (eprint 2016/510)."""
        if technique == "behz":
            return self._mul_behz(a, b, evk)
        if technique != "hps":
            raise ValueError(f"technique must be 'hps' or 'behz', got {technique!r}")
        q_mods, r_mods = tuple(self.params.moduli), aux_basis(self.params)
        x, same = self._inputs(a, b)
        # ExpandCRTBasis (dcrtpoly-impl.h:1110): the centered integer in
        # [-Q/2, Q/2) in both bases, so the tensor product has no + u Q slack
        xc = rns.to_coeff(x)
        up = rns.to_eval(_cat(xc, rns.switch_crt_basis_exact(xc, r_mods, centered=True)))
        d = rns.to_coeff(_tensor(up, same))
        w_r = rns.scale_and_round_t_over_q(d, q_mods, r_mods, self.t)
        # W = round(t V / Q) is signed: lifted centered back to Q
        return self._relinearized(rns.switch_crt_basis_exact(w_r, q_mods, centered=True), evk)

    def _mul_behz(self, a: Ciphertext, b: Ciphertext, evk=None) -> Ciphertext:
        """BEHZ multiplication (bfvrns-leveledshe.cpp:299-321): Bsk = the
        first L + 1 auxiliary primes and m_sk (the last)."""
        q_mods, bsk = tuple(self.params.moduli), aux_basis(self.params)
        x, same = self._inputs(a, b)
        xk = rns.to_eval(rns.fast_base_conv_q_to_bsk(rns.to_coeff(x), bsk))
        # over q u Bsk: the products limb by limb, one inverse launch
        y = rns.mul_scalar(rns.to_coeff(_tensor(_cat(x, xk), same)), self.t)
        L = len(q_mods)
        fl = rns.fast_rns_floor_q(_limbs(y, 0, L), _limbs(y, L, y.L))
        return self._relinearized(rns.fast_base_conv_sk(fl, q_mods), evk)

    def square(self, a: Ciphertext, evk=None, technique: str = "hps") -> Ciphertext:
        """EvalSquare (cryptocontext.h:1979)."""
        return self.mul(a, a, evk, technique)

    def rotate(self, a: Ciphertext, r: int, rot_keys: dict) -> Ciphertext:
        N = self.params.N
        k = pow(5, r % (2 * N), 2 * N)
        d0, d1 = rlwe.key_switch(self.params, rot_keys[r], rns.automorphism(a.c1, k))
        return Ciphertext(rns.add(rns.automorphism(a.c0, k), d0), d1)

    def dot_product(self, cts: list, plains: list, evk=None) -> Ciphertext:
        """sum_i ct_i * pt_i, an encrypted vector against a plaintext one
        (BASELINE config 4's op); evk is not used (fhe_tpu's signature)."""
        acc = self.mul_plain(cts[0], plains[0])
        for ct, m in zip(cts[1:], plains[1:]):
            acc = self.add(acc, self.mul_plain(ct, m))
        return acc
