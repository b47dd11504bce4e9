"""BGV (RNS): exact integer SIMD arithmetic mod t.  Port of
fhe_tpu/pke/bgv.py.

Reference semantics: the reference's bgvrns scheme and
schemerns/rns-leveledshe.cpp (ModReduceInternal:381, modulus reduction
with a plaintext-preserving correction); packed SIMD slots through the
mod-t NTT (encoding/packedencoding.cpp), t prime with t = 1 mod 2N so the
slots are a negacyclic NTT over Z_t.

A modulus reduction multiplies the plaintext by q_L^-1 mod t; the factor
is tracked on the ciphertext (`pt_scale`) and removed at decryption, as
the reference's FLEXIBLEAUTO BGV scaling does.  Every noise draw (public
key, encryption, switching keys) is scaled by t (`noise_scale = t`, the
reference's GetNoiseScale), and the key switch's ModDown lifts its
correction to a multiple of t (`rlwe`).

Ciphertexts are RnsPoly pairs [..., L, N] on the context's device; every
op is PyTorch int64 ops and, on a CUDA device, the NTT kernels 1-2: the
limb-stacked ones for the ring (`lattice.rns`), the single-modulus ones
with q = t for the slot encoding (`encode` / `decode`, one row).  The
context defaults to the card (`BgvContext.create(..., device="cuda")`);
pass device="cpu" for the plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..lattice import rns
from ..lattice.rns import COEFF, EVAL, RnsPoly
from ..math import ntt as nttmod
from ..math.modmath import sub_mod
from . import encodings as enc
from . import rlwe
from .params import PkeParams, make_bgv_params


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """pt_scale: the mod-t factor gathered from modulus reductions (phase =
    pt_scale m mod t), removed at decryption."""
    c0: RnsPoly
    c1: RnsPoly
    c2: RnsPoly | None = None
    pt_scale: int = 1

    @property
    def moduli(self) -> tuple:
        return self.c0.moduli


def _slot_ntt(values: np.ndarray, t: int, N: int, device, inverse: bool) -> np.ndarray:
    plan = nttmod.make_plan(N, t, device)
    x = torch.from_numpy((np.asarray(values, dtype=np.int64) % t).astype(np.int32)).to(device)
    y = nttmod.ntt_inverse(plan, x) if inverse else nttmod.ntt_forward(plan, x)
    return y.cpu().numpy().astype(np.int64)


def encode(m, t: int, N: int, device="cuda") -> np.ndarray:
    """Packed SIMD slots [<= N] over Z_t -> coefficients [N] (the inverse
    mod-t NTT; short inputs zero-padded)."""
    vals = np.asarray(m, dtype=np.int64) % t
    if vals.shape[-1] < N:
        vals = np.concatenate([vals, np.zeros(N - vals.shape[-1], dtype=np.int64)], -1)
    return _slot_ntt(vals, t, N, device, inverse=True)


def decode(coeffs, t: int, N: int, device="cuda") -> np.ndarray:
    """Coefficients mod t -> packed slots (the forward mod-t NTT)."""
    return _slot_ntt(coeffs, t, N, device, inverse=False)


def plain_coeffs(big, Q: int, t: int, pt_scale: int = 1) -> np.ndarray:
    """BGV decryption of a phase's exact coefficients in [0, Q): each lifted
    to (-Q/2, Q/2], reduced mod t and divided by pt_scale mod t."""
    inv = pow(pt_scale % t, -1, t)
    return np.array([((int(x) if int(x) <= Q // 2 else int(x) - Q) * inv) % t for x in big],
                    dtype=np.int64)


def _mod_reduce_poly(p: RnsPoly, t: int) -> RnsPoly:
    """(p - delta) q_L^-1 over the basis without q_L, COEFF: delta = t [c_L
    t^-1]_{q_L} centered, so delta = c_L mod q_L and delta = 0 mod t."""
    keep, qL = p.moduli[:-1], p.moduli[-1]
    dev = p.data.device
    u = p.data[..., -1:, :].to(torch.int64) * pow(t, -1, qL) % qL
    u = torch.where(u > qL // 2, u - qL, u)                         # centered, [..., 1, N]
    qk = rns.limb_constants(tuple(keep), dev)
    delta = torch.remainder(u, qk) * rns.limb_constants(tuple(t % q for q in keep), dev) % qk
    diff = RnsPoly(sub_mod(p.data[..., :-1, :], delta, qk).to(torch.int32), keep, COEFF)
    return rns.mul_scalar(diff, [pow(qL % q, -1, q) for q in keep])


@dataclasses.dataclass
class BgvContext:
    params: PkeParams
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    @classmethod
    def create(cls, N: int = 1 << 10, num_levels: int = 3, plain_mod: int = 65537,
               mod_bits: int = 28, dnum: int = 2, device="cuda") -> "BgvContext":
        return cls(make_bgv_params(N=N, num_levels=num_levels, plain_mod=plain_mod,
                                   mod_bits=mod_bits, dnum=dnum), torch.device(device))

    @property
    def t(self) -> int:
        return self.params.plain_mod

    # -- keys ---------------------------------------------------------------
    def keygen(self, rng: np.random.Generator):
        sk = rlwe.keygen(self.params, rng, device=self.device)
        return sk, rlwe.pubkey_gen(self.params, sk, rng, noise_scale=self.t)

    def relin_key_gen(self, sk: rlwe.SecretKey, rng, method: str = "hybrid",
                      digit_bits: int = 0):
        """The s^2 -> s key: HYBRID, or BV with method="bv"
        (relinWindow = digit_bits); noise scaled by t."""
        s = sk.eval_poly(tuple(self.params.moduli))
        return rlwe.switch_key_gen(self.params, rns.mul(s, s), sk, rng, method, digit_bits,
                                   noise_scale=self.t)

    def rotation_key_gen(self, sk: rlwe.SecretKey, rots, rng, method: str = "hybrid",
                         digit_bits: int = 0) -> dict:
        """Keys for slot rotations: index r -> galois element 5^r mod 2N."""
        N = self.params.N
        s = sk.eval_poly(tuple(self.params.moduli))
        return {r: rlwe.switch_key_gen(self.params, rns.automorphism(s, pow(5, r % (2 * N), 2 * N)),
                                       sk, rng, method, digit_bits, noise_scale=self.t)
                for r in rots}

    # -- encode/encrypt -----------------------------------------------------
    def make_plaintext(self, m, mods: tuple | None = None, encoding: str = "packed") -> RnsPoly:
        mods = mods or tuple(self.params.moduli)
        coeffs = self._encode(m, encoding)
        return rns.to_eval(rlwe.signed_to_rns(coeffs, mods, device=self.device))

    def _encode(self, m, encoding: str) -> np.ndarray:
        """packed (SIMD slots) / coef / string (encoding/*encoding.h)."""
        if encoding == "packed":
            return encode(m, self.t, self.params.N, self.device)
        if encoding == "coef":
            return enc.encode_coef_packed(m, self.t, self.params.N)
        if encoding == "string":
            return enc.encode_string(m, self.params.N, self.t)
        raise ValueError(f"unknown encoding {encoding!r}")

    def _decode(self, coeffs: np.ndarray, encoding: str):
        if encoding == "packed":
            return decode(coeffs, self.t, self.params.N, self.device)
        if encoding == "coef":
            return enc.decode_coef_packed(coeffs, self.t)
        if encoding == "string":
            return enc.decode_string(coeffs, self.t)
        raise ValueError(f"unknown encoding {encoding!r}")

    def encrypt(self, pk: rlwe.PublicKey, m, rng, encoding: str = "packed") -> Ciphertext:
        pt = self.make_plaintext(m, encoding=encoding)
        c0, c1 = rlwe.encrypt_pk(self.params, pk, pt, rng, noise_scale=self.t)
        return Ciphertext(c0, c1)

    def decrypt(self, sk: rlwe.SecretKey, ct: Ciphertext, encoding: str = "packed"):
        """Decrypt one ciphertext (no batch dimension) and decode."""
        ph = rlwe.decrypt_phase(sk, ct.c0, ct.c1)
        if ct.c2 is not None:
            s = sk.eval_poly(ct.moduli)
            ph = rns.add(ph, rns.to_coeff(rns.mul(rns.mul(ct.c2, s), s)))
        coeffs = plain_coeffs(rns.to_bigint(ph), rns.modulus_product(ct.moduli), self.t,
                              ct.pt_scale)
        return self._decode(coeffs, encoding)

    # -- ops ------------------------------------------------------------------
    def adjust_level(self, a: Ciphertext, num_limbs: int) -> Ciphertext:
        """ModReduce a down to num_limbs limbs (the reference's automatic
        level adjustment, rns-leveledshe.cpp:182-191).  A degree-2
        ciphertext (with c2) is refused: relinearize it first."""
        if len(a.moduli) > num_limbs and a.c2 is not None:
            raise ValueError("adjust_level needs a relinearized (degree-1) ciphertext")
        while len(a.moduli) > num_limbs:
            a = self.mod_reduce(a)
        return a

    def _match(self, a: Ciphertext, b: Ciphertext,
               scales: bool = True) -> tuple[Ciphertext, Ciphertext]:
        """Both operands at the shorter basis; for add/sub also one
        plaintext scale, by an exact scalar multiply of a (the BGV scaling
        adjustment of rns-leveledshe.cpp EvalAdd)."""
        n = min(len(a.moduli), len(b.moduli))
        a, b = self.adjust_level(a, n), self.adjust_level(b, n)
        if scales and a.pt_scale != b.pt_scale:
            if a.c2 is not None or b.c2 is not None:
                raise ValueError("the scale adjustment needs relinearized operands")
            k = b.pt_scale * pow(a.pt_scale, -1, self.t) % self.t
            a = Ciphertext(rns.mul_scalar(a.c0, k), rns.mul_scalar(a.c1, k), pt_scale=b.pt_scale)
        return a, b

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._match(a, b)
        return Ciphertext(rns.add(a.c0, b.c0), rns.add(a.c1, b.c1), pt_scale=a.pt_scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._match(a, b)
        return Ciphertext(rns.sub(a.c0, b.c0), rns.sub(a.c1, b.c1), pt_scale=a.pt_scale)

    def add_plain(self, a: Ciphertext, m) -> Ciphertext:
        m = np.asarray(m, dtype=np.int64)
        if a.pt_scale != 1:
            m = m * a.pt_scale % self.t
        pt = self.make_plaintext(m, a.moduli)
        return Ciphertext(rns.add(a.c0, pt), a.c1, pt_scale=a.pt_scale)

    def mul_plain(self, a: Ciphertext, m) -> Ciphertext:
        pt = self.make_plaintext(m, a.moduli)
        return Ciphertext(rns.mul(a.c0, pt), rns.mul(a.c1, pt), pt_scale=a.pt_scale)

    def mul(self, a: Ciphertext, b: Ciphertext, evk=None) -> Ciphertext:
        """Tensor product at the shorter level; relinearized if evk (HYBRID
        or BV) is given, else keeps c2."""
        a, b = self._match(a, b, scales=False)
        d0 = rns.mul(a.c0, b.c0)
        d1 = rns.add(rns.mul(a.c0, b.c1), rns.mul(a.c1, b.c0))
        d2 = rns.mul(a.c1, b.c1)
        sf = a.pt_scale * b.pt_scale % self.t
        if evk is None:
            return Ciphertext(d0, d1, c2=d2, pt_scale=sf)
        k0, k1 = rlwe.key_switch(self.params, evk, d2)
        return Ciphertext(rns.add(d0, k0), rns.add(d1, k1), pt_scale=sf)

    def square(self, a: Ciphertext, evk=None) -> Ciphertext:
        """EvalSquare (cryptocontext.h:1979)."""
        return self.mul(a, a, evk)

    def rotate(self, a: Ciphertext, r: int, rot_keys: dict) -> Ciphertext:
        N = self.params.N
        k = pow(5, r % (2 * N), 2 * N)
        d0, d1 = rlwe.key_switch(self.params, rot_keys[r], rns.automorphism(a.c1, k))
        return Ciphertext(rns.add(rns.automorphism(a.c0, k), d0), d1, pt_scale=a.pt_scale)

    def mod_reduce(self, a: Ciphertext) -> Ciphertext:
        """Drop the last limb with the plaintext-preserving correction
        (rns-leveledshe.cpp ModReduceInternal): c' = (c - delta) / q_L,
        delta = c mod q_L lifted to a multiple of t; c0 and c1 in one
        inverse and one forward launch."""
        t = self.t
        both = rns.to_eval(_mod_reduce_poly(rns.to_coeff(rns.stack([a.c0, a.c1])), t))
        qL = a.moduli[-1]
        sf = a.pt_scale * pow(qL % t, -1, t) % t
        return Ciphertext(RnsPoly(both.data[0], both.moduli, EVAL),
                          RnsPoly(both.data[1], both.moduli, EVAL), pt_scale=sf)
