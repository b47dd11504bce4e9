"""Carry fhe_tpu state into the port.

The functions take the arrays of fhe_tpu's objects as numpy arrays (for
example `np.asarray(key.bsk)`), so this package never imports jax: the
TFHE keys and ciphertexts, the RLWE keys (`rlwe_secret_key`,
`rlwe_public_key`, `eval_key`, `prepared_eval_key`, `bv_eval_key`, and
CKKS bootstrapping's key dict, `bootstrap_keys`) and the
CKKS, BGV and BFV ciphertexts (`ckks_ciphertext`, `bgv_ciphertext`,
`bfv_ciphertext`), and the multiparty state a seed cannot rebuild: a
party's partial decryption (`partial_decryption`) and interactive-
bootstrap shares (`int_boot_shares`); joint keys are `eval_key` /
`rlwe_public_key` of their arrays.  Functional bootstrapping's schemelet
ciphertext (`rlwe_mp_ciphertext`, Python integers on the host in both
packages) and setup (`fbt_precom`, numpy in both), and scheme switching's
keys (`ckks_to_fhew_key`, `fhew_to_ckks_key`).  An RLWE trapdoor
(`trapdoor`: its public row, (r, e) and parameters) and a threshold key
share (`key_share`).
Residues are uint32 below 2^31 in fhe_tpu and int32 here; the secret key
is small signed integers in both.  The tensors go to the first CUDA card
unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice.rns import EVAL, RnsPoly
from .lattice.trapdoor import RlweTrapdoorPair, TrapdoorOutput, TrapdoorParams
from .pke import rlwe
from .pke.bfv import Ciphertext as BfvCiphertext
from .pke.bgv import Ciphertext as BgvCiphertext
from .pke.ckks import Ciphertext as CkksCiphertext
from .pke.fbt import FbtPrecom, RlweMpCiphertext
from .pke.multiparty import IntBootShares, PartialDecryption
from .pke.schemeswitch import CkksToFhewKey, FhewToCkksKey
from .tfhe.acc import DmKey, LmkcdeyKey
from .tfhe.lwe import LweCiphertext, LwePublicKey, LweSecretKey, LweSwitchingKey
from .tfhe.radix import RadixInt, RadixParams
from .tfhe.rgsw import BootstrapKey
from .tfhe.rgsw_rns import RnsKey
from .tfhe.shortint import ShortIntParams
from .tfhe.threshold import KeyShare


def _residues(x, name: str, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.kind not in "iu":
        raise TypeError(f"{name} must hold integers, got {x.dtype}")
    if x.size and (x.min() < 0 or x.max() >= 2**31):
        raise ValueError(f"{name} holds values outside [0, 2^31)")
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32)).to(device)


def secret_key(s, device="cuda") -> LweSecretKey:
    """fhe_tpu LweSecretKey.s (signed int32) -> LweSecretKey."""
    s = np.asarray(s)
    if s.dtype.kind != "i":
        raise TypeError(f"secret key must be signed integers, got {s.dtype}")
    return LweSecretKey(s=torch.from_numpy(s.astype(np.int32)).to(device))


def ciphertext(a, b, modulus: int, pt_mod: int = 4, device="cuda") -> LweCiphertext:
    """fhe_tpu LweCiphertext (a, b, modulus, pt_mod) -> LweCiphertext."""
    return LweCiphertext(a=_residues(a, "a", device), b=_residues(b, "b", device),
                         modulus=int(modulus), pt_mod=int(pt_mod))


def radix_int(a, b, modulus: int, pt_mod: int, message_bits: int, carry_bits: int,
              num_limbs: int, max_limb: int, device="cuda") -> RadixInt:
    """fhe_tpu RadixInt (ct.a [..., L, n], ct.b [..., L], ct.modulus,
    ct.pt_mod; rp.limb.message_bits, rp.limb.carry_bits, rp.num_limbs;
    max_limb) -> RadixInt."""
    rp = RadixParams(ShortIntParams(int(message_bits), int(carry_bits)), int(num_limbs))
    ct = ciphertext(a, b, modulus, pt_mod, device)
    if ct.a.ndim < 2 or ct.a.shape[-2] != rp.num_limbs or ct.b.shape[-1] != rp.num_limbs:
        raise ValueError(f"a radix ciphertext of {rp.num_limbs} limbs is a [..., "
                         f"{rp.num_limbs}, n], b [..., {rp.num_limbs}]; got a "
                         f"{tuple(ct.a.shape)}, b {tuple(ct.b.shape)}")
    return RadixInt(ct=ct, rp=rp, max_limb=int(max_limb))


def public_key(A, v, modulus: int, device="cuda") -> LwePublicKey:
    """fhe_tpu LwePublicKey (A, v, modulus) -> LwePublicKey."""
    return LwePublicKey(A=_residues(A, "A", device), v=_residues(v, "v", device),
                        modulus=int(modulus))


def bootstrap_key(bsk, ksk_a, ksk_b, device="cuda") -> BootstrapKey:
    """fhe_tpu BootstrapKey (bsk, ksk.a, ksk.b) -> BootstrapKey.  The
    fhe_tpu Shoup dual `bsk_shoup` is not carried: the port has none."""
    return BootstrapKey(bsk=_residues(bsk, "bsk", device), ksk=_ksk(ksk_a, ksk_b, device))


def rns_bootstrap_key(bsk, ksk_a, ksk_b, device="cuda") -> RnsKey:
    """fhe_tpu's RNS BootstrapKey (bsk [n, 2, dG2, 2, L, N], Montgomery
    residues per limb; ksk.a, ksk.b) -> RnsKey."""
    bsk = np.asarray(bsk)
    if bsk.ndim != 6:
        raise ValueError(f"an RNS bootstrap key is [n, 2, dG2, 2, L, N], got {bsk.shape}")
    return RnsKey(bsk=_residues(bsk, "bsk", device), ksk=_ksk(ksk_a, ksk_b, device))


def dm_key(bsk, ksk_a, ksk_b, device="cuda") -> DmKey:
    """fhe_tpu acc.DmKey (bsk, ksk.a, ksk.b) -> DmKey."""
    return DmKey(bsk=_residues(bsk, "bsk", device), ksk=_ksk(ksk_a, ksk_b, device))


def lmkcdey_key(rgsw, auto, ksk_a, ksk_b, device="cuda") -> LmkcdeyKey:
    """fhe_tpu acc.LmkcdeyKey (rgsw, auto, ksk.a, ksk.b) -> LmkcdeyKey."""
    return LmkcdeyKey(rgsw=_residues(rgsw, "rgsw", device), auto=_residues(auto, "auto", device),
                      ksk=_ksk(ksk_a, ksk_b, device))


def _ksk(ksk_a, ksk_b, device) -> LweSwitchingKey:
    return LweSwitchingKey(a=_residues(ksk_a, "ksk.a", device),
                           b=_residues(ksk_b, "ksk.b", device))


# ---------------------------------------------------------------------------
# RLWE schemes (fhe_tpu/pke): ring data is [..., L, N] uint32 residues, EVAL
# ---------------------------------------------------------------------------

def rlwe_secret_key(s_signed, s_eval_full, moduli_full, device="cuda") -> rlwe.SecretKey:
    """fhe_tpu rlwe.SecretKey (s_signed, s_eval_full, moduli_full) -> SecretKey."""
    s = np.asarray(s_signed)
    if s.dtype.kind != "i":
        raise TypeError(f"secret key must be signed integers, got {s.dtype}")
    return rlwe.SecretKey(s_signed=torch.from_numpy(s.astype(np.int32)).to(device),
                          s_eval_full=_limbs(s_eval_full, moduli_full, "s_eval_full", device),
                          moduli_full=tuple(int(q) for q in moduli_full))


def rlwe_public_key(b, a, moduli, device="cuda") -> rlwe.PublicKey:
    """fhe_tpu rlwe.PublicKey (b.data, a.data, b.moduli) -> PublicKey."""
    return rlwe.PublicKey(b=_poly(b, moduli, "b", device), a=_poly(a, moduli, "a", device))


def eval_key(b, a, moduli_qp, num_per_part: int, device="cuda") -> rlwe.EvalKey:
    """fhe_tpu rlwe.EvalKey (b, a [dnum, L_qp, N], moduli_qp, num_per_part)
    -> EvalKey."""
    return rlwe.EvalKey(b=_limbs(b, moduli_qp, "b", device), a=_limbs(a, moduli_qp, "a", device),
                        moduli_qp=tuple(int(q) for q in moduli_qp),
                        num_per_part=int(num_per_part))


def bootstrap_keys(keys: dict, device="cuda") -> dict:
    """fhe_tpu bootstrap.keygen's dict -> the port's: "rot" ({r: EvalKey}),
    "conj", "evk" and, for SPARSE_ENCAPSULATED, "swk_down" / "swk_up".
    Each value is fhe_tpu's EvalKey (or, under "rot", a dict of them),
    read by duck typing: its b and a arrays (np.asarray), moduli_qp and
    num_per_part, through `eval_key`."""
    def one(k) -> rlwe.EvalKey:
        return eval_key(np.asarray(k.b), np.asarray(k.a), k.moduli_qp, k.num_per_part, device)
    unknown = set(keys) - {"rot", "conj", "evk", "swk_down", "swk_up"}
    if unknown or not {"rot", "conj", "evk"} <= set(keys):
        raise ValueError(f"a bootstrap key dict holds rot, conj, evk and optionally swk_down "
                         f"and swk_up; got {sorted(keys)}")
    out = {"rot": {int(r): one(k) for r, k in keys["rot"].items()}}
    out.update({name: one(keys[name]) for name in keys if name != "rot"})
    return out


def prepared_eval_key(b_mont, a_mont, moduli_qp, num_per_part: int,
                      device="cuda") -> rlwe.PreparedEvalKey:
    """fhe_tpu rlwe.PreparedEvalKey (b_mont, a_mont: Montgomery form,
    x 2^32 mod q) -> the port's PreparedEvalKey, out of Montgomery form."""
    rinv = np.array([pow(1 << 32, -1, int(q)) for q in moduli_qp], dtype=object)[:, None]
    plain = lambda x: (np.asarray(x).astype(object) * rinv % np.array(
        [int(q) for q in moduli_qp], dtype=object)[:, None]).astype(np.int64)
    evk = eval_key(plain(b_mont), plain(a_mont), moduli_qp, num_per_part, device)
    return rlwe.prepare_evk(None, evk)


def ckks_ciphertext(c0, c1, moduli, scale: float, c2=None, c_rest=(),
                    device="cuda") -> CkksCiphertext:
    """fhe_tpu ckks.Ciphertext (c0.data, c1.data, c0.moduli, scale, and
    c2.data, [c.data for c in c_rest] where present) -> Ciphertext."""
    poly = lambda x, name: _poly(x, moduli, name, device)
    return CkksCiphertext(c0=poly(c0, "c0"), c1=poly(c1, "c1"), scale=float(scale),
                          c2=None if c2 is None else poly(c2, "c2"),
                          c_rest=tuple(poly(c, "c_rest") for c in c_rest))


def bv_eval_key(b, a, moduli, digit_bits: int, rows_per_limb, device="cuda") -> rlwe.BvEvalKey:
    """fhe_tpu rlwe.BvEvalKey (b, a [n_rows, L, N], moduli, digit_bits,
    rows_per_limb) -> BvEvalKey."""
    rows = tuple(int(r) for r in rows_per_limb)
    if len(rows) != len(moduli) or np.asarray(b).shape[0] != sum(rows):
        raise ValueError(f"a BV key over {len(moduli)} limbs has one row count a limb and "
                         f"their sum of rows; got {rows} and b {np.asarray(b).shape}")
    return rlwe.BvEvalKey(b=_limbs(b, moduli, "b", device), a=_limbs(a, moduli, "a", device),
                          moduli=tuple(int(q) for q in moduli), digit_bits=int(digit_bits),
                          rows_per_limb=rows)


def bgv_ciphertext(c0, c1, moduli, pt_scale: int = 1, c2=None, device="cuda") -> BgvCiphertext:
    """fhe_tpu bgv.Ciphertext (c0.data, c1.data, c0.moduli, pt_scale, and
    c2.data where present) -> Ciphertext."""
    poly = lambda x, name: _poly(x, moduli, name, device)
    return BgvCiphertext(c0=poly(c0, "c0"), c1=poly(c1, "c1"),
                         c2=None if c2 is None else poly(c2, "c2"), pt_scale=int(pt_scale))


def bfv_ciphertext(c0, c1, moduli, c2=None, device="cuda") -> BfvCiphertext:
    """fhe_tpu bfv.Ciphertext (c0.data, c1.data, c0.moduli, and c2.data
    where present) -> Ciphertext."""
    poly = lambda x, name: _poly(x, moduli, name, device)
    return BfvCiphertext(c0=poly(c0, "c0"), c1=poly(c1, "c1"),
                         c2=None if c2 is None else poly(c2, "c2"))


def partial_decryption(share, moduli, is_lead: bool, device="cuda") -> PartialDecryption:
    """fhe_tpu multiparty.PartialDecryption (share.data, share.moduli,
    is_lead) -> PartialDecryption."""
    return PartialDecryption(share=_poly(share, moduli, "share", device), is_lead=bool(is_lead))


def int_boot_shares(h0, h0_moduli, h1, h1_moduli, n_parties: int,
                    device="cuda") -> IntBootShares:
    """fhe_tpu multiparty.IntBootShares (h0.data over Qc, h1.data over Q,
    their moduli, n_parties) -> IntBootShares."""
    return IntBootShares(h0=_poly(h0, h0_moduli, "h0", device),
                         h1=_poly(h1, h1_moduli, "h1", device), n_parties=int(n_parties))


def _limbs(x, moduli, name: str, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.ndim < 2 or x.shape[-2] != len(moduli):
        raise ValueError(f"{name} must be [..., {len(moduli)}, N] residues, got {x.shape}")
    if (x.astype(np.int64) >= np.array(moduli, dtype=np.int64)[:, None]).any():
        raise ValueError(f"{name} holds a residue not below its limb's modulus")
    return _residues(x, name, device)


def _poly(x, moduli, name: str, device) -> RnsPoly:
    return RnsPoly(_limbs(x, moduli, name, device), tuple(int(q) for q in moduli), EVAL)


# ---------------------------------------------------------------------------
# functional bootstrapping and scheme switching (fhe_tpu/pke/fbt.py,
# schemeswitch.py)
# ---------------------------------------------------------------------------

def rlwe_mp_ciphertext(c0, c1, q: int, delta: float) -> RlweMpCiphertext:
    """fhe_tpu fbt.RlweMpCiphertext (c0, c1 object arrays of Python ints, q,
    delta) -> RlweMpCiphertext (the same host integers, copied)."""
    ints = lambda x: np.array([int(v) for v in np.asarray(x, dtype=object)], dtype=object)
    return RlweMpCiphertext(c0=ints(c0), c1=ints(c1), q=int(q), delta=float(delta))


def fbt_precom(slots: int, K: int, r: int, exp_coeffs, E_lo, rot_indices, bsgs_g: int
               ) -> FbtPrecom:
    """fhe_tpu fbt.FbtPrecom's fields -> FbtPrecom (host numpy in both)."""
    return FbtPrecom(slots=int(slots), K=int(K), r=int(r),
                     exp_coeffs=[complex(c) for c in exp_coeffs],
                     E_lo=np.array(E_lo, dtype=np.complex128),
                     rot_indices=[int(i) for i in rot_indices], bsgs_g=int(bsgs_g))


def ckks_to_fhew_key(rot_keys: dict, ksk_a, ksk_b, bsgs_g: int, slots: int,
                     scale_cf: float = 1.0, device="cuda") -> CkksToFhewKey:
    """fhe_tpu schemeswitch.CkksToFhewKey -> CkksToFhewKey: rot_keys maps a
    rotation to the port's EvalKey (`eval_key` of fhe_tpu's arrays);
    ksk_a, ksk_b are the LWE switching key's arrays, or None (no key)."""
    ksk = None if ksk_a is None else _ksk(ksk_a, ksk_b, device)
    return CkksToFhewKey(rot_keys=dict(rot_keys), ksk=ksk, bsgs_g=int(bsgs_g),
                         slots=int(slots), scale_cf=float(scale_cf))


def fhew_to_ckks_key(enc_c0, enc_c1, moduli, scale: float, rot_keys: dict, bsgs_g: int,
                     device="cuda") -> FhewToCkksKey:
    """fhe_tpu schemeswitch.FhewToCkksKey -> FhewToCkksKey: the CKKS
    encryption of the FHEW secret (enc_sk's c0.data, c1.data, moduli,
    scale) and the rotation keys as for ckks_to_fhew_key."""
    return FhewToCkksKey(enc_sk=ckks_ciphertext(enc_c0, enc_c1, moduli, scale, device=device),
                         rot_keys=dict(rot_keys), bsgs_g=int(bsgs_g))


def _ints(x, name: str, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.kind not in "iu":
        raise TypeError(f"{name} must hold integers, got {x.dtype}")
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)).to(device)


def trapdoor(a_row, r, e, N: int, q: int, base: int = 2, sigma: float = 3.19,
             device="cuda") -> TrapdoorOutput:
    """fhe_tpu TrapdoorOutput (a_row [k+2, N] mod q; pair.r, pair.e [k, N]
    signed; params N, q, base, sigma) -> TrapdoorOutput."""
    params = TrapdoorParams(N=int(N), q=int(q), base=int(base), sigma=float(sigma))
    a_row, r, e = (_ints(x, name, device) for x, name in ((a_row, "a_row"), (r, "r"), (e, "e")))
    k = params.k
    if tuple(a_row.shape) != (k + 2, params.N) or tuple(r.shape) != (k, params.N) or \
            tuple(e.shape) != (k, params.N):
        raise ValueError(f"a trapdoor at N = {params.N}, k = {k} has a_row [{k + 2}, {params.N}] "
                         f"and r, e [{k}, {params.N}]; got {tuple(a_row.shape)}, "
                         f"{tuple(r.shape)}, {tuple(e.shape)}")
    return TrapdoorOutput(a_row=a_row, pair=RlweTrapdoorPair(r=r, e=e), params=params)


def key_share(party_id: int, share, commitment: bytes, device="cuda") -> KeyShare:
    """fhe_tpu KeyShare (party_id, share [dim] uint64 mod q, commitment) -> KeyShare."""
    return KeyShare(int(party_id), _residues(share, "share", device).to(torch.int64),
                    bytes(commitment))
