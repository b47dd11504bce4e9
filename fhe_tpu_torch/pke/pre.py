"""Proxy re-encryption (PRE): re-encrypt ciphertexts from Alice's key to
Bob's without decryption.  Port of fhe_tpu/pke/pre.py.

Reference semantics: the reference's base-pre.cpp / rns-pre.cpp (ReKeyGen
= a switching key from sOld to sNew drawn with the NEW party's randomness;
ReEncrypt = a key switch of c1, with optional re-randomization for HRA
security).  Multi-hop works by chaining.

Built on the key switch of `rlwe` (HYBRID, or BV with method="bv"): on a
CUDA device its NTTs are the limb-stacked kernels 1-2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import rns
from . import rlwe


def re_key_gen(params, sk_old: rlwe.SecretKey, sk_new: rlwe.SecretKey,
               rng: np.random.Generator, method: str = "hybrid", digit_bits: int = 0):
    """Re-encryption key sOld -> sNew (base-pre.cpp ReKeyGen): an EvalKey
    (HYBRID), or with method="bv" the digit-decomposition BvEvalKey the
    reference pairs with PRE for low-depth configs (keyswitch-bv.cpp,
    relinWindow = digit_bits).  BGV's noise is scaled by t."""
    ns = params.plain_mod if params.scheme == "BGV" else 1
    s_old = sk_old.eval_poly(tuple(params.moduli))
    if method == "bv":
        return rlwe.bv_evk_gen(params, s_old, sk_new, rng, digit_bits=digit_bits,
                               noise_scale=ns)
    return rlwe.evk_gen(params, s_old, sk_new, rng, noise_scale=ns)


def re_encrypt(params, rk, c0: rns.RnsPoly, c1: rns.RnsPoly,
               rng: np.random.Generator | None = None,
               pk_new: rlwe.PublicKey | None = None):
    """Switch (c0, c1) under sOld to a ciphertext under sNew (base-pre.cpp
    ReEncrypt).  With pk_new and rng, adds an encryption of zero under
    pk_new for HRA-secure re-randomization (rns-pre.cpp)."""
    d0, d1 = rlwe.key_switch(params, rk, c1)
    out0, out1 = rns.add(c0, d0), d1
    if pk_new is not None and rng is not None:
        ns = params.plain_mod if params.scheme == "BGV" else 1
        zero = rns.RnsPoly(torch.zeros_like(out0.data), out0.moduli, out0.fmt)
        z0, z1 = rlwe.encrypt_pk(params, pk_new, zero, rng, noise_scale=ns)
        out0, out1 = rns.add(out0, z0), rns.add(out1, z1)
    return out0, out1
