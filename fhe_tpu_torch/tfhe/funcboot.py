"""Functional bootstrapping: EvalFunc / EvalFloor / EvalSign / EvalDecomp.

Port of fhe_tpu/tfhe/funcboot.py (reference: binfhe-base-scheme.cpp
EvalFunc with the negacyclic / periodic / arbitrary LUT trichotomy,
EvalFloor, EvalSign, EvalDecomp and BootstrapFunc(Core), per eprint
2021/1337; beta = 128).  The LUTs stay host numpy; the ciphertexts are
int32 tensors on the key's device.

A functional bootstrap blind-rotates by the mask mod the ciphertext's own
modulus ct_mod (q, 2q, a rounding modulus beta 2^(rb+1), or below q at
the end of EvalSign's ladder), a power of two dividing 2N: the test vector
holds a value every 2N/ct_mod coefficients and the GINX rotation
(`boot.run_accumulator`, kernel 3, 4 or 5 by `ntt_impl` on the card) runs
with `a_modulus=ct_mod`.  Only a GINX `rgsw.BootstrapKey` on a single-limb
ring is taken, as fhe_tpu's bootstrap_core takes nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import blind_rotate as kbr
from ..math.modmath import add_mod, sub_mod
from . import boot, lwe, rgsw
from .params import TfheParams

BETA = 128


def _check_key(params: TfheParams, key) -> None:
    """ValueError unless key is a GINX BootstrapKey of a single-limb set."""
    if params.moduli_rns or not isinstance(key, rgsw.BootstrapKey):
        raise ValueError(f"functional bootstrapping takes a GINX BootstrapKey on a single-limb "
                         f"ring, as fhe_tpu's bootstrap_core does; got {type(key).__name__} "
                         f"on {params.name}")


def _ct(ct: lwe.LweCiphertext, a: torch.Tensor, b: torch.Tensor, q: int) -> lwe.LweCiphertext:
    return lwe.LweCiphertext(a=a.to(torch.int32), b=b.to(torch.int32), modulus=q,
                             pt_mod=ct.pt_mod)


# -- LWE helper ops (lwe-pke.cpp) ---------------------------------------------

def add_const(ct: lwe.LweCiphertext, c: int) -> lwe.LweCiphertext:
    q = ct.modulus
    return _ct(ct, ct.a, add_mod(ct.b, c % q, q), q)


def sub_const(ct: lwe.LweCiphertext, c: int) -> lwe.LweCiphertext:
    q = ct.modulus
    return _ct(ct, ct.a, sub_mod(ct.b, c % q, q), q)


def sub(ct1: lwe.LweCiphertext, ct2: lwe.LweCiphertext) -> lwe.LweCiphertext:
    q = ct1.modulus
    if ct2.modulus != q:
        raise ValueError(f"sub of ciphertexts mod {q} and mod {ct2.modulus}")
    return _ct(ct1, sub_mod(ct1.a, ct2.a, q), sub_mod(ct1.b, ct2.b, q), q)


def set_modulus(ct: lwe.LweCiphertext, q_new: int) -> lwe.LweCiphertext:
    """Reduce the components into a smaller power-of-two modulus dividing
    the current one (lwe-ciphertext.h SetModulus), or reinterpret them
    under a larger one."""
    if q_new >= ct.modulus:
        return _ct(ct, ct.a, ct.b, q_new)
    if ct.modulus % q_new or q_new & (q_new - 1):
        raise ValueError(f"set_modulus {ct.modulus} -> {q_new}: the new modulus must be a "
                         f"power of two dividing the old")
    return _ct(ct, ct.a & (q_new - 1), ct.b & (q_new - 1), q_new)


# -- the functional bootstrap -------------------------------------------------

def bootstrap_func(params: TfheParams, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
                   f_table: np.ndarray, f_mod: int,
                   ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """BootstrapFunc: the LUT f_table over Z_{ct.modulus} (values in
    [0, f_mod)) -> a ciphertext mod f_mod, dimension n."""
    _check_key(params, key)
    ct_mod = ct.modulus
    kbr.check_q_lwe(params, ct_mod)
    lead = ct.batch_shape
    a = ct.a.reshape(-1, params.n).contiguous()
    b = ct.b.reshape(-1)
    tv = boot.make_func_test_vector(params, b, f_table, f_mod, ct_mod)
    acc = boot.run_accumulator(params, key, tv, a, ntt_impl, a_modulus=ct_mod)
    ext = boot.extract_lwe(params, acc, 0, ct.pt_mod)
    ext = lwe.LweCiphertext(a=ext.a.reshape(*lead, params.N), b=ext.b.reshape(lead),
                            modulus=params.Q, pt_mod=ct.pt_mod)
    ct_ks = lwe.key_switch(params, key.ksk, lwe.mod_switch(ext, params.q_ks))
    return lwe.mod_switch(ct_ks, f_mod)


def _lut_property(lut: np.ndarray, q: int) -> int:
    """0 = negacyclic, 1 = periodic, 2 = arbitrary (binfhe-base-scheme.h)."""
    mid = len(lut) // 2
    if lut[0] == (q - lut[mid]) % q and np.all(lut[1:mid] == (q - lut[mid + 1:]) % q):
        return 0
    if lut[0] == lut[mid] and np.all(lut[1:mid] == lut[mid + 1:]):
        return 1
    return 2


def _f0_table(q: int, f_mod: int) -> np.ndarray:
    """f0(x) = f_mod - q/4 for x < q/2, else q/4 (the half-range shifter)."""
    x = np.arange(q, dtype=np.uint64)
    return np.where(x < q // 2, f_mod - q // 4, q // 4).astype(np.uint32)


def eval_func(params: TfheParams, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
              lut: np.ndarray, beta: int = BETA,
              ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """EvalFunc: the LUT over Z_q (q = ct.modulus, q entries) -> a
    ciphertext mod q.  Negacyclic: one bootstrap; periodic and arbitrary:
    two (arbitrary at 2q, which must not exceed N)."""
    _check_key(params, key)
    q = ct.modulus
    lut = np.asarray(lut, dtype=np.uint64)
    if lut.shape != (q,):
        raise ValueError(f"a LUT over Z_{q} needs {q} entries, got shape {lut.shape}")
    prop = _lut_property(lut, q)

    if prop == 0:
        return bootstrap_func(params, key, add_const(ct, beta), lut, q, ntt_impl)

    if prop == 1:
        ct2 = bootstrap_func(params, key, add_const(ct, beta), _f0_table(q, q), q, ntt_impl)
        ct2 = sub_const(add_const(sub(ct, ct2), beta), q >> 2)
        x = np.arange(q, dtype=np.uint64)
        lut1 = np.where(x < q // 2, lut[x % (q // 2)], (q - lut[(x - q // 2) % (q // 2)]) % q)
        return bootstrap_func(params, key, ct2, lut1.astype(np.uint32), q, ntt_impl)

    if q > params.N:
        raise ValueError("arbitrary-function LUT requires ct modulus <= N")
    dq = q << 1
    lut2 = np.concatenate([lut, lut])
    ct1 = set_modulus(ct, dq)
    ct3 = bootstrap_func(params, key, add_const(ct1, beta), _f0_table(dq, dq), dq, ntt_impl)
    ct3 = sub_const(add_const(sub(ct1, ct3), beta), q >> 1)
    x = np.arange(dq, dtype=np.uint64)
    lutf = np.where(x < dq // 2, lut2[x % q], (dq - lut2[(x - dq // 2) % q]) % dq)
    ct4 = bootstrap_func(params, key, ct3, lutf.astype(np.uint32), dq, ntt_impl)
    return set_modulus(ct4, q)


def eval_floor(params: TfheParams, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
               beta: int = BETA, roundbits: int = 0,
               ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """EvalFloor: clear the low log2(q) bits of a ciphertext mod a larger
    modulus (q = beta 2^(roundbits+1) with roundbits); two bootstraps."""
    _check_key(params, key)
    q = params.q if roundbits == 0 else beta * (1 << (roundbits + 1))
    mod = ct.modulus
    ct1 = add_const(ct, beta)
    ct2 = bootstrap_func(params, key, set_modulus(ct1, q), _f0_table(q, mod), mod, ntt_impl)
    ct1 = sub(ct1, ct2)
    x = np.arange(q, dtype=np.uint64)
    f2 = np.where(x < q // 4, (mod - q // 2 - x) % mod,
                  np.where(x < 3 * (q // 4), x, (mod + q // 2 - x) % mod))
    ct3 = bootstrap_func(params, key, set_modulus(ct1, q), f2.astype(np.uint32), mod, ntt_impl)
    return sub(ct1, ct3)


def eval_sign(params: TfheParams, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
              beta: int = BETA, scheme_switch: bool = False,
              ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """EvalSign: the MSB of a ciphertext mod a modulus above q, by floors
    down the ladder mod -> mod 2 beta / q, then one bootstrap mod q."""
    _check_key(params, key)
    q = params.q
    mod = ct.modulus
    if mod <= q:
        raise ValueError("EvalSign requires ct modulus > q")
    cttmp = ct
    while mod > q:
        cttmp = eval_floor(params, key, cttmp, beta, 0, ntt_impl)
        mod = (mod * 2 * beta) // q
        cttmp = lwe.mod_switch(cttmp, mod)
    cttmp = add_const(cttmp, beta)
    # the ladder may end below q: the MSB threshold is the ciphertext's
    # current modulus (binfhe-base-scheme.cpp f3(x, ctMod, fmod))
    cm = cttmp.modulus
    x = np.arange(cm, dtype=np.uint64)
    if not scheme_switch:
        f3 = np.where(x < cm // 2, q // 4, q - q // 4)
        out = bootstrap_func(params, key, cttmp, f3.astype(np.uint32), q, ntt_impl)
        return sub_const(out, q >> 2)
    f3 = np.where(x < cm // 2, q - q // 4, q // 4)
    return bootstrap_func(params, key, cttmp, f3.astype(np.uint32), q, ntt_impl)


def eval_decomp(params: TfheParams, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
                beta: int = BETA, ntt_impl: str | None = None) -> list[lwe.LweCiphertext]:
    """EvalDecomp: the digits mod q of a ciphertext mod a modulus above q,
    least significant first."""
    _check_key(params, key)
    q = params.q
    mod = ct.modulus
    if mod <= q:
        raise ValueError("EvalDecomp requires ct modulus > q")
    cttmp = ct
    out = []
    while mod > q:
        out.append(set_modulus(cttmp, q))
        cttmp = eval_floor(params, key, cttmp, beta, 0, ntt_impl)
        mod = (mod * 2 * beta) // q
        cttmp = lwe.mod_switch(cttmp, mod)
    out.append(cttmp)
    return out


def generate_lut(f, p: int, q: int) -> np.ndarray:
    """GenerateLUTviaFunction: LUT[i] = (q/p) f(i // (q/p), p) over i in
    [0, q); f maps Z_p into Z_p, p a power of two."""
    if p < 1 or p & (p - 1):
        raise ValueError(f"plaintext modulus {p} is not a power of two")
    step = q // p
    i = np.arange(q, dtype=np.uint64)
    vals = np.array([int(f(int(m), p)) for m in range(p)], dtype=np.int64)
    if vals.min() < 0 or vals.max() >= p:
        raise ValueError("function must output in Z_p")
    return (vals.astype(np.uint64)[(i // step).astype(np.int64)] * step).astype(np.uint32)
