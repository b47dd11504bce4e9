"""Python-side implementation behind the native full C API (capi.cpp).

Port of fhe_tpu/native/capi_impl.py.  The reference's C API
(src/c_api/c_api.cpp:73-366) wraps BinFHEContext in-process:
context/keys/gates/mux/bootstrap/marshal with opaque handles and integer
error codes.  Here the compute path is the port on the card, so the native
library embeds CPython and delegates every call to this module, which keeps
integer-handle registries (the C side only ever sees int64 ids) over the
port's BinFheContext, LWE, threshold and CkksContext / bootstrap.  All
functions return plain ints/bytes/lists so the C shim needs no numpy C API.

The ABI has no device argument: every context made here lives on the
module's device, the first CUDA card unless `set_device` names another
("cpu" in the CPU tests).  `has_tpu` keeps fhe_tpu's name, because
capi.cpp calls it by that name behind lux_fhe_has_gpu: it returns 1 iff
the registries run on a CUDA card.  Ciphertexts and keys marshal through
utils/serial, on fhe_tpu's wire format.

Error contract: exceptions never cross the C boundary -- the C side maps
a Python exception to LUX_FHE_ERR_* after clearing it.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_next_id = 1
_contexts: dict[int, object] = {}
_secret_keys: dict[int, tuple] = {}     # (sk, sk_n)
_public_keys: dict[int, object] = {}
_boot_keys: dict[int, object] = {}
_ciphertexts: dict[int, object] = {}

VERSION = "1.4.2"   # mirrors the reference c_api.cpp version string

_device = torch.device("cuda")


def set_device(device) -> None:
    """The device of every context made from now on ("cuda", "cuda:1",
    "cpu")."""
    global _device
    _device = torch.device(device)



def _new_id() -> int:
    global _next_id
    with _lock:
        i = _next_id
        _next_id += 1
        return i


def version() -> str:
    return VERSION


def has_tpu() -> int:
    """lux_fhe_has_gpu: 1 iff the registries run on a CUDA card (the name
    is the one capi.cpp calls)."""
    return int(_device.type == "cuda" and torch.cuda.is_available())


def context_new(param_set: str, method: str = "GINX") -> int:
    from ..tfhe.context import BinFheContext
    ctx = BinFheContext.generate(param_set, method, device=_device)
    i = _new_id()
    _contexts[i] = ctx
    return i


def context_free(h: int) -> None:
    _contexts.pop(h, None)


def context_n(h: int) -> int:
    return int(_contexts[h].params.n)


def context_ring_dim(h: int) -> int:
    return int(_contexts[h].params.N)


def context_modulus(h: int) -> int:
    return int(_contexts[h].params.q)


def keygen_secret(h: int, seed: int) -> int:
    ctx = _contexts[h]
    rng = np.random.default_rng(seed if seed else None)
    sk = ctx.key_gen(rng)
    sk_n = ctx.key_gen_n(rng)
    i = _new_id()
    _secret_keys[i] = (sk, sk_n, rng)
    return i


def keygen_bootstrap(h: int, sk_h: int) -> int:
    ctx = _contexts[h]
    sk, sk_n, rng = _secret_keys[sk_h]
    key = ctx.bt_key_gen(sk, rng, sk_n=sk_n)
    i = _new_id()
    _boot_keys[i] = key
    return i


def keygen_public(h: int, sk_h: int) -> int:
    from ..tfhe import lwe
    ctx = _contexts[h]
    sk, sk_n, rng = _secret_keys[sk_h]
    pk = lwe.pub_key_gen(ctx.params, sk_n, rng)
    i = _new_id()
    _public_keys[i] = pk
    return i


def key_free(h: int) -> None:
    _secret_keys.pop(h, None)
    _public_keys.pop(h, None)
    _boot_keys.pop(h, None)


def encrypt(h: int, sk_h: int, bit: int) -> int:
    ctx = _contexts[h]
    sk, _sk_n, rng = _secret_keys[sk_h]
    ct = ctx.encrypt(sk, np.array([bit & 1]), rng)
    i = _new_id()
    _ciphertexts[i] = ct
    return i


def encrypt_pk(h: int, pk_h: int, sk_h: int, bit: int) -> int:
    from ..tfhe import lwe
    ctx = _contexts[h]
    pk = _public_keys[pk_h]
    _sk, _sk_n, rng = _secret_keys[sk_h]
    ct = lwe.encrypt_pk(ctx.params, pk, np.array([bit & 1]), rng)
    i = _new_id()
    _ciphertexts[i] = ct
    return i


def decrypt(h: int, sk_h: int, ct_h: int) -> int:
    ctx = _contexts[h]
    sk, sk_n, _rng = _secret_keys[sk_h]
    ct = _ciphertexts[ct_h]
    key = sk if ct.a.shape[-1] == ctx.params.n else sk_n
    return int(ctx.decrypt(key, ct).reshape(-1)[0])


def ciphertext_free(h: int) -> None:
    _ciphertexts.pop(h, None)


def ciphertext_clone(h: int) -> int:
    i = _new_id()
    _ciphertexts[i] = _ciphertexts[h]    # cts are never changed in place
    return i


def eval_gate(h: int, bk_h: int, gate: str, a_h: int, b_h: int) -> int:
    from ..tfhe.params import Gate
    ctx = _contexts[h]
    key = _boot_keys[bk_h]
    out = ctx.eval_bin_gate(key, Gate[gate.upper()],
                            _ciphertexts[a_h], _ciphertexts[b_h])
    i = _new_id()
    _ciphertexts[i] = out
    return i


def eval_not(h: int, ct_h: int) -> int:
    ctx = _contexts[h]
    out = ctx.eval_not(_ciphertexts[ct_h])
    i = _new_id()
    _ciphertexts[i] = out
    return i


def eval_mux(h: int, bk_h: int, sel_h: int, a_h: int, b_h: int) -> int:
    """CMUX(sel, a, b) = sel ? a : b (c_api.cpp:246-258)."""
    ctx = _contexts[h]
    key = _boot_keys[bk_h]
    out = ctx.eval_cmux(key, _ciphertexts[b_h], _ciphertexts[a_h],
                        _ciphertexts[sel_h])
    i = _new_id()
    _ciphertexts[i] = out
    return i


def bootstrap(h: int, bk_h: int, ct_h: int) -> int:
    ctx = _contexts[h]
    out = ctx.bootstrap(_boot_keys[bk_h], _ciphertexts[ct_h])
    i = _new_id()
    _ciphertexts[i] = out
    return i


def ciphertext_marshal(ct_h: int) -> bytes:
    from ..utils import serial
    return serial.dumps(_ciphertexts[ct_h], mode="binary")


def ciphertext_unmarshal(data: bytes) -> int:
    from ..utils import serial
    ct = serial.loads(bytes(data), mode="binary", device=_device)
    i = _new_id()
    _ciphertexts[i] = ct
    return i


def secretkey_marshal(sk_h: int) -> bytes:
    from ..utils import serial
    sk, sk_n, _rng = _secret_keys[sk_h]
    return serial.dumps([sk, sk_n], mode="binary")


def secretkey_unmarshal(data: bytes) -> int:
    from ..utils import serial
    sk, sk_n = serial.loads(bytes(data), mode="binary", device=_device)
    i = _new_id()
    _secret_keys[i] = (sk, sk_n, np.random.default_rng())
    return i


# ---------------------------------------------------------------------------
# Threshold TFHE surface (reference: go/threshold/threshold.go is a TODO
# stub over batch_threshold.h; this one drives the real t-of-n pipeline in
# tfhe/threshold.py -- Shamir/Feldman shares, sigma-protocol proofs,
# Lagrange combine), the shares on the secret's device.
# ---------------------------------------------------------------------------

_threshold: dict[int, dict] = {}


def threshold_keygen(h: int, sk_h: int, t: int, n: int,
                     scheme: str = "additive") -> int:
    """Split the context's LWE secret into n shares (t-of-n for shamir,
    n-of-n for additive).  Returns a share-set handle."""
    from ..tfhe import threshold as th
    ctx = _contexts[h]
    sk, _sk_n, _rng = _secret_keys[sk_h]
    cfg = th.ThresholdConfig(threshold=int(t), total_parties=int(n),
                             scheme=scheme)
    shares, vks = th.generate_key_shares(sk.s, int(ctx.params.q), cfg)
    i = _new_id()
    _threshold[i] = {"cfg": cfg, "shares": shares, "vks": vks}
    return i


def threshold_free(h: int) -> None:
    _threshold.pop(h, None)


def threshold_parties(h: int) -> int:
    return int(_threshold[h]["cfg"].total_parties)


def threshold_decrypt(h: int, th_h: int, ct_h: int, ids: bytes) -> int:
    """Run partial decrypts for the given parties (int32-packed ids) +
    proof verification + combine; returns the decrypted bit (first slot),
    or raises when the quorum is short / a proof fails."""
    from ..tfhe import threshold as th
    st = _threshold[th_h]
    cfg, shares, vks = st["cfg"], st["shares"], st["vks"]
    party_ids = set(np.frombuffer(bytes(ids), dtype="<i4").tolist())
    use = [s for s in shares if s.party_id in party_ids]
    ct = _ciphertexts[ct_h]
    got = th.threshold_decrypt(cfg, ct, use, vks, p=4)
    val = int(got.reshape(-1)[0])
    if val not in (0, 1):
        # a noisy/failed decrypt decodes to 2 or 3 at p=4 -- surface it
        # (mapped to LUX_FHE_ERR_DECRYPT by the C shim) instead of folding
        # it into a plausible-looking bit
        raise ValueError(f"threshold decrypt out of range: {val}")
    return val


# ---------------------------------------------------------------------------
# CKKS surface (reference: go/ckks/bridge.cpp ckks_* extern "C" ABI).
#
# The reference bridge wraps CryptoContext<DCRTPoly> with FLEXIBLEAUTO and
# generates relin + stock rotation keys at keygen (bridge.cpp:33-80).  Here
# the context holder maps (log_n, log_q, scale) onto the 32-bit-limb chain:
# scale factors above 2^28 use composite scaling (degree 2), as
# pke/params.py realizes large deltas.  Rotation keys for
# the stock step set are made at keygen like the reference; missing steps
# are generated lazily from the cached secret key (the reference would
# throw there -- bridge.cpp:169-180 only has +-{1,2,4,8,16}).
# ---------------------------------------------------------------------------

_ckks_ctx: dict[int, object] = {}
_ckks_kp: dict[int, dict] = {}
_ckks_ct: dict[int, object] = {}
_ckks_default_kp: dict[int, int] = {}   # ctx handle -> latest keygen handle

_CKKS_STOCK_ROTS = (1, -1, 2, -2, 4, -4, 8, -8, 16, -16)


def ckks_context_new(log_n: int, log_q: int, scale: float) -> int:
    import math
    from ..pke import ckks as ckksmod
    N = 1 << int(log_n)
    if scale <= 1:
        return -1                      # reject instead of silently fixing
    sb = int(round(math.log2(scale)))
    cd = 1 if sb <= 28 else 2
    per = sb if cd == 1 else (sb + 1) // 2
    if per > 28:
        return -1                      # delta > 2^56 unsupported
    # chain length from the logQ budget: one first limb block + levels
    levels = (int(log_q) // per) - cd
    if levels < 2 * cd:
        return -1                      # logQ budget too small for the scale
    levels = min(64, levels)
    ctx = ckksmod.CkksContext.create(N=N, num_levels=levels, scale_bits=sb,
                                     dnum=2, composite_degree=cd, device=_device)
    i = _new_id()
    _ckks_ctx[i] = ctx
    return i


def ckks_context_levels(h: int) -> int:
    """Realized multiplicative depth of the chain (accessor so callers can
    see what their logQ budget bought -- nothing is silently clamped)."""
    ctx = _ckks_ctx[h]
    cd = ctx.params.composite_degree
    return int(len(ctx.params.moduli) // cd - 1)


def ckks_context_free(h: int) -> None:
    _ckks_ctx.pop(h, None)
    _ckks_default_kp.pop(h, None)


def ckks_keygen(h: int, seed: int = 0) -> int:
    ctx = _ckks_ctx[h]
    rng = np.random.default_rng(seed if seed else None)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    rot = ctx.rotation_key_gen(sk, _CKKS_STOCK_ROTS, rng)
    i = _new_id()
    _ckks_kp[i] = {"sk": sk, "pk": pk, "evk": evk, "rot": rot,
                   "rng": rng, "boot": None}
    # register as the context's default keypair: the reference-ABI 3-arg
    # ckks_mult(ctx, a, b) resolves its eval key through this
    _ckks_default_kp[h] = i
    return i


def ckks_keypair_free(h: int) -> None:
    _ckks_kp.pop(h, None)


def ckks_encrypt(ctx_h: int, kp_h: int, values: bytes) -> int:
    """values: packed little-endian float64s (the C double* buffer)."""
    ctx = _ckks_ctx[ctx_h]
    kp = _ckks_kp[kp_h]
    z = np.frombuffer(bytes(values), dtype="<f8")
    slots = ctx.params.N // 2
    if len(z) > slots:
        raise ValueError("too many values for slot count")
    full = np.zeros(slots)
    full[:len(z)] = z
    ct = ctx.encrypt(kp["pk"], full, kp["rng"])
    i = _new_id()
    _ckks_ct[i] = ct
    return i


def ckks_decrypt(ctx_h: int, kp_h: int, ct_h: int) -> bytes:
    ctx = _ckks_ctx[ctx_h]
    kp = _ckks_kp[kp_h]
    z = np.asarray(ctx.decrypt(kp["sk"], _ckks_ct[ct_h])).real
    return np.ascontiguousarray(z, dtype="<f8").tobytes()


def ckks_ciphertext_free(h: int) -> None:
    _ckks_ct.pop(h, None)


def _ckks_store(ct) -> int:
    i = _new_id()
    _ckks_ct[i] = ct
    return i


def ckks_add(ctx_h: int, a_h: int, b_h: int) -> int:
    from ..pke import advanced
    ctx = _ckks_ctx[ctx_h]
    return _ckks_store(advanced.add_aligned(ctx, _ckks_ct[a_h],
                                            _ckks_ct[b_h]))


def ckks_sub(ctx_h: int, a_h: int, b_h: int) -> int:
    from ..pke import advanced, ckks as ckksmod
    from ..lattice import rns
    ctx = _ckks_ctx[ctx_h]
    b = _ckks_ct[b_h]
    neg = ckksmod.Ciphertext(rns.neg(b.c0), rns.neg(b.c1), b.scale)
    return _ckks_store(advanced.add_aligned(ctx, _ckks_ct[a_h], neg))


def ckks_mult(ctx_h: int, kp_h: int, a_h: int, b_h: int) -> int:
    """EvalMult + relinearize + rescale (FLEXIBLEAUTO semantics)."""
    from ..pke import advanced
    ctx = _ckks_ctx[ctx_h]
    evk = _ckks_kp[kp_h]["evk"]
    return _ckks_store(advanced.mul_aligned(ctx, _ckks_ct[a_h],
                                            _ckks_ct[b_h], evk))


def ckks_mult_ctx(ctx_h: int, a_h: int, b_h: int) -> int:
    """Reference-ABI 3-arg mult: eval key comes from the context's
    registered (latest-keygen) keypair."""
    return ckks_mult(ctx_h, _ckks_default_kp[ctx_h], a_h, b_h)


def ckks_rotate(ctx_h: int, kp_h: int, ct_h: int, steps: int) -> int:
    ctx = _ckks_ctx[ctx_h]
    kp = _ckks_kp[kp_h]
    if steps not in kp["rot"]:
        kp["rot"].update(ctx.rotation_key_gen(kp["sk"], [steps], kp["rng"]))
    return _ckks_store(ctx.rotate(_ckks_ct[ct_h], steps, kp["rot"]))


_CKKS_BOOT_H = 16        # encapsulation helper weight (SPARSE_ENCAPSULATED)


def ckks_bootstrap(ctx_h: int, kp_h: int, ct_h: int) -> int:
    """EvalBootstrap with lazy Setup/KeyGen cached on the keypair.  Uses
    the SPARSE_ENCAPSULATED path (dense main secret + weight-16 helper)
    so the keypair from ckks_keygen bootstraps as-is.  The reference
    bridge forwards to cc->EvalBootstrap without ever running
    EvalBootstrapSetup (bridge.cpp:182-195) and so always fails; this
    one works, given a chain with >= 10 levels."""
    from ..pke import bootstrap
    ctx = _ckks_ctx[ctx_h]
    kp = _ckks_kp[kp_h]
    if len(ctx.params.moduli) < 10:
        raise ValueError("chain too short for bootstrapping (need logQ "
                         "budget for raise + CtS + sine + StC)")
    if kp["boot"] is None:
        pre = bootstrap.setup(ctx, h=_CKKS_BOOT_H)
        keys = bootstrap.keygen(ctx, kp["sk"], pre, kp["rng"],
                                encapsulate_h=_CKKS_BOOT_H)
        kp["boot"] = (pre, keys)
    pre, keys = kp["boot"]
    return _ckks_store(bootstrap.eval_bootstrap(ctx, _ckks_ct[ct_h],
                                                pre, keys))


def ckks_serialize_ciphertext(ct_h: int) -> bytes:
    from ..utils import serial
    return serial.dumps(_ckks_ct[ct_h], mode="binary")


def ckks_deserialize_ciphertext(ctx_h: int, data: bytes) -> int:
    from ..utils import serial
    from ..pke import ckks as ckksmod
    ct = serial.loads(bytes(data), mode="binary", device=_device)
    if not isinstance(ct, ckksmod.Ciphertext):
        raise TypeError(f"blob decodes to {type(ct).__name__}, "
                        "not a CKKS ciphertext")
    params = _ckks_ctx[ctx_h].params
    lims = tuple(int(m) for m in ct.c0.moduli)
    if ct.c0.data.shape[-1] != params.N or \
            lims != tuple(params.moduli)[:len(lims)]:
        raise ValueError("ciphertext does not match context: ring dim "
                         f"{ct.c0.data.shape[-1]} vs {params.N} or limb "
                         "moduli are not a prefix of the context chain")
    return _ckks_store(ct)
