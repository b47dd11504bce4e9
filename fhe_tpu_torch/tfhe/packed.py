"""Packed ciphertext/key wire formats (contiguous, header-tagged).

Port of fhe_tpu/tfhe/packed.py (reference semantics: the C++ reference's
backend/packed.h: the 32-byte header with magic "LUXF" and PackedType,
PackedLWE / PackedLWEBatch with a sequential-or-interleaved flag,
PackedBootstrappingKey with layout flags, PackedSwitchingKey).  The bytes
are fhe_tpu's:

  * word size is uint32 (the reference packs 64-bit NativeIntegers); the
    port's int32 residues are written as the same uint32 words,
  * the batch INTERLEAVED layout is coefficient-major [n+1, B],
  * the bootstrap key packs the EVALUATION-format Montgomery tensor
    [n, 2, dG2, 2, N] (KEY_LAYOUT_NTT | KEY_LAYOUT_MONT), which is the
    port's `BootstrapKey.bsk` as it stands, so an unpacked key goes to the
    device with no relayout.

Packing copies each tensor to the host once; unpacking reads the words
with np.frombuffer and puts int32 tensors on `device` (the card unless
the caller names another).  The port has no Shoup dual of the key, so
`unpack_bsk`'s `with_shoup` is accepted for fhe_tpu's signature and has
no effect.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from . import lwe as lwemod
from . import rgsw as rgswmod
from .params import TfheParams

PACKED_MAGIC = 0x4C555846  # "LUXF"
PACKED_VERSION = 1

# PackedType (packed.h:33-41)
LWE_CIPHERTEXT = 1
LWE_BATCH = 2
RLWE_CIPHERTEXT = 3
RGSW_CIPHERTEXT = 4
BOOTSTRAPPING_KEY = 5
SWITCHING_KEY = 6
PARAMETERS = 7

# LWEPackFlags (packed.h:60-64)
LWE_PACK_DEFAULT = 0
LWE_PACK_INTERLEAVED = 1 << 0

# KeyLayoutFlags (packed.h:183-188) + TPU-native extension
KEY_LAYOUT_STANDARD = 0
KEY_LAYOUT_NTT = 1 << 1
KEY_LAYOUT_MONT = 1 << 4     # Montgomery residue form (TPU extension)

_HDR = struct.Struct("<IHHQQII")   # magic, ver, type, total, count, flags, rsvd (32 bytes)


def _header(ptype: int, total: int, count: int, flags: int = 0) -> bytes:
    return _HDR.pack(PACKED_MAGIC, PACKED_VERSION, ptype, total, count,
                     flags, 0)


def _parse_header(data: bytes, want_type: int):
    if len(data) < _HDR.size:
        raise ValueError("packed blob shorter than header")
    magic, ver, ptype, total, count, flags, _ = _HDR.unpack_from(data, 0)
    if magic != PACKED_MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if ver != PACKED_VERSION:
        raise ValueError(f"unsupported packed version {ver}")
    if ptype != want_type:
        raise ValueError(f"packed type {ptype}, want {want_type}")
    if total != len(data):
        raise ValueError(f"size mismatch: header {total}, blob {len(data)}")
    return count, flags


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _u32s(*arrays) -> bytes:
    """Residues (tensors or arrays, values below 2^32) as uint32 words."""
    return b"".join(np.ascontiguousarray(_host(a)).astype(np.uint32).tobytes()
                    for a in arrays)


def _view_u32(data: bytes, off: int, shape) -> np.ndarray:
    n = int(np.prod(shape))
    return np.frombuffer(data, dtype=np.uint32, count=n,
                         offset=off).reshape(shape)


def _tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words below 2^31 -> an int32 tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(words).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# LWE ciphertexts
# ---------------------------------------------------------------------------

_LWE_PARAMS = struct.Struct("<IIQQII")  # n, log_q, q, count, stride, pt_mod


def pack_lwe(ct: lwemod.LweCiphertext) -> bytes:
    """Single LWE ciphertext -> packed bytes (PackedLWE layout)."""
    a = _host(ct.a)
    b = _host(ct.b)
    if a.ndim != 1:
        raise ValueError("pack_lwe packs a single ciphertext; "
                         "use pack_lwe_batch")
    n = a.shape[0]
    params = _LWE_PARAMS.pack(n, int(ct.modulus).bit_length(),
                              ct.modulus, 1, 0, ct.pt_mod)
    payload = params + _u32s(a, b.reshape(1))
    total = _HDR.size + len(payload)
    return _header(LWE_CIPHERTEXT, total, 1) + payload


def unpack_lwe(data: bytes, device="cuda") -> lwemod.LweCiphertext:
    _parse_header(data, LWE_CIPHERTEXT)
    n, _logq, q, _cnt, _stride, pt_mod = _LWE_PARAMS.unpack_from(
        data, _HDR.size)
    off = _HDR.size + _LWE_PARAMS.size
    a = _view_u32(data, off, (n,))
    b = _view_u32(data, off + 4 * n, (1,))[0]
    return lwemod.LweCiphertext(a=_tensor(a, device), b=_tensor(b, device),
                                modulus=int(q), pt_mod=int(pt_mod))


def pack_lwe_batch(ct: lwemod.LweCiphertext,
                   flags: int = LWE_PACK_DEFAULT) -> bytes:
    """Batched LWE ciphertext [B] -> packed bytes (PackedLWEBatch).

    SEQUENTIAL: B rows of [a_0..a_{n-1}, b] (ciphertext-major).
    INTERLEAVED: [n+1, B] coefficient-major -- each coefficient position
    contiguous across the batch (packed.h:88-90 'good for SIMD')."""
    a = _host(ct.a)
    b = _host(ct.b)
    if a.ndim != 2:
        raise ValueError("pack_lwe_batch needs a [B, n] batch")
    B, n = a.shape
    rows = np.concatenate([a, b[:, None]], axis=1)          # [B, n+1]
    if flags & LWE_PACK_INTERLEAVED:
        body = _u32s(rows.T)
        stride = 4 * B
    else:
        body = _u32s(rows)
        stride = 4 * (n + 1)
    params = _LWE_PARAMS.pack(n, int(ct.modulus).bit_length(),
                              ct.modulus, B, stride, ct.pt_mod)
    payload = params + body
    return _header(LWE_BATCH, _HDR.size + len(payload), B, flags) + payload


def unpack_lwe_batch(data: bytes, device="cuda") -> lwemod.LweCiphertext:
    count, flags = _parse_header(data, LWE_BATCH)
    n, _logq, q, cnt, _stride, pt_mod = _LWE_PARAMS.unpack_from(
        data, _HDR.size)
    if cnt != count:
        raise ValueError("count mismatch between header and params")
    off = _HDR.size + _LWE_PARAMS.size
    if flags & LWE_PACK_INTERLEAVED:
        rows = _view_u32(data, off, (n + 1, count)).T
    else:
        rows = _view_u32(data, off, (count, n + 1))
    return lwemod.LweCiphertext(a=_tensor(rows[:, :n], device),
                                b=_tensor(rows[:, n], device),
                                modulus=int(q), pt_mod=int(pt_mod))


# ---------------------------------------------------------------------------
# Switching key
# ---------------------------------------------------------------------------

_KSK_PARAMS = struct.Struct("<IIIIQQQ")  # in_n, out_n, dc, Bks, qks, a_sz, b_sz


def pack_switching_key(ksk: lwemod.LweSwitchingKey, q_ks: int) -> bytes:
    a = _host(ksk.a)   # [N, dc, Bks, n]
    b = _host(ksk.b)   # [N, dc, Bks]
    N, dc, Bks, n = a.shape
    params = _KSK_PARAMS.pack(N, n, dc, Bks, q_ks, a.size, b.size)
    payload = params + _u32s(a, b)
    return _header(SWITCHING_KEY, _HDR.size + len(payload), N) + payload


def unpack_switching_key(data: bytes, device="cuda"
                         ) -> tuple[lwemod.LweSwitchingKey, int]:
    _parse_header(data, SWITCHING_KEY)
    N, n, dc, Bks, q_ks, a_sz, b_sz = _KSK_PARAMS.unpack_from(data, _HDR.size)
    off = _HDR.size + _KSK_PARAMS.size
    a = _view_u32(data, off, (N, dc, Bks, n))
    b = _view_u32(data, off + 4 * a_sz, (N, dc, Bks))
    return (lwemod.LweSwitchingKey(a=_tensor(a, device), b=_tensor(b, device)),
            int(q_ks))


# ---------------------------------------------------------------------------
# Bootstrapping key
# ---------------------------------------------------------------------------

_BSK_PARAMS = struct.Struct("<IIIIIIQQI4x")
# lwe_n, lwe_log_q, rlwe_N, num_limbs, dG2, base_log, Q, ksk_size, layout


def pack_bsk(params: TfheParams, key: rgswmod.BootstrapKey) -> bytes:
    """Bootstrap key -> packed bytes, in fhe_tpu's tensor layout
    ([n, 2, dG2, 2, N] EVAL/Montgomery -- KEY_LAYOUT_NTT |
    KEY_LAYOUT_MONT), the port's `BootstrapKey.bsk`."""
    bsk = _host(key.bsk)
    ksk_blob = pack_switching_key(key.ksk, params.q_ks)
    layout = KEY_LAYOUT_NTT | KEY_LAYOUT_MONT
    head = _BSK_PARAMS.pack(params.n, int(params.q).bit_length(), params.N,
                            1, params.digits_g2,
                            int(params.base_g).bit_length() - 1, params.Q,
                            len(ksk_blob), layout)
    payload = head + _u32s(bsk) + ksk_blob
    return _header(BOOTSTRAPPING_KEY, _HDR.size + len(payload),
                   params.n, layout) + payload


def unpack_bsk(params: TfheParams, data: bytes,
               with_shoup: bool = True, device="cuda") -> rgswmod.BootstrapKey:
    """Packed bytes -> BootstrapKey on `device`.  `with_shoup` has no
    effect: the port's kernels keep no Shoup dual of the key."""
    _parse_header(data, BOOTSTRAPPING_KEY)
    (n, _logq, N, _limbs, dg2, _blog, Q, ksk_size,
     layout) = _BSK_PARAMS.unpack_from(data, _HDR.size)
    if (n, N, dg2, Q) != (params.n, params.N, params.digits_g2, params.Q):
        raise ValueError("packed bootstrap key does not match params")
    if not (layout & KEY_LAYOUT_NTT) or not (layout & KEY_LAYOUT_MONT):
        raise ValueError("unsupported bootstrap key layout")
    off = _HDR.size + _BSK_PARAMS.size
    shape = (n, 2, dg2, 2, N)
    bsk_np = _view_u32(data, off, shape)
    ksk, _q_ks = unpack_switching_key(data[off + 4 * bsk_np.size:], device)
    return rgswmod.BootstrapKey(bsk=_tensor(bsk_np, device), ksk=ksk)
