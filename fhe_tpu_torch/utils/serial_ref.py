"""Readers and a writer for the REFERENCE's serialized LWE ciphertexts
(cereal archives).

Port of fhe_tpu/utils/serial_ref.py.  The reference serializes through
vendored cereal in two SerTypes (utils/serial.h:119,166): BINARY (cereal
portable-binary) and JSON.  This module parses both for LWE ciphertexts,
so reference-produced archives load directly into the port's
`LweCiphertext` on the device the caller names, and writes the binary one
back byte for byte.

Portable-binary layout for a serialized LWECiphertext
(shared_ptr<LWECiphertextImpl>; field order from lwe-ciphertext.h:135
save() and mubintvecnat.h:657 NativeVector::save):

  u8   endian flag (1 = little-endian stream)
  u32  polymorphic_id        (0x40000000: non-polymorphic ptr marker)
  u32  ptr_wrapper id        (0x80000001: first occurrence, inline data)
  u32  LWECiphertextImpl class version
  u32  NativeVector class version        } m_a
  u64  length                            }
  u64  x length  values                  }
  u32  NativeIntegerT class version (written once per archive)
  u64  modulus q
  u64  m_b value

JSON is the same tree with cereal's NVP names (value0.ptr_wrapper.data
{a: {v: [...], m: {v: q}}, b: {v: b}})."""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..tfhe import lwe as lwemod

_PTR_NONPOLY = 0x40000000
_PTR_FIRST = 0x80000001


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.off)[0]
        self.off += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.off)[0]
        self.off += 8
        return v

    def u64s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.data, dtype="<u8", count=n, offset=self.off)
        self.off += 8 * n
        return v.copy()


def _ciphertext(a: np.ndarray, b: int, q: int, pt_mod: int, device) -> lwemod.LweCiphertext:
    """The words as the port holds them: int32 (every LWE modulus is below 2^31)."""
    if q >= 1 << 31:
        raise ValueError(f"LWE modulus {q} does not fit the port's int32 words")
    return lwemod.LweCiphertext(a=torch.from_numpy(a.astype(np.int32)).to(device),
                                b=torch.tensor(b, dtype=torch.int32, device=device),
                                modulus=int(q), pt_mod=pt_mod)


def load_lwe_binary(path: str, pt_mod: int = 4, device="cuda") -> lwemod.LweCiphertext:
    """Parse a reference SerType::BINARY LWE ciphertext archive."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u8() != 1:
        raise ValueError("not a little-endian cereal portable-binary stream")
    if r.u32() != _PTR_NONPOLY:
        raise ValueError("unexpected polymorphic id")
    if r.u32() != _PTR_FIRST:
        raise ValueError("unexpected ptr_wrapper id (shared or null ptr)")
    _ct_ver = r.u32()
    _vec_ver = r.u32()
    n = r.u64()
    if not (0 < n <= 1 << 20):
        raise ValueError(f"implausible LWE dimension {n}")
    a = r.u64s(n)
    _int_ver = r.u32()
    q = r.u64()
    b = r.u64()
    if r.off != len(r.data):
        raise ValueError(f"{len(r.data) - r.off} trailing bytes")
    return _ciphertext(a, b, q, pt_mod, device)


def load_lwe_json(path: str, pt_mod: int = 4, device="cuda") -> lwemod.LweCiphertext:
    """Parse a reference SerType::JSON LWE ciphertext archive."""
    with open(path) as f:
        doc = json.load(f)
    try:
        data = doc["value0"]["ptr_wrapper"]["data"]
        a = np.asarray(data["a"]["v"], dtype=np.uint64)
        q = int(data["a"]["m"]["v"])
        b = int(data["b"]["v"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"not a serialized LWE ciphertext: {e}") from e
    return _ciphertext(a, b, q, pt_mod, device)


def dump_lwe_binary(ct: lwemod.LweCiphertext, path: str) -> None:
    """Write one LWE ciphertext as a reference-loadable SerType::BINARY
    archive (inverse of load_lwe_binary)."""
    a = ct.a.cpu().numpy().view(np.uint32).astype(np.uint64)
    if a.ndim != 1:
        raise ValueError("one ciphertext per archive")
    b = int(ct.b.cpu().numpy().view(np.uint32))
    out = bytearray()
    out += struct.pack("<B", 1)
    out += struct.pack("<I", _PTR_NONPOLY)
    out += struct.pack("<I", _PTR_FIRST)
    out += struct.pack("<I", 0)            # LWECiphertextImpl version
    out += struct.pack("<I", 1)            # NativeVector version
    out += struct.pack("<Q", a.shape[0])
    out += a.astype("<u8").tobytes()
    out += struct.pack("<I", 1)            # NativeIntegerT version
    out += struct.pack("<Q", int(ct.modulus))
    out += struct.pack("<Q", b)
    with open(path, "wb") as f:
        f.write(bytes(out))
