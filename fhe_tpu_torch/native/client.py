"""ctypes bindings for the native client library (client.cpp): BLAKE2b
CSPRNG, LWE keygen/encrypt/decrypt with the exact ciphertext layout of
the port's tfhe.lwe (b = <a, s> + e + m q/p mod q).

Port of fhe_tpu/native/client.py: the framework's equivalent of the
reference's lux_fhe_* C ABI (src/c_api/c_api.cpp) and Blake2Engine
(utils/prng/blake2engine.h).  Clients generate keys and encrypt or decrypt
on the host through this dependency-free C library; the gates run on the
card.  `as_ciphertext` / `ciphertext_words` move between the library's
uint32 words and the port's LweCiphertext (int32 words, same bits).  The
library is built with g++ at first use (`native.build`); a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("client.cpp")))
    lib.fhe_client_version.restype = ctypes.c_int
    lib.fhe_blake2b.argtypes = [_u8p, ctypes.c_int64, _u8p, ctypes.c_int]
    lib.fhe_prng_uniform.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint64, _u64p,
                                     ctypes.c_int64]
    lib.fhe_prng_gaussian.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_double, _i64p,
                                      ctypes.c_int64]
    lib.fhe_lwe_keygen.argtypes = [_u8p, ctypes.c_int, _i32p]
    lib.fhe_lwe_encrypt.argtypes = [_i32p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, _i32p,
                                    ctypes.c_int64, _u8p, ctypes.c_double, _u32p, _u32p]
    lib.fhe_lwe_decrypt.argtypes = [_i32p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, _u32p,
                                    _u32p, ctypes.c_int64, _i32p]
    for fn in (lib.fhe_blake2b, lib.fhe_prng_uniform, lib.fhe_prng_gaussian, lib.fhe_lwe_keygen,
               lib.fhe_lwe_encrypt, lib.fhe_lwe_decrypt):
        fn.restype = None
    return lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _seed(seed: bytes) -> np.ndarray:
    if len(seed) < 32:
        raise ValueError(f"a seed is 32 bytes, got {len(seed)}")
    return np.frombuffer(seed, dtype=np.uint8).copy()


def blake2b(data: bytes, outlen: int = 32) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8).copy()
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    out = np.zeros(outlen, dtype=np.uint8)
    get_lib().fhe_blake2b(_p(buf, ctypes.c_uint8), len(data), _p(out, ctypes.c_uint8), outlen)
    return out.tobytes()


def prng_uniform(seed: bytes, stream: int, q: int, count: int) -> np.ndarray:
    out = np.zeros(count, dtype=np.uint64)
    get_lib().fhe_prng_uniform(_p(_seed(seed), ctypes.c_uint8), stream, q,
                               _p(out, ctypes.c_uint64), count)
    return out


def prng_gaussian(seed: bytes, stream: int, std: float, count: int) -> np.ndarray:
    out = np.zeros(count, dtype=np.int64)
    get_lib().fhe_prng_gaussian(_p(_seed(seed), ctypes.c_uint8), stream, std,
                                _p(out, ctypes.c_int64), count)
    return out


def lwe_keygen(seed: bytes, n: int) -> np.ndarray:
    sk = np.zeros(n, dtype=np.int32)
    get_lib().fhe_lwe_keygen(_p(_seed(seed), ctypes.c_uint8), n, _p(sk, ctypes.c_int32))
    return sk


def lwe_encrypt(sk: np.ndarray, q: int, p: int, m: np.ndarray, seed: bytes,
                std: float = 3.19) -> tuple[np.ndarray, np.ndarray]:
    """(a [batch, n], b [batch]) uint32."""
    sk = np.ascontiguousarray(sk, dtype=np.int32)
    m = np.ascontiguousarray(m, dtype=np.int32)
    n, batch = len(sk), len(m)
    a = np.zeros((batch, n), dtype=np.uint32)
    b = np.zeros(batch, dtype=np.uint32)
    get_lib().fhe_lwe_encrypt(_p(sk, ctypes.c_int32), n, q, p, _p(m, ctypes.c_int32), batch,
                              _p(_seed(seed), ctypes.c_uint8), std, _p(a, ctypes.c_uint32),
                              _p(b, ctypes.c_uint32))
    return a, b


def lwe_decrypt(sk: np.ndarray, q: int, p: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    sk = np.ascontiguousarray(sk, dtype=np.int32)
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if a.ndim != 2 or a.shape != (len(b), len(sk)):
        raise ValueError(f"a {a.shape}, b {b.shape} and a key of {len(sk)} do not match")
    m = np.zeros(len(b), dtype=np.int32)
    get_lib().fhe_lwe_decrypt(_p(sk, ctypes.c_int32), a.shape[1], q, p, _p(a, ctypes.c_uint32),
                              _p(b, ctypes.c_uint32), len(b), _p(m, ctypes.c_int32))
    return m


def as_ciphertext(a: np.ndarray, b: np.ndarray, q: int, p: int = 4, device="cuda"):
    """The library's (a, b) words as the port's LweCiphertext on device."""
    from ..tfhe import lwe
    return lwe.LweCiphertext(
        a=torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device),
        b=torch.from_numpy(np.ascontiguousarray(b, dtype=np.uint32).view(np.int32)).to(device),
        modulus=q, pt_mod=p)


def ciphertext_words(ct) -> tuple[np.ndarray, np.ndarray]:
    """A port LweCiphertext's (a, b) as the library's uint32 host words."""
    return (ct.a.cpu().contiguous().numpy().view(np.uint32),
            ct.b.cpu().contiguous().numpy().view(np.uint32))
