"""ctypes loader for the full lux_fhe_* C API (capi.cpp).

Port of fhe_tpu/native/capi.py.  `capi.cpp` is the port's own copy of
fhe_tpu's, which imports fhe_tpu_torch.native.capi_impl instead; same
symbols, same signatures.  The library is built with g++ at first use
(`native.build`), against this interpreter's headers and, where it has
one, its shared libpython.  It embeds or joins CPython, so loading it from
a Python process routes C calls back into this interpreter's
capi_impl registries -- which is how the Go/cgo bindings consume it
out-of-process too (they link libpython).  A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import functools
import sysconfig

from . import build

_u8p = ctypes.POINTER(ctypes.c_uint8)

# process libc free() for malloc'd output buffers (ckks_decrypt doubles)
libc_free = ctypes.CDLL(None).free
libc_free.argtypes = [ctypes.c_void_p]
libc_free.restype = None


def _link_flags() -> tuple[str, ...]:
    """This interpreter's include directory, and its shared libpython when
    it has one (so that plain C programs can embed; otherwise the symbols
    resolve from the hosting Python process)."""
    flags = [f"-I{sysconfig.get_paths()['include']}"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if ldlib.endswith(".so") and libdir:
        flags += [f"-L{libdir}", f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    return tuple(flags)


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """libfhecapi (built at first use); raises if it cannot be built or
    loaded."""
    lib = ctypes.CDLL(str(build("capi.cpp", _link_flags())))
    lib.lux_fhe_version.restype = ctypes.c_char_p
    lib.lux_fhe_strerror.restype = ctypes.c_char_p
    lib.lux_fhe_strerror.argtypes = [ctypes.c_int]
    lib.lux_fhe_has_gpu.restype = ctypes.c_int
    for name in ("lux_fhe_context_n", "lux_fhe_context_ring_dim",
                 "lux_fhe_context_modulus"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.lux_fhe_context_new.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_keygen_secret.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p)]
    for name in ("lux_fhe_keygen_bootstrap", "lux_fhe_keygen_public"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_ciphertext_clone.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_encrypt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_encrypt_pk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_decrypt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    for g in ("and", "or", "xor", "nand", "nor", "xnor"):
        getattr(lib, f"lux_fhe_{g}").argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_not.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_mux.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_bootstrap.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p)]
    for name in ("lux_fhe_ciphertext_marshal",
                 "lux_fhe_secretkey_marshal"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_u8p),
            ctypes.POINTER(ctypes.c_int64)]
    for name in ("lux_fhe_ciphertext_unmarshal",
                 "lux_fhe_secretkey_unmarshal"):
        getattr(lib, name).argtypes = [
            _u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)]
    for name in ("lux_fhe_context_free", "lux_fhe_secretkey_free",
                 "lux_fhe_publickey_free", "lux_fhe_bootstrapkey_free",
                 "lux_fhe_ciphertext_free"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.lux_fhe_bytes_free.argtypes = [_u8p]
    # ---- threshold ABI (go/threshold parity, working) ----
    lib.lux_fhe_threshold_keygen.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.lux_fhe_threshold_free.argtypes = [ctypes.c_void_p]
    lib.lux_fhe_threshold_parties.restype = ctypes.c_int
    lib.lux_fhe_threshold_parties.argtypes = [ctypes.c_void_p]
    lib.lux_fhe_threshold_decrypt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    # ---- ckks_* ABI (go/ckks bridge parity) ----
    vp = ctypes.c_void_p
    lib.ckks_context_new.restype = vp
    lib.ckks_context_new.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_double]
    lib.ckks_context_free.argtypes = [vp]
    lib.ckks_keygen.restype = vp
    lib.ckks_keygen.argtypes = [vp]
    lib.ckks_keypair_free.argtypes = [vp]
    lib.ckks_encrypt.restype = vp
    lib.ckks_encrypt.argtypes = [vp, vp,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_int]
    lib.ckks_decrypt.restype = ctypes.POINTER(ctypes.c_double)
    lib.ckks_decrypt.argtypes = [vp, vp, vp,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.ckks_ciphertext_free.argtypes = [vp]
    for nm in ("ckks_add", "ckks_sub"):
        getattr(lib, nm).restype = vp
        getattr(lib, nm).argtypes = [vp, vp, vp]
    lib.ckks_mult.restype = vp                  # reference 3-arg ABI
    lib.ckks_mult.argtypes = [vp, vp, vp]
    lib.ckks_mult_kp.restype = vp               # explicit-keypair form
    lib.ckks_mult_kp.argtypes = [vp, vp, vp, vp]
    lib.ckks_context_levels.restype = ctypes.c_int
    lib.ckks_context_levels.argtypes = [vp]
    lib.ckks_rotate.restype = vp
    lib.ckks_rotate.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.ckks_bootstrap.restype = vp
    lib.ckks_bootstrap.argtypes = [vp, vp, vp]
    lib.ckks_serialize_ciphertext.restype = _u8p
    lib.ckks_serialize_ciphertext.argtypes = [
        vp, ctypes.POINTER(ctypes.c_int)]
    lib.ckks_deserialize_ciphertext.restype = vp
    lib.ckks_deserialize_ciphertext.argtypes = [vp, _u8p, ctypes.c_int]
    return lib
