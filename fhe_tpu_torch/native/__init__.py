"""Native (C++) host components, built with g++ and loaded with ctypes.

Port of fhe_tpu/native/__init__.py: the host CRT codec (exact big-integer
reconstruction and reduction of RNS residues, `crt_codec.cpp`, the role of
the reference's math HAL big-integer backends,
src/core/include/math/hal/bigintfxd).  `build` is the g++ step of the
package's three C++ sources (`crt_codec.cpp`, `client.cpp` and
`capi.cpp`, the port's own copies of fhe_tpu's): each is compiled at first
use into `fhe_tpu_torch/_build/native/`, keyed by a hash of the source and
the command, so a changed source rebuilds.  A failed build raises with the
compiler's output; nothing falls back to a Python path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(source: str, extra: tuple[str, ...] = ()) -> Path:
    """Compile SRC_DIR/source into a shared library (once per source and
    command); returns its path.  Raises RuntimeError with g++'s output."""
    src = SRC_DIR / source
    cmd = ["g++", *CXX_FLAGS, str(src), *extra]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(cmd).encode())
    out = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The native codec (built at first use); raises if it cannot be built
    or loaded."""
    lib = ctypes.CDLL(str(build("crt_codec.cpp")))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.crt_center_mod.argtypes = [u32p, u32p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, i64p]
    lib.crt_center_double.argtypes = [u32p, u32p, ctypes.c_int, ctypes.c_int, f64p]
    lib.crt_scale_round_mod.argtypes = [u32p, u32p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                                        i64p]
    lib.signed_to_residues.argtypes = [i64p, u32p, ctypes.c_int, ctypes.c_int, u32p]
    for fn in (lib.crt_center_mod, lib.crt_center_double, lib.crt_scale_round_mod,
               lib.signed_to_residues):
        fn.restype = None
    return lib


def _host_words(residues, mods) -> tuple[np.ndarray, np.ndarray]:
    """[L, N] residues (a tensor on any device, or an array) and the moduli
    as contiguous uint32 host arrays."""
    if hasattr(residues, "detach"):
        residues = residues.detach().cpu().numpy()
    res = np.ascontiguousarray(np.asarray(residues).astype(np.int64).astype(np.uint32))
    m = np.ascontiguousarray(np.asarray(mods, dtype=np.uint64).astype(np.uint32))
    if res.ndim != 2 or res.shape[0] != m.shape[0]:
        raise ValueError(f"residues {res.shape} do not match {m.shape[0]} moduli")
    return res, m


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crt_center_mod(residues, mods, t: int) -> np.ndarray:
    """[L, N] residues -> centered(x) mod t as int64 [N]."""
    res, m = _host_words(residues, mods)
    L, N = res.shape
    out = np.empty(N, dtype=np.int64)
    get_lib().crt_center_mod(_p(res, ctypes.c_uint32), _p(m, ctypes.c_uint32), L, N, t,
                             _p(out, ctypes.c_int64))
    return out


def crt_center_double(residues, mods) -> np.ndarray:
    """[L, N] residues -> centered(x) as float64 [N]."""
    res, m = _host_words(residues, mods)
    L, N = res.shape
    out = np.empty(N, dtype=np.float64)
    get_lib().crt_center_double(_p(res, ctypes.c_uint32), _p(m, ctypes.c_uint32), L, N,
                                _p(out, ctypes.c_double))
    return out


def crt_scale_round_mod(residues, mods, t: int) -> np.ndarray:
    """[L, N] residues -> round(t x / Q) mod t as int64 [N]."""
    res, m = _host_words(residues, mods)
    L, N = res.shape
    out = np.empty(N, dtype=np.int64)
    get_lib().crt_scale_round_mod(_p(res, ctypes.c_uint32), _p(m, ctypes.c_uint32), L, N, t,
                                  _p(out, ctypes.c_int64))
    return out


def signed_to_residues(coeffs, mods) -> np.ndarray:
    """int64 [N] signed coefficients -> [L, N] uint32 residues."""
    c = np.ascontiguousarray(np.asarray(coeffs, dtype=np.int64))
    m = np.ascontiguousarray(np.asarray(mods, dtype=np.uint64).astype(np.uint32))
    out = np.empty((m.shape[0], c.shape[0]), dtype=np.uint32)
    get_lib().signed_to_residues(_p(c, ctypes.c_int64), _p(m, ctypes.c_uint32), m.shape[0],
                                 c.shape[0], _p(out, ctypes.c_uint32))
    return out
