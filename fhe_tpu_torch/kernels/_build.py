"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into ONE
shared library with a plain C interface, loaded with `ctypes`.  The build
runs at first use, into `fhe_tpu_torch/_build/<hash>/`, keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the cached library.

Every C entry point returns `cudaGetLastError()` after its launch;
`check` raises on a non-zero code, because a refused launch (too many
threads, too much shared memory) never runs and a later synchronise does
not report it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libfhe_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32

# entry point -> argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    "fhe_ntt_forward": (_P, _P, _P, _P, _I, _I, _U, _I, _P),
    "fhe_ntt_inverse": (_P, _P, _P, _P, _I, _I, _U, _U, _U, _P),
    "fhe_blind_rotate": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I,
                         _U, _U, _U, _U, _U, _U, _U, _P),
    "fhe_blind_rotate_mega": (_P,) * 10 + (_I,) * 7 + (_U,) * 5 + (_P,),
    "fhe_rotate_step_br": (_P,) * 10 + (_I,) * 8 + (_U,) * 5 + (_P,),
}


@dataclasses.dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    built: bool           # False when a cached library was loaded
    seconds: float        # build (or load) time
    log: str              # nvcc output (ptxas register / shared memory report)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (if needed) and load the kernel library; raises on failure."""
    t0 = time.perf_counter()
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / LIB_NAME
    log, built = "", False
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
        built = True
    cdll = ctypes.CDLL(str(lib_path))
    for name, args in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    cdll.fhe_error_string.argtypes = [ctypes.c_int]
    cdll.fhe_error_string.restype = ctypes.c_char_p
    return Library(cdll=cdll, path=lib_path, built=built,
                   seconds=time.perf_counter() - t0, log=log)


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().cdll.fhe_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
