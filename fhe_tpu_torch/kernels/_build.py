"""Build and load the package's CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` for Hopper (`sm_90a`) into ONE
shared library with a plain C interface, loaded with `ctypes`.  Each
translation unit is compiled by its own `nvcc`, all started together:
`ntt.cu` and `blind_rotate.cu` (the C entry points), `ntt_inst.cu` once per
N of `csrc/ntt_shapes.h` (`-DFHE_NTT_LOGN=..`), `ntt_small.cu` once for
that file's small N, and `blind_rotate_inst.cu`
once per shape of `csrc/cggi_shapes.h` (`-DFHE_INST_LOGN=..
-DFHE_INST_DG2=..`); one more `nvcc` links them.  The build runs at first
use, into `fhe_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads the cached
library.

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
import re
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32

# entry point -> argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    "fhe_ntt_forward": (_P, _P, _P, _P, _I, _I, _U, _I, _I, _P),
    "fhe_ntt_inverse": (_P, _P, _P, _P, _I, _I, _U, _U, _U, _U, _U, _I, _P),
    "fhe_ntt_forward_limbs": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P),
    "fhe_ntt_inverse_limbs": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P),
    "fhe_ntt_rows_per_block": (_I,),
    "fhe_cggi_scan": (_P,) * 9 + (_I,) * 8 + (_U,) * 7 + (_P,),
    "fhe_cggi_steps": (_P,) * 10 + (_I,) * 7 + (_U,) * 7 + (_P,),
    "fhe_cggi_occupancy": (_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)),
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
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))


@functools.lru_cache(maxsize=None)
def shapes() -> tuple[tuple[int, int], ...]:
    """The (N, dG2) shapes the blind-rotation kernels are instantiated for,
    from `csrc/cggi_shapes.h` (no build needed)."""
    text = (CSRC / "cggi_shapes.h").read_text()
    return tuple((1 << int(log_n), int(dg2))
                 for log_n, dg2 in re.findall(r"X\((\d+),\s*(\d+)\)", text))


def _macro_list(text: str, macro: str) -> tuple[int, ...]:
    """The X(..) arguments of `#define macro(X)`, up to its last line."""
    body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)", text).group(1)
    return tuple(int(v) for v in re.findall(r"X\((\d+)\)", body))


@functools.lru_cache(maxsize=None)
def ntt_large_sizes() -> tuple[int, ...]:
    """The N of the NTT kernels of `csrc/ntt.cuh` (single-modulus and
    limb-stacked), from `csrc/ntt_shapes.h` FHE_NTT_SHAPES (no build needed)."""
    text = (CSRC / "ntt_shapes.h").read_text()
    return tuple(1 << v for v in _macro_list(text, "FHE_NTT_SHAPES"))


@functools.lru_cache(maxsize=None)
def ntt_small_sizes() -> tuple[int, ...]:
    """The N of the small-N kernels of `csrc/ntt_small.cu` (single-modulus),
    from `csrc/ntt_shapes.h` FHE_NTT_SMALL_SHAPES (no build needed)."""
    text = (CSRC / "ntt_shapes.h").read_text()
    return tuple(1 << v for v in _macro_list(text, "FHE_NTT_SMALL_SHAPES"))


@functools.lru_cache(maxsize=None)
def ntt_sizes() -> tuple[int, ...]:
    """Every N a single-modulus NTT kernel is instantiated for, ascending."""
    return tuple(sorted(ntt_small_sizes() + ntt_large_sizes()))


@functools.lru_cache(maxsize=None)
def wide_n() -> int:
    """The N from which the blind-rotation kernels run the wide step (one
    ciphertext a block), from `csrc/cggi_launch.h` (no build needed)."""
    text = (CSRC / "cggi_launch.h").read_text()
    return 1 << int(re.search(r"constexpr int kWideLogN = (\d+);", text).group(1))


@functools.lru_cache(maxsize=None)
def max_limbs() -> int:
    """The most limbs a limb-stacked NTT launch takes, from
    `csrc/ntt_launch.h` (no build needed)."""
    text = (CSRC / "ntt_launch.h").read_text()
    return int(re.search(r"constexpr int kMaxLimbs = (\d+);", text).group(1))


def units() -> list[tuple[str, Path, tuple[str, ...]]]:
    """(object name, source, extra nvcc flags) of every translation unit."""
    out = [("ntt", CSRC / "ntt.cu", ()), ("blind_rotate", CSRC / "blind_rotate.cu", ()),
           ("ntt_small", CSRC / "ntt_small.cu", ())]
    for N in ntt_large_sizes():
        out.append((f"ntt_n{N}", CSRC / "ntt_inst.cu", (f"-DFHE_NTT_LOGN={N.bit_length() - 1}",)))
    for N, dg2 in shapes():
        out.append((f"cggi_n{N}_dg{dg2}", CSRC / "blind_rotate_inst.cu",
                    (f"-DFHE_INST_LOGN={N.bit_length() - 1}", f"-DFHE_INST_DG2={dg2}")))
    return out


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for name, _, flags in units():
        h.update(f"{name} {' '.join(flags)}".encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> tuple[Path, str]:
    """Compiles every unit (one nvcc each, all at once) and links them into
    a temporary library in out_dir; returns it and the nvcc output."""
    procs = []
    for name, src, flags in units():
        obj = out_dir / f"{name}.o"
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
        procs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    link = [nvcc(), "-shared", "-o", tmp, *[str(obj) for _, obj, _ in procs]]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return Path(tmp), log


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (if needed) and load the kernel library; raises on failure."""
    t0 = time.perf_counter()
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / LIB_NAME
    log, built = "", False
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp, log = _compile(out_dir)
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
