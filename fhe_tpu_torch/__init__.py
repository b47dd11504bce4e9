"""PyTorch/CUDA port of fhe_tpu.

Mirrors the layout of `fhe_tpu` module by module (`math/ntt.py` ports
`fhe_tpu/math/ntt.py`, and so on).  Plain tensor code is PyTorch; the
TPU's Pallas kernels on the ported path are hand-written CUDA kernels for
Hopper (`csrc/`, bound through `kernels/`).  Nothing here imports jax or
fhe_tpu: `fhe_tpu` is the reference the tests hold this package against.

Residues are stored as `torch.int32` (every modulus on the path is below
2^31); the plain PyTorch versions compute in int64 and the kernels
reinterpret the words as uint32.  Archives (`utils.serial`) use fhe_tpu's
wire format, so either package reads the other's keys and ciphertexts.
The host-side layers sit beside the compute path: `utils` (serialization,
constant-time helpers, profiling), `native` (the C++ CRT codec, the C
client and the lux_fhe_* C API, built with g++ at first use), `server`
(the REST service) and `cli`.
"""

from . import convert, lattice, math, parallel, pke, tfhe
from .pke import BfvContext, BgvContext, CkksContext
from .tfhe import BinFheContext, Gate, Method, make_params

__all__ = ["BfvContext", "BgvContext", "BinFheContext", "CkksContext", "Gate", "Method", "make_params", "convert",
           "lattice", "math", "parallel", "pke", "tfhe"]
