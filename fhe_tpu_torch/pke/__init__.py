"""Public-key RNS schemes: parameters, the RLWE core with HYBRID and BV
key switching, CKKS, BGV, BFV and the coefficient encodings (ports of
fhe_tpu/pke/params.py, rlwe.py, ckks.py, bgv.py, bfv.py, encodings.py)."""

from . import bfv, bgv, ckks, encodings, params, rlwe
from .bfv import BfvContext
from .bgv import BgvContext
from .ckks import CkksContext

__all__ = ["BfvContext", "BgvContext", "CkksContext", "bfv", "bgv", "ckks", "encodings",
           "params", "rlwe"]
