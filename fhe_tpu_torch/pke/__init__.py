"""Public-key RNS schemes: parameters, the RLWE core with HYBRID key
switching, and CKKS (ports of fhe_tpu/pke/params.py, rlwe.py, ckks.py)."""

from . import ckks, params, rlwe
from .ckks import CkksContext

__all__ = ["CkksContext", "ckks", "params", "rlwe"]
