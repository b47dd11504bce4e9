"""Public-key RNS schemes: parameters, the RLWE core with HYBRID and BV
key switching, CKKS, BGV, BFV and the coefficient encodings, multiparty
threshold decryption and joint keys, proxy re-encryption, advanced SHE and
CKKS bootstrapping, functional bootstrapping and CKKS<->FHEW scheme
switching, and the per-tag evaluation-key caches (ports of
fhe_tpu/pke/params.py, rlwe.py, ckks.py, bgv.py, bfv.py, encodings.py,
multiparty.py, pre.py, advanced.py, bootstrap.py, fbt.py, schemeswitch.py,
keycache.py)."""

from . import (advanced, bfv, bgv, bootstrap, ckks, encodings, fbt, keycache, multiparty, params,
               pre, rlwe, schemeswitch)
from .bfv import BfvContext
from .bgv import BgvContext
from .ckks import CkksContext

__all__ = ["BfvContext", "BgvContext", "CkksContext", "advanced", "bfv", "bgv", "bootstrap", "ckks",
           "encodings", "fbt", "keycache", "multiparty", "params", "pre", "rlwe", "schemeswitch"]
