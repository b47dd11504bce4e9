"""TFHE/FHEW layer: LWE, RGSW, gate bootstrapping (GINX/CGGI, AP/DM and
LMKCDEY accumulators)."""

from .params import TfheParams, Method, Gate, KeyDist, make_params, PARAM_SETS
from .context import BinFheContext
from .acc import DmKey, LmkcdeyKey
from . import lwe, rgsw, boot, boot_pallas, acc

__all__ = ["TfheParams", "Method", "Gate", "KeyDist", "make_params",
           "PARAM_SETS", "BinFheContext", "DmKey", "LmkcdeyKey", "lwe", "rgsw",
           "boot", "boot_pallas", "acc"]
