"""TFHE/FHEW layer: LWE, RGSW, gate bootstrapping (GINX/CGGI)."""

from .params import TfheParams, Method, Gate, KeyDist, make_params, PARAM_SETS
from .context import BinFheContext
from . import lwe, rgsw, boot, boot_pallas

__all__ = ["TfheParams", "Method", "Gate", "KeyDist", "make_params",
           "PARAM_SETS", "BinFheContext", "lwe", "rgsw", "boot", "boot_pallas"]
