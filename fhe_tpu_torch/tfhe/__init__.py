"""TFHE/FHEW layer: LWE, RGSW, gate bootstrapping (GINX/CGGI, AP/DM and
LMKCDEY accumulators; GINX on the 2-limb RNS ring)."""

from .params import TfheParams, Method, Gate, KeyDist, make_params, PARAM_SETS
from .context import BinFheContext
from .acc import DmKey, LmkcdeyKey
from .rgsw_rns import RnsKey
from . import lwe, rgsw, rgsw_rns, boot, boot_pallas, acc

__all__ = ["TfheParams", "Method", "Gate", "KeyDist", "make_params",
           "PARAM_SETS", "BinFheContext", "DmKey", "LmkcdeyKey", "RnsKey", "lwe",
           "rgsw", "rgsw_rns", "boot", "boot_pallas", "acc"]
