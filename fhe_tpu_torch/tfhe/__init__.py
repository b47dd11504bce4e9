"""TFHE/FHEW layer: LWE (with public-key mode), RGSW, gate bootstrapping
(GINX/CGGI, AP/DM and LMKCDEY accumulators; GINX on the 2-limb RNS ring)
and functional bootstrapping (`funcboot`)."""

from .params import TfheParams, Method, Gate, KeyDist, make_params, PARAM_SETS
from .context import BinFheContext
from .acc import DmKey, LmkcdeyKey
from .rgsw_rns import RnsKey
from .lwe import LwePublicKey
from . import lwe, rgsw, rgsw_rns, boot, boot_pallas, acc, funcboot

__all__ = ["TfheParams", "Method", "Gate", "KeyDist", "make_params",
           "PARAM_SETS", "BinFheContext", "DmKey", "LmkcdeyKey", "RnsKey", "LwePublicKey",
           "lwe", "rgsw", "rgsw_rns", "boot", "boot_pallas", "acc", "funcboot"]
