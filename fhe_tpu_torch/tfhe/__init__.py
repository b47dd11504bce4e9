"""TFHE/FHEW layer: LWE (with public-key mode), RGSW, gate bootstrapping
(GINX/CGGI, AP/DM and LMKCDEY accumulators; GINX on the 2-limb RNS ring),
functional bootstrapping (`funcboot`), and the encrypted integers on it:
ShortInt limbs (`shortint`), radix integers (`radix`) and the fhEVM types
and ops (`fhevm`); threshold decryption with proofs (`threshold`, on the
Fiat-Shamir transcripts and Merkle trees of `transcript`), computation
witnesses (`zkp`) and the packed wire formats (`packed`)."""

from .params import TfheParams, Method, Gate, KeyDist, make_params, PARAM_SETS
from .context import BinFheContext
from .acc import DmKey, LmkcdeyKey
from .rgsw_rns import RnsKey
from .lwe import LwePublicKey
from .fhevm import EncryptedInt, FheContext, FheType
from .radix import RadixInt, RadixParams
from .shortint import ShortIntParams
from . import lwe, rgsw, rgsw_rns, boot, boot_pallas, acc, funcboot, shortint, radix, fhevm
from . import packed, threshold, transcript, zkp

__all__ = ["TfheParams", "Method", "Gate", "KeyDist", "make_params",
           "PARAM_SETS", "BinFheContext", "DmKey", "LmkcdeyKey", "RnsKey", "LwePublicKey",
           "EncryptedInt", "FheContext", "FheType", "RadixInt", "RadixParams",
           "ShortIntParams", "lwe", "rgsw", "rgsw_rns", "boot", "boot_pallas", "acc",
           "funcboot", "shortint", "radix", "fhevm", "packed", "threshold", "transcript", "zkp"]
