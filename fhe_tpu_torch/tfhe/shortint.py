"""ShortInt: encrypted small integers, the radix limb type.

Port of fhe_tpu/tfhe/shortint.py (reference: radix/shortint.h,
ShortIntParams with message_bits + carry_bits of plaintext headroom and
the packed two-operand ShortIntLUTs).  A ShortInt value is a batched
LweCiphertext at plaintext modulus p = 2^(message + carry); a two-operand
op packs x = a + b 2^m and evaluates one LUT over Z_{2^2m} with one
batched functional bootstrap, whose batch axis carries every limb of every
integer in flight.  The LUTs are host numpy, as in `funcboot`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..math.modmath import add_mod
from . import funcboot, lwe, rgsw
from .params import TfheParams


@dataclasses.dataclass(frozen=True)
class ShortIntParams:
    message_bits: int = 2
    carry_bits: int = 2

    @property
    def p(self) -> int:
        """Full plaintext modulus (message + carry space)."""
        return 1 << (self.message_bits + self.carry_bits)

    @property
    def msg_mod(self) -> int:
        return 1 << self.message_bits


def _packed_lut(params: TfheParams, sp: ShortIntParams, f) -> np.ndarray:
    """LUT over Z_q for a packed pair x = a + b 2^m: the value f(a, b) mod
    p.  Both operands must be carry-free (in [0, 2^m))."""
    m = sp.msg_mod
    p = sp.p
    assert m * m <= p, "packed LUT needs message^2 <= plaintext space"

    def g(x, pp):
        a, b = x % m, (x // m) % m
        return int(f(a, b)) % p
    return funcboot.generate_lut(g, p, params.q)


def _unary_lut(params: TfheParams, sp: ShortIntParams, f) -> np.ndarray:
    p = sp.p
    return funcboot.generate_lut(lambda x, pp: int(f(x)) % p, p, params.q)


@functools.lru_cache(maxsize=None)
def luts(params: TfheParams, sp: ShortIntParams) -> dict:
    """The ShortIntLUTs table (shortint.h:38-70), keyed by op name."""
    m = sp.msg_mod
    return {
        # packed binary ops f(a, b)
        "mul_lo": _packed_lut(params, sp, lambda a, b: (a * b) % m),
        "mul_hi": _packed_lut(params, sp, lambda a, b: (a * b) // m),
        "lt": _packed_lut(params, sp, lambda a, b: int(a < b)),
        "le": _packed_lut(params, sp, lambda a, b: int(a <= b)),
        "gt": _packed_lut(params, sp, lambda a, b: int(a > b)),
        "ge": _packed_lut(params, sp, lambda a, b: int(a >= b)),
        "eq": _packed_lut(params, sp, lambda a, b: int(a == b)),
        "ne": _packed_lut(params, sp, lambda a, b: int(a != b)),
        "and": _packed_lut(params, sp, lambda a, b: a & b),
        "or": _packed_lut(params, sp, lambda a, b: a | b),
        "xor": _packed_lut(params, sp, lambda a, b: a ^ b),
        # unary ops over the full (message + carry) value
        "identity": _unary_lut(params, sp, lambda x: x % m),
        "msg": _unary_lut(params, sp, lambda x: x % m),
        "carry": _unary_lut(params, sp, lambda x: x // m),
        "not": _unary_lut(params, sp, lambda x: (m - 1) - (x % m)),
        "nonzero": _unary_lut(params, sp, lambda x: int(x % m != 0)),
    }


def encrypt(params: TfheParams, sp: ShortIntParams, sk: lwe.LweSecretKey, vals,
            rng: np.random.Generator) -> lwe.LweCiphertext:
    """Encrypt limb values (any batch shape) at plaintext modulus p."""
    return lwe.encrypt(params, sk, np.asarray(vals), rng, p=sp.p)


def decrypt(params: TfheParams, sp: ShortIntParams, sk: lwe.LweSecretKey,
            ct: lwe.LweCiphertext) -> np.ndarray:
    return lwe.decrypt(params, sk, ct, p=sp.p).cpu().numpy()


def pack(sp: ShortIntParams, a: lwe.LweCiphertext,
         b: lwe.LweCiphertext) -> lwe.LweCiphertext:
    """x = a + b 2^m: b's encoding scaled by the message base.  The gate
    modulus is a power of two, so the scaling is a multiply and a mask."""
    q = a.modulus
    assert q & (q - 1) == 0
    m = sp.msg_mod

    def scaled(x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.int64) * m) & (q - 1)
    return lwe.LweCiphertext(a=add_mod(a.a, scaled(b.a), q).to(torch.int32),
                             b=add_mod(a.b, scaled(b.b), q).to(torch.int32),
                             modulus=q, pt_mod=a.pt_mod)


def apply_lut(params: TfheParams, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
              lut: np.ndarray, sp: ShortIntParams,
              ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """One batched functional bootstrap through a ShortInt LUT."""
    out = funcboot.eval_func(params, key, ct, lut, ntt_impl=ntt_impl)
    return lwe.LweCiphertext(a=out.a, b=out.b, modulus=out.modulus, pt_mod=sp.p)


def binary_op(params: TfheParams, key: rgsw.BootstrapKey, op: str, a: lwe.LweCiphertext,
              b: lwe.LweCiphertext, sp: ShortIntParams,
              ntt_impl: str | None = None) -> lwe.LweCiphertext:
    """Packed two-operand LUT op (operands must be carry-free)."""
    return apply_lut(params, key, pack(sp, a, b), luts(params, sp)[op], sp, ntt_impl)
