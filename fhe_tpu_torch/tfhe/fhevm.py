"""fhEVM: EVM-compatible encrypted integer types and operations.

Port of fhe_tpu/tfhe/fhevm.py (reference: fhevm/fhevm.h, FheType
euint4..euint256 / eaddress / ebool :35-49 and the arithmetic,
comparison, bitwise, select, cast and trivial-encrypt surface :3-13,
built on RadixInt and the ShortIntLUTs, lib/fhevm/fhevm.cpp:60-150).

The context wraps a BinFheContext of the radix parameter set (TOY_RADIX:
plaintext space 16 = 2-bit message x 2-bit carry limbs) with its keys on
the context's device (the first CUDA card unless the caller names another);
every op delegates to the batched radix engine with the context's
`ntt_impl`.  `get_proof` / `verify_proof` are fhe_tpu's hash commitment
to the ciphertext's uint32 words (tfhe/zkp.py `commit`).  Ciphertexts
and keys serialise through utils/serial on fhe_tpu's wire format: the
archive of an EncryptedInt is byte-identical to fhe_tpu's for the same
values, and `deserialize_ciphertext` reads either package's archive onto
the context's device.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import lwe, radix, rgsw, zkp
from .context import BinFheContext, _rng
from .radix import RadixParams


class FheType(enum.Enum):
    EBOOL = "ebool"
    EUINT4 = "euint4"
    EUINT8 = "euint8"
    EUINT16 = "euint16"
    EUINT32 = "euint32"
    EUINT64 = "euint64"
    EUINT128 = "euint128"
    EUINT256 = "euint256"
    EADDRESS = "eaddress"


TYPE_PARAMS: dict[FheType, RadixParams] = {
    FheType.EBOOL: radix.EBOOL,
    FheType.EUINT4: radix.EUINT4,
    FheType.EUINT8: radix.EUINT8,
    FheType.EUINT16: radix.EUINT16,
    FheType.EUINT32: radix.EUINT32,
    FheType.EUINT64: radix.EUINT64,
    FheType.EUINT128: radix.EUINT128,
    FheType.EUINT256: radix.EUINT256,
    FheType.EADDRESS: radix.EADDRESS,
}


def fhe_type_bits(t: FheType) -> int:
    """fhevm.h FheTypeBits:48."""
    return TYPE_PARAMS[t].total_bits


def fhe_type_name(t: FheType) -> str:
    """fhevm.h FheTypeName:51."""
    return t.value


VERSION = "1.4.2"      # c_api.cpp version string parity

# A rough EVM gas schedule, dominated by the PBS count (fhevm.h EstimateGas).
_GAS_PER_PBS = 65_000
_OP_PBS = {
    "add": 2, "sub": 3, "mul": 8, "div": 40, "rem": 40,
    "eq": 3, "ne": 3, "lt": 4, "le": 4, "gt": 4, "ge": 4,
    "min": 8, "max": 8, "and": 1, "or": 1, "xor": 1, "not": 1,
    "shl": 4, "shr": 4, "rotl": 4, "rotr": 4, "select": 4, "cast": 0,
    "neg": 4, "is_zero": 3,
}


def estimate_gas(op: str, t: FheType) -> int:
    """fhevm.h EstimateGas:564: the PBS-count model scaled by limb count."""
    L = TYPE_PARAMS[t].num_limbs
    return _OP_PBS.get(op, 4) * max(1, L // 2) * _GAS_PER_PBS


def version() -> str:
    return VERSION


@dataclasses.dataclass
class EncryptedInt:
    """A typed handle over a RadixInt (fhevm.h's euintN)."""
    value: radix.RadixInt
    fhe_type: FheType


@dataclasses.dataclass
class FheContext:
    """fhevm.cpp FheContext: a BinFHE context and its bootstrap key, fixed
    to the radix parameter profile."""
    ctx: BinFheContext
    key: rgsw.BootstrapKey | None = None
    sk: lwe.LweSecretKey | None = None
    sk_n: lwe.LweSecretKey | None = None
    pk: lwe.LwePublicKey | None = None

    @classmethod
    def create(cls, param_set: str = "TOY_RADIX", rng: np.random.Generator | int = 0,
               device: str | torch.device = "cuda") -> "FheContext":
        """The context of `param_set` on `device`, keyed from rng."""
        return cls.keyed(BinFheContext.generate(param_set, device=device), rng)

    @classmethod
    def keyed(cls, ctx: BinFheContext, rng: np.random.Generator | int = 0) -> "FheContext":
        """A context over ctx (any parameters, device and ntt_impl) with
        sk, sk_n and the bootstrap key drawn from rng in fhe_tpu's order."""
        rng = _rng(rng)
        sk = ctx.key_gen(rng)
        sk_n = ctx.key_gen_n(rng)
        key = ctx.bt_key_gen(sk, rng, sk_n=sk_n)
        return cls(ctx=ctx, key=key, sk=sk, sk_n=sk_n)

    def public_key_gen(self, rng: np.random.Generator | int = 0) -> lwe.LwePublicKey:
        """fhevm.h PublicKeyGen: the LWE public key over the ring dimension,
        tied to the bootstrap key's switching key."""
        self.pk = lwe.pub_key_gen(self.params, self.sk_n, _rng(rng))
        return self.pk

    @property
    def params(self):
        return self.ctx.params

    @property
    def ntt_impl(self) -> str | None:
        return self.ctx.ntt_impl

    # -- encryption ---------------------------------------------------------
    def encrypt(self, values, fhe_type: FheType,
                rng: np.random.Generator | int = 0) -> EncryptedInt:
        rp = TYPE_PARAMS[fhe_type]
        return EncryptedInt(radix.encrypt(self.params, rp, self.sk, values, _rng(rng)), fhe_type)

    def trivial_encrypt(self, values, fhe_type: FheType) -> EncryptedInt:
        rp = TYPE_PARAMS[fhe_type]
        return EncryptedInt(radix.trivial_encrypt(self.params, rp, values, self.ctx.device),
                            fhe_type)

    def encrypt_public(self, values, fhe_type: FheType,
                       rng: np.random.Generator | int = 0) -> EncryptedInt:
        """fhevm.h EncryptPublic:133: public-key limb encryption."""
        if self.pk is None:
            raise ValueError("call public_key_gen first")
        rp = TYPE_PARAMS[fhe_type]
        return EncryptedInt(radix.encrypt_pk(self.params, rp, self.pk, self.key.ksk, values,
                                             _rng(rng)), fhe_type)

    def encrypt_bytes(self, data: bytes, fhe_type: FheType,
                      rng: np.random.Generator | int = 0) -> EncryptedInt:
        """fhevm.h EncryptBytes:121: big-endian bytes."""
        return self.encrypt(int.from_bytes(data, "big"), fhe_type, rng)

    def trivial_encrypt_bytes(self, data: bytes, fhe_type: FheType) -> EncryptedInt:
        return self.trivial_encrypt(int.from_bytes(data, "big"), fhe_type)

    def decrypt(self, x: EncryptedInt):
        return radix.decrypt(self.params, x.value.rp, self.sk, x.value)

    def decrypt_bytes(self, x: EncryptedInt) -> bytes:
        """fhevm.h DecryptBytes:162: big-endian, the type's width in bytes."""
        v = self.decrypt(x)
        nbytes = (TYPE_PARAMS[x.fhe_type].total_bits + 7) // 8
        return int(v.reshape(-1)[0]).to_bytes(nbytes, "big")

    # -- arithmetic ---------------------------------------------------------
    def add(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.add(self.params, self.key, a.value, b.value, self.ntt_impl),
                            a.fhe_type)

    def sub(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.sub(self.params, self.key, a.value, b.value, self.ntt_impl),
                            a.fhe_type)

    def mul(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.mul(self.params, self.key, a.value, b.value, self.ntt_impl),
                            a.fhe_type)

    def div(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        """Division by an encrypted divisor (fhevm.h:8; restoring long
        division, the quotient)."""
        q, _ = radix.divrem(self.params, self.key, a.value, b.value, self.ntt_impl)
        return EncryptedInt(q, a.fhe_type)

    def rem(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        _, r = radix.divrem(self.params, self.key, a.value, b.value, self.ntt_impl)
        return EncryptedInt(r, a.fhe_type)

    def neg(self, a: EncryptedInt) -> EncryptedInt:
        """Two's-complement negation (fhevm.h Neg:197)."""
        return EncryptedInt(radix.neg(self.params, self.key, a.value, self.ntt_impl), a.fhe_type)

    # -- scalar-operand variants (fhevm.h *Scalar) ----------------------------
    def add_scalar(self, a: EncryptedInt, s: int) -> EncryptedInt:
        return EncryptedInt(radix.add_scalar(self.params, self.key, a.value, s, self.ntt_impl),
                            a.fhe_type)

    def sub_scalar(self, a: EncryptedInt, s: int) -> EncryptedInt:
        return EncryptedInt(radix.sub_scalar(self.params, self.key, a.value, s, self.ntt_impl),
                            a.fhe_type)

    def mul_scalar(self, a: EncryptedInt, s: int) -> EncryptedInt:
        return EncryptedInt(radix.mul_scalar(self.params, self.key, a.value, s, self.ntt_impl),
                            a.fhe_type)

    def div_scalar(self, a: EncryptedInt, s: int) -> EncryptedInt:
        return EncryptedInt(radix.div_scalar(self.params, self.key, a.value, s, self.ntt_impl),
                            a.fhe_type)

    def rem_scalar(self, a: EncryptedInt, s: int) -> EncryptedInt:
        return EncryptedInt(radix.rem_scalar(self.params, self.key, a.value, s, self.ntt_impl),
                            a.fhe_type)

    def _cmp_scalar(self, op: str, a: EncryptedInt, s: int) -> lwe.LweCiphertext:
        return radix.compare_scalar(self.params, self.key, op, a.value, s, self.ntt_impl)

    def eq_scalar(self, a, s): return self._cmp_scalar("eq", a, s)
    def ne_scalar(self, a, s): return self._cmp_scalar("ne", a, s)
    def lt_scalar(self, a, s): return self._cmp_scalar("lt", a, s)
    def le_scalar(self, a, s): return self._cmp_scalar("le", a, s)
    def gt_scalar(self, a, s): return self._cmp_scalar("gt", a, s)
    def ge_scalar(self, a, s): return self._cmp_scalar("ge", a, s)

    def _bitwise_scalar(self, op: str, a: EncryptedInt, s: int) -> EncryptedInt:
        return EncryptedInt(radix.bitwise_scalar(self.params, self.key, op, a.value, s,
                                                 self.ntt_impl), a.fhe_type)

    def and_scalar(self, a, s): return self._bitwise_scalar("and", a, s)
    def or_scalar(self, a, s): return self._bitwise_scalar("or", a, s)
    def xor_scalar(self, a, s): return self._bitwise_scalar("xor", a, s)

    def min(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.min_(self.params, self.key, a.value, b.value, self.ntt_impl),
                            a.fhe_type)

    def max(self, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.max_(self.params, self.key, a.value, b.value, self.ntt_impl),
                            a.fhe_type)

    # -- shifts and rotations (fhevm.h:10; plaintext or encrypted amounts) ---
    def _shift(self, a: EncryptedInt, k, left: bool, rotate: bool) -> EncryptedInt:
        if isinstance(k, EncryptedInt):
            fn = radix.shift_left_enc if left else radix.shift_right_enc
            k = k.value
        else:
            fn = radix.shift_left if left else radix.shift_right
        return EncryptedInt(fn(self.params, self.key, a.value, k, self.ntt_impl, rotate=rotate),
                            a.fhe_type)

    def shl(self, a, k): return self._shift(a, k, left=True, rotate=False)
    def shr(self, a, k): return self._shift(a, k, left=False, rotate=False)
    def rotl(self, a, k): return self._shift(a, k, left=True, rotate=True)
    def rotr(self, a, k): return self._shift(a, k, left=False, rotate=True)

    # -- comparison (an ebool LWE bit) ----------------------------------------
    def _cmp(self, op: str, a: EncryptedInt, b: EncryptedInt) -> lwe.LweCiphertext:
        return radix.compare(self.params, self.key, op, a.value, b.value, self.ntt_impl)

    def eq(self, a, b): return self._cmp("eq", a, b)
    def ne(self, a, b): return self._cmp("ne", a, b)
    def lt(self, a, b): return self._cmp("lt", a, b)
    def le(self, a, b): return self._cmp("le", a, b)
    def gt(self, a, b): return self._cmp("gt", a, b)
    def ge(self, a, b): return self._cmp("ge", a, b)

    def decrypt_bool(self, bit: lwe.LweCiphertext) -> np.ndarray:
        p = TYPE_PARAMS[FheType.EBOOL].limb.p
        return lwe.decrypt(self.params, self.sk, bit, p=p).cpu().numpy() & 1

    # -- bitwise ----------------------------------------------------------------
    def _bitwise(self, op: str, a: EncryptedInt, b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.bitwise(self.params, self.key, op, a.value, b.value,
                                          self.ntt_impl), a.fhe_type)

    def and_(self, a, b): return self._bitwise("and", a, b)
    def or_(self, a, b): return self._bitwise("or", a, b)
    def xor(self, a, b): return self._bitwise("xor", a, b)

    def not_(self, a: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.bit_not(self.params, self.key, a.value, self.ntt_impl),
                            a.fhe_type)

    # -- control ----------------------------------------------------------------
    def select(self, cond: lwe.LweCiphertext, a: EncryptedInt,
               b: EncryptedInt) -> EncryptedInt:
        return EncryptedInt(radix.select(self.params, self.key, cond, a.value, b.value,
                                         self.ntt_impl), a.fhe_type)

    def if_then_else(self, cond: EncryptedInt, a: EncryptedInt,
                     b: EncryptedInt) -> EncryptedInt:
        """fhevm.h IfThenElse:379: an ebool-typed condition."""
        c = cond.value.ct
        bit = lwe.LweCiphertext(a=c.a[..., 0, :], b=c.b[..., 0], modulus=c.modulus,
                                pt_mod=c.pt_mod)
        return self.select(bit, a, b)

    def is_zero(self, a: EncryptedInt) -> lwe.LweCiphertext:
        """fhevm.h IsZero:389."""
        return radix.is_zero(self.params, self.key, a.value, self.ntt_impl)

    def is_nonzero(self, a: EncryptedInt) -> lwe.LweCiphertext:
        return radix.is_nonzero(self.params, self.key, a.value, self.ntt_impl)

    def cast(self, a: EncryptedInt, to: FheType) -> EncryptedInt:
        return EncryptedInt(radix.cast(self.params, a.value, TYPE_PARAMS[to]), to)

    # -- randomness (fhevm.h Random:419 / RandomRange:424) ----------------------
    def random(self, fhe_type: FheType, rng: np.random.Generator | int = 0,
               batch_shape: tuple = ()) -> EncryptedInt:
        """A host-drawn uniform value, freshly encrypted (the on-chain
        flavour; the reference does the same, fhevm.cpp:453-466)."""
        rng = _rng(rng)
        rp = TYPE_PARAMS[fhe_type]
        nbytes = (rp.total_bits + 7) // 8
        raw = rng.bytes(int(np.prod(batch_shape, dtype=int)) * nbytes
                        if batch_shape else nbytes)
        vals = np.empty(batch_shape or (), dtype=object)
        if batch_shape:
            flat = vals.reshape(-1)
            for i in range(flat.shape[0]):
                flat[i] = int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "big") & rp.max_value
        else:
            vals[()] = int.from_bytes(raw, "big") & rp.max_value
        return self.encrypt(vals, fhe_type, rng)

    def random_range(self, fhe_type: FheType, max_value: int,
                     rng: np.random.Generator | int = 0) -> EncryptedInt:
        r = self.random(fhe_type, rng)
        return self.rem(r, self.trivial_encrypt(max_value, fhe_type))

    # -- serialisation (fhevm.h:433-471) ------------------------------------------
    def serialize_ciphertext(self, x: EncryptedInt) -> bytes:
        from ..utils import serial
        return serial.dumps(x)

    def deserialize_ciphertext(self, data: bytes) -> EncryptedInt:
        """The ciphertext on the context's device (fhe_tpu's archives too)."""
        from ..utils import serial
        return serial.loads(data, device=self.ctx.device)

    def serialize_secret_key(self) -> bytes:
        from ..utils import serial
        return serial.dumps(self.sk)

    def serialize_bootstrap_key(self) -> bytes:
        from ..utils import serial
        return serial.dumps(self.key)

    # -- verification (fhevm.h Verify:480 / GetProof:485) -------------------------
    def verify(self, x: EncryptedInt) -> bool:
        """Well-formedness: shapes, moduli, limb counts."""
        ct = x.value.ct
        rp = x.value.rp
        return (ct.a.shape[-1] == self.params.n and ct.a.shape[-2] == rp.num_limbs
                and ct.b.shape[-1] == rp.num_limbs and ct.modulus == self.params.q)

    def get_proof(self, x: EncryptedInt) -> bytes:
        """Hash commitment to the ciphertext's bytes (the reference's
        GetProof is an empty placeholder, fhevm.cpp:497-500; this binds the
        ciphertext through zkp.commit): a's then b's residues as uint32
        words, fhe_tpu's bytes, under 32 zero bytes of randomness."""
        ct = x.value.ct
        blob = (ct.a.cpu().numpy().astype(np.uint32).tobytes()
                + ct.b.cpu().numpy().astype(np.uint32).tobytes())
        return zkp.commit(blob, b"\x00" * 32).value

    def verify_proof(self, x: EncryptedInt, proof: bytes) -> bool:
        return self.verify(x) and proof == self.get_proof(x)
