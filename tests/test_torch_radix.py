"""fhe_tpu_torch's encrypted integers (tfhe/shortint.py, radix.py and
fhevm.py) against fhe_tpu on the CPU.

Byte for byte: TOY_RADIX cut to N = q = 1024 and n = 2 in both packages
(Q, Bg and so dG2 = 10, q_ks and Bks as they are; Q = 1 mod 2N still
holds; at n = 8 the blind rotations' steps took about 10 s more), keys
from the same seeds (fhe_tpu's BSK assembly jitted, as in
test_torch_funcboot.py).  At this cut a limb's slot q/p = 64 is below the
functional bootstrap's beta = 128, so a LUT's output decrypts wrong in
both packages: these tests hold the bytes, not the values.  fhe_tpu
compiles its bootstrap once for each (ct_mod, f_mod, pt_mod) and batch
shape; here its bootstrap_func pads every call to ROWS ciphertexts (each
row is bootstrapped on its own), so the radix ops compile two: the
periodic LUTs at (q, q, 16) and the others at (2q, 2q, 16).

The values, the port alone against Python integers: what needs no
bootstrap at the cut above; what does, at N = q = 8192 (TOY_RADIX's
ring, slot 512) with n cut to 1, a few ops in tier 1 and the rest marked
slow, and two slow byte-for-byte checks against fhe_tpu at that ring:
sub and lt with n = 8, and lt at full TOY_RADIX on the rows the card
reads wrong (TOY_RADIX's noise; fhe_tpu reads them wrong too).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import BinFheContext as JContext
from fhe_tpu.tfhe import fhevm as jfhevm
from fhe_tpu.tfhe import funcboot as jfb
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import radix as jradix
from fhe_tpu.tfhe import rgsw as j_rgsw
from fhe_tpu.tfhe import shortint as jshort
from fhe_tpu.tfhe.params import make_params as j_make_params
from fhe_tpu_torch import convert
from fhe_tpu_torch.tfhe import BinFheContext, make_params, radix, shortint
from fhe_tpu_torch.tfhe.fhevm import FheContext, FheType
from fhe_tpu_torch.tfhe import fhevm

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CPU = torch.device("cpu")
ROWS = 16
SP = shortint.ShortIntParams(2, 2)


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _eq_ct(jct, tct):
    assert (jct.modulus, jct.pt_mod) == (tct.modulus, tct.pt_mod)
    _eq(jct.a, tct.a)
    _eq(jct.b, tct.b)


def _eq_int(jx, tx):
    """Two RadixInts (or EncryptedInts) hold the same bytes and budget."""
    jx, tx = getattr(jx, "value", jx), getattr(tx, "value", tx)
    assert (jx.rp.limb.message_bits, jx.rp.limb.carry_bits, jx.rp.num_limbs, jx.max_limb) == (
        tx.rp.limb.message_bits, tx.rp.limb.carry_bits, tx.rp.num_limbs, tx.max_limb)
    _eq_ct(jx.ct, tx.ct)


def _padded(bootstrap_func):
    """fhe_tpu's bootstrap_func on its ciphertexts padded to ROWS rows (the
    padding on the host, so that no shape compiles an op of its own)."""
    def run(params, key, ct, f_table, f_mod, ntt_impl=None):
        lead, n = ct.b.shape, ct.a.shape[-1]
        rows = int(np.prod(lead, dtype=int))
        assert rows <= ROWS
        a = np.zeros((ROWS, n), np.uint32)
        b = np.zeros(ROWS, np.uint32)
        a[:rows], b[:rows] = np.asarray(ct.a).reshape(rows, n), np.asarray(ct.b).reshape(rows)
        out = bootstrap_func(params, key, jlwe.LweCiphertext(jnp.asarray(a), jnp.asarray(b),
                                                             ct.modulus, ct.pt_mod),
                             f_table, f_mod, ntt_impl)
        out_a, out_b = np.asarray(out.a)[:rows], np.asarray(out.b)[:rows]
        return jlwe.LweCiphertext(jnp.asarray(out_a.reshape(*lead, out_a.shape[-1])),
                                  jnp.asarray(out_b.reshape(lead)), out.modulus, out.pt_mod)
    return run


def _contexts(N: int, n: int, seed: int):
    """fhe_tpu's and the port's FheContext at TOY_RADIX cut to N = q and n,
    keyed from one seed."""
    jp = dataclasses.replace(j_make_params("TOY_RADIX"), N=N, q=N, n=n)
    tp = dataclasses.replace(make_params("TOY_RADIX"), N=N, q=N, n=n)
    jc = JContext(params=jp)
    rng = np.random.default_rng(seed)
    bsk_device = j_rgsw._bsk_device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rgsw, "_bsk_device", lambda plan, params, *x: jax.jit(
            functools.partial(bsk_device, plan, params))(*x))
        jsk = jc.key_gen(rng)
        jsk_n = jc.key_gen_n(rng)
        jkey = jc.bt_key_gen(jsk, rng, sk_n=jsk_n)
    jfc = jfhevm.FheContext(ctx=jc, key=jkey, sk=jsk, sk_n=jsk_n)
    return jfc, FheContext.keyed(BinFheContext(params=tp, device=CPU), seed)


@pytest.fixture(scope="module")
def cut():
    """(fhe_tpu's, the port's) FheContext at N = q = 1024, n = 2, with
    fhe_tpu's bootstraps padded to ROWS rows."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "bootstrap_func", _padded(jfb.bootstrap_func))
    yield _contexts(1024, 2, 3)
    mp.undo()


def _pair(cut, values, t: FheType, seed: int):
    """The same values encrypted by both packages from one seed."""
    jx = cut[0].encrypt(values, jfhevm.FheType(t.value), seed)
    tx = cut[1].encrypt(values, t, seed)
    _eq_int(jx, tx)
    return jx, tx


def _ints(x) -> list:
    return [int(v) for v in np.asarray(x).reshape(-1)]


# -- byte for byte against fhe_tpu, N = q = 1024 --------------------------------

def test_keys_match_fhe_tpu(cut):
    (jfc, tfc) = cut
    for jarr, tens in [(jfc.sk.s, tfc.sk.s), (jfc.sk_n.s, tfc.sk_n.s), (jfc.key.bsk, tfc.key.bsk),
                       (jfc.key.ksk.a, tfc.key.ksk.a), (jfc.key.ksk.b, tfc.key.ksk.b)]:
        _eq(jarr, tens)
    assert tfc.params.digits_g2 == 10 and tfc.params.q == tfc.params.N == 1024


def test_luts_match_fhe_tpu(cut):
    """Every ShortInt LUT (host numpy), packed and unary."""
    want = jshort.luts(cut[0].params, jshort.ShortIntParams(2, 2))
    got = shortint.luts(cut[1].params, SP)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name])
    assert (SP.p, SP.msg_mod) == (16, 4)


@pytest.mark.parametrize("t", [FheType.EUINT4, FheType.EUINT64, FheType.EBOOL])
def test_encrypt_trivial_decrypt_match_fhe_tpu(t, cut):
    """FheContext.encrypt, trivial_encrypt and decrypt; a fresh encryption
    needs no bootstrap, so it decrypts to its values at this cut too
    (fhe_tpu's decrypt, eager, compiles its ops for each shape: it runs on
    the euint4 batch of 4, the other tests' shape)."""
    jfc, tfc = cut
    bits = fhevm.fhe_type_bits(t)
    vals = [int(v) for v in np.random.default_rng(bits).integers(0, 2**62, size=4)]
    vals = np.array([v & ((1 << bits) - 1) for v in vals], dtype=object)
    jx, tx = _pair(cut, vals, t, 7)
    assert _ints(tfc.decrypt(tx)) == list(vals)
    if t == FheType.EUINT4:
        assert _ints(jfc.decrypt(jx)) == list(vals)
    _eq_int(jfc.trivial_encrypt(vals, jfhevm.FheType(t.value)), tfc.trivial_encrypt(vals, t))


def test_convert_radix_int(cut):
    """An fhe_tpu RadixInt carried into the port is the port's encryption."""
    jx, tx = _pair(cut, np.arange(6).reshape(2, 3) * 37, FheType.EUINT8, 9)
    v = jx.value
    got = convert.radix_int(np.asarray(v.ct.a), np.asarray(v.ct.b), v.ct.modulus, v.ct.pt_mod,
                            v.rp.limb.message_bits, v.rp.limb.carry_bits, v.rp.num_limbs,
                            v.max_limb, device="cpu")
    assert got.rp == radix.EUINT8 and got.batch_shape == (2, 3)
    _eq_int(v, got)
    assert torch.equal(got.ct.a, tx.value.ct.a) and torch.equal(got.ct.b, tx.value.ct.b)
    with pytest.raises(ValueError, match="radix ciphertext of 8 limbs"):
        convert.radix_int(np.asarray(v.ct.a), np.asarray(v.ct.b), v.ct.modulus, v.ct.pt_mod,
                          2, 2, 8, v.max_limb, device="cpu")


def test_pack_apply_lut_binary_op_match_fhe_tpu(cut):
    jfc, tfc = cut
    ja, ta = _pair(cut, [5, 14, 7, 0], FheType.EUINT4, 11)
    jb, tb = _pair(cut, [7, 10, 6, 15], FheType.EUINT4, 12)
    jsp = jshort.ShortIntParams(2, 2)
    _eq_ct(jshort.pack(jsp, ja.value.ct, jb.value.ct), shortint.pack(SP, ta.value.ct, tb.value.ct))
    # 8 limb ciphertexts [4, 2]: a periodic LUT (at q) and a packed one (at 2q)
    jl, tl = jshort.luts(jfc.params, jsp), shortint.luts(tfc.params, SP)
    _eq_ct(jshort.apply_lut(jfc.params, jfc.key, ja.value.ct, jl["msg"], jsp),
           shortint.apply_lut(tfc.params, tfc.key, ta.value.ct, tl["msg"], SP))
    _eq_ct(jshort.binary_op(jfc.params, jfc.key, "lt", ja.value.ct, jb.value.ct, jsp),
           shortint.binary_op(tfc.params, tfc.key, "lt", ta.value.ct, tb.value.ct, SP))


@pytest.mark.parametrize("t,batch", [(FheType.EUINT4, 4), (FheType.EUINT16, 1)],
                         ids=["ripple-euint4", "kogge-stone-euint16"])
def test_add_and_carries_match_fhe_tpu(t, batch, cut):
    """A lazy add, then the carry propagation: the ripple at 2 limbs, the
    Kogge-Stone prefix at 8 (radix.KS_THRESHOLD)."""
    jfc, tfc = cut
    gen = np.random.default_rng(20 + batch)
    hi = 1 << fhevm.fhe_type_bits(t)
    ja, ta = _pair(cut, gen.integers(0, hi, size=batch), t, 21)
    jb, tb = _pair(cut, gen.integers(0, hi, size=batch), t, 22)
    js, ts = jfc.add(ja, jb), tfc.add(ta, tb)
    _eq_int(js, ts)
    assert ts.value.max_limb == 6
    want = jradix.propagate_carries(jfc.params, jfc.key, js.value)
    got = radix.propagate_carries(tfc.params, tfc.key, ts.value)
    assert (t == FheType.EUINT16) == (ts.value.rp.num_limbs >= radix.KS_THRESHOLD)
    _eq_int(want, got)


def test_mul_matches_fhe_tpu(cut):
    ja, ta = _pair(cut, [3, 14, 7, 0], FheType.EUINT4, 31)
    jb, tb = _pair(cut, [5, 9, 7, 15], FheType.EUINT4, 32)
    _eq_int(cut[0].mul(ja, jb), cut[1].mul(ta, tb))


@pytest.mark.parametrize("op", ["lt", "eq"])
def test_compare_matches_fhe_tpu(op, cut):
    """The MSB-first fold (lt) and the limb-equality sum (eq)."""
    ja, ta = _pair(cut, [3, 14, 7, 0], FheType.EUINT4, 41)
    jb, tb = _pair(cut, [5, 9, 7, 15], FheType.EUINT4, 42)
    _eq_ct(getattr(cut[0], op)(ja, jb), getattr(cut[1], op)(ta, tb))


def test_select_matches_fhe_tpu(cut):
    ja, ta = _pair(cut, [3, 14, 7, 0], FheType.EUINT4, 51)
    jb, tb = _pair(cut, [5, 9, 7, 15], FheType.EUINT4, 52)
    jc = cut[0].ctx.encrypt(cut[0].sk, [1, 0, 1, 0], 53, p=16)
    tc = cut[1].ctx.encrypt(cut[1].sk, [1, 0, 1, 0], 53, p=16)
    _eq_ct(jc, tc)
    _eq_int(cut[0].select(jc, ja, jb), cut[1].select(tc, ta, tb))


def test_random_matches_fhe_tpu(cut):
    """random: host-drawn values, freshly encrypted."""
    _eq_int(cut[0].random(jfhevm.FheType.EUINT16, 61, batch_shape=(3,)),
            cut[1].random(FheType.EUINT16, 61, batch_shape=(3,)))


# -- the port alone, no bootstrap, N = q = 1024 ---------------------------------

def test_type_surface_matches_fhe_tpu():
    for t in FheType:
        jt = jfhevm.FheType(t.value)
        assert fhevm.fhe_type_bits(t) == jfhevm.fhe_type_bits(jt)
        assert fhevm.fhe_type_name(t) == jfhevm.fhe_type_name(jt) == t.value
        assert fhevm.TYPE_PARAMS[t].num_limbs == jfhevm.TYPE_PARAMS[jt].num_limbs
        for op in ("add", "mul", "div", "shl", "cast", "unknown"):
            assert fhevm.estimate_gas(op, t) == jfhevm.estimate_gas(op, jt)
    assert fhevm.version() == jfhevm.version()
    assert [fhevm.fhe_type_bits(t) for t in (FheType.EBOOL, FheType.EUINT64,
                                             FheType.EADDRESS)] == [2, 64, 160]


def test_lazy_ops_decrypt_right(cut):
    """add (within the carry budget), add_scalar, cast both ways, shifts
    and rotations by whole limbs, the byte forms and verify: no bootstrap."""
    tfc = cut[1]
    a = [0, 1, 77, 255]
    b = [255, 254, 100, 1]
    xa, xb = tfc.encrypt(a, FheType.EUINT8, 71), tfc.encrypt(b, FheType.EUINT8, 72)
    assert _ints(tfc.decrypt(tfc.add(xa, xb))) == [(x + y) % 256 for x, y in zip(a, b)]
    assert _ints(tfc.decrypt(tfc.add_scalar(xa, 300))) == [(x + 300) % 256 for x in a]
    assert _ints(tfc.decrypt(tfc.cast(xa, FheType.EUINT16))) == a
    assert _ints(tfc.decrypt(tfc.cast(xa, FheType.EUINT4))) == [x % 16 for x in a]
    assert _ints(tfc.decrypt(tfc.shl(xa, 4))) == [(x << 4) % 256 for x in a]
    assert _ints(tfc.decrypt(tfc.shr(xa, 2))) == [x >> 2 for x in a]
    assert _ints(tfc.decrypt(tfc.shl(xa, 9))) == [0] * 4
    assert _ints(tfc.decrypt(tfc.rotl(xa, 2))) == [((x << 2) | (x >> 6)) % 256 for x in a]
    assert _ints(tfc.decrypt(tfc.rotr(xa, 6))) == [((x >> 6) | (x << 2)) % 256 for x in a]
    one = tfc.encrypt_bytes(b"\x12\x34", FheType.EUINT16, 73)
    assert tfc.decrypt_bytes(one) == b"\x12\x34"
    assert tfc.decrypt_bytes(tfc.trivial_encrypt_bytes(b"\xab", FheType.EUINT8)) == b"\xab"
    assert tfc.verify(xa) and tfc.verify(tfc.cast(xa, FheType.EUINT16))
    assert not tfc.verify(fhevm.EncryptedInt(
        radix.RadixInt(ct=xa.value.ct, rp=radix.EUINT16, max_limb=3), FheType.EUINT16))


def test_public_key_decrypts_right(cut):
    """public_key_gen and encrypt_public (the dimension-N public key, then
    the switch to (n, q)) decrypt to their values, and add to a secret-key
    encryption lazily; keys and switch are held to fhe_tpu in
    test_torch_funcboot.py."""
    tfc = FheContext(**vars(cut[1]))
    pk = tfc.public_key_gen(62)
    assert pk.A.shape == (1024, 1024) and pk.modulus == tfc.params.Q
    vals = [0, 1, 200, 255]
    x = tfc.encrypt_public(vals, FheType.EUINT8, 63)
    assert x.value.ct.a.shape == (4, 4, tfc.params.n) and x.value.ct.modulus == tfc.params.q
    assert _ints(tfc.decrypt(x)) == vals
    y = tfc.encrypt([7, 9, 100, 1], FheType.EUINT8, 64)
    assert _ints(tfc.decrypt(tfc.add(x, y))) == [7, 10, 44, 0]


def test_not_ported_yet_raise(cut):
    """The serialisation methods (utils/serial) and the proofs against
    fhe_tpu's, byte for byte."""
    tfc = cut[1]
    x = tfc.encrypt([1, 200, 37], FheType.EUINT8, 91)
    jx = jradix.RadixInt(ct=jlwe.LweCiphertext(
        a=jnp.asarray(x.value.ct.a.numpy().astype(np.uint32)),
        b=jnp.asarray(x.value.ct.b.numpy().astype(np.uint32)),
        modulus=x.value.ct.modulus, pt_mod=x.value.ct.pt_mod),
        rp=jradix.RadixParams(jshort.ShortIntParams(SP.message_bits, SP.carry_bits),
                              x.value.rp.num_limbs), max_limb=x.value.max_limb)
    jenc = jfhevm.EncryptedInt(jx, jfhevm.FheType.EUINT8)
    blob = tfc.serialize_ciphertext(x)
    assert blob == jfhevm.FheContext.serialize_ciphertext(None, jenc)
    back = tfc.deserialize_ciphertext(blob)
    assert back.fhe_type is FheType.EUINT8 and back.value.rp == x.value.rp
    _eq_int(jx, back)
    np.testing.assert_array_equal(tfc.decrypt(back), [1, 200, 37])
    from fhe_tpu_torch.utils import serial
    for blob, obj in ((tfc.serialize_secret_key(), tfc.sk),
                      (tfc.serialize_bootstrap_key(), tfc.key)):
        got = serial.loads(blob, device=CPU)
        assert type(got) is type(obj) and serial.dumps(got) == blob
    # the proofs are ported (tfhe/zkp.py): fhe_tpu's commitment to the
    # ciphertext's uint32 words, byte for byte
    proof = tfc.get_proof(x)
    assert proof == jfhevm.FheContext.get_proof(None, jenc)
    assert tfc.verify_proof(x, proof)
    assert not tfc.verify_proof(x, proof[:-1] + bytes([proof[-1] ^ 1]))
    with pytest.raises(ValueError, match="public_key_gen first"):
        FheContext(ctx=tfc.ctx, key=tfc.key, sk=tfc.sk, sk_n=tfc.sk_n).encrypt_public(
            [1], FheType.EUINT8)


def test_every_ntt_impl_gives_the_same_ciphertexts(cut):
    """An euint4 lt through "mega" and "fused" equals the default
    accumulator's."""
    tfc = cut[1]
    xa = tfc.encrypt([3, 14, 7, 0], FheType.EUINT4, 81)
    xb = tfc.encrypt([5, 9, 7, 15], FheType.EUINT4, 82)
    want = tfc.lt(xa, xb)
    for impl in ("mega", "fused"):
        got = FheContext(**{**vars(tfc), "ctx": dataclasses.replace(tfc.ctx, ntt_impl=impl)}).lt(
            xa, xb)
        assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


# -- the port alone against Python integers, N = q = 8192 ------------------------

A4 = np.array([3, 9, 15, 12])
B4 = np.array([0, 9, 1, 4])


def _div(a, b):
    """Restoring division's answer: by zero, q = all ones and r = a."""
    return np.where(b == 0, 15, a // np.maximum(b, 1)), np.where(b == 0, a, a % np.maximum(b, 1))


def _rotl(a, k):
    k = k % 4
    return ((a << k) | (a >> (4 - k))) % 16


# op -> (call on (fc, x_a, x_b), its euint4 or boolean value on (a, b))
VALUE_OPS = {
    "sub": (lambda fc, x, y: fc.sub(x, y), lambda a, b: (a - b) % 16),
    "lt": (lambda fc, x, y: fc.lt(x, y), lambda a, b: a < b),
    "xor": (lambda fc, x, y: fc.xor(x, y), lambda a, b: a ^ b),
    "not": (lambda fc, x, y: fc.not_(x), lambda a, b: 15 - a),
    "shl 1": (lambda fc, x, y: fc.shl(x, 1), lambda a, b: (a << 1) % 16),
    "is_zero": (lambda fc, x, y: fc.is_zero(y), lambda a, b: b == 0),
    # marked slow below
    "add x5": (lambda fc, x, y: functools.reduce(lambda s, _: fc.add(s, y), range(5), x),
               lambda a, b: (a + 5 * b) % 16),
    "mul": (lambda fc, x, y: fc.mul(x, y), lambda a, b: (a * b) % 16),
    "div": (lambda fc, x, y: fc.div(x, y), lambda a, b: _div(a, b)[0]),
    "rem": (lambda fc, x, y: fc.rem(x, y), lambda a, b: _div(a, b)[1]),
    "neg": (lambda fc, x, y: fc.neg(x), lambda a, b: (-a) % 16),
    "min": (lambda fc, x, y: fc.min(x, y), np.minimum),
    "max": (lambda fc, x, y: fc.max(x, y), np.maximum),
    "select": (lambda fc, x, y: fc.select(fc.ge(x, y), x, y), np.maximum),
    "if_then_else": (lambda fc, x, y: fc.if_then_else(
        fc.encrypt([1, 0] * 2, FheType.EBOOL, 9), x, y), lambda a, b: np.where(
            np.arange(4) % 2 == 0, a, b)),
    "le": (lambda fc, x, y: fc.le(x, y), lambda a, b: a <= b),
    "gt": (lambda fc, x, y: fc.gt(x, y), lambda a, b: a > b),
    "ge": (lambda fc, x, y: fc.ge(x, y), lambda a, b: a >= b),
    "eq": (lambda fc, x, y: fc.eq(x, y), lambda a, b: a == b),
    "ne": (lambda fc, x, y: fc.ne(x, y), lambda a, b: a != b),
    "and": (lambda fc, x, y: fc.and_(x, y), lambda a, b: a & b),
    "or": (lambda fc, x, y: fc.or_(x, y), lambda a, b: a | b),
    "is_nonzero": (lambda fc, x, y: fc.is_nonzero(y), lambda a, b: b != 0),
    "shl 3": (lambda fc, x, y: fc.shl(x, 3), lambda a, b: (a << 3) % 16),
    "shr 1": (lambda fc, x, y: fc.shr(x, 1), lambda a, b: a >> 1),
    "shr 3": (lambda fc, x, y: fc.shr(x, 3), lambda a, b: a >> 3),
    "rotl 1": (lambda fc, x, y: fc.rotl(x, 1), lambda a, b: _rotl(a, 1)),
    "rotr 3": (lambda fc, x, y: fc.rotr(x, 3), lambda a, b: _rotl(a, 1)),
    "shl enc": (lambda fc, x, y: fc.shl(x, y), lambda a, b: np.where(b < 4, (a << b) % 16, 0)),
    "shr enc": (lambda fc, x, y: fc.shr(x, y), lambda a, b: np.where(b < 4, a >> b, 0)),
    "rotl enc": (lambda fc, x, y: fc.rotl(x, y), _rotl),
    "add_scalar": (lambda fc, x, y: fc.add_scalar(x, 7), lambda a, b: (a + 7) % 16),
    "sub_scalar": (lambda fc, x, y: fc.sub_scalar(x, 7), lambda a, b: (a - 7) % 16),
    "mul_scalar": (lambda fc, x, y: fc.mul_scalar(x, 3), lambda a, b: (3 * a) % 16),
    "div_scalar": (lambda fc, x, y: fc.div_scalar(x, 3), lambda a, b: a // 3),
    "rem_scalar": (lambda fc, x, y: fc.rem_scalar(x, 3), lambda a, b: a % 3),
    "lt_scalar": (lambda fc, x, y: fc.lt_scalar(x, 7), lambda a, b: a < 7),
    "and_scalar": (lambda fc, x, y: fc.and_scalar(x, 6), lambda a, b: a & 6),
}
TIER1_OPS = ("sub", "lt", "xor", "not", "shl 1", "is_zero")


@pytest.fixture(scope="module")
def ring8k():
    """The port's FheContext at TOY_RADIX's ring (N = q = 8192) with n cut
    to 1, and euint4 encryptions of A4 and B4."""
    p = dataclasses.replace(make_params("TOY_RADIX"), n=1)
    fc = FheContext.keyed(BinFheContext(params=p, device=CPU), 5)
    return fc, fc.encrypt(A4, FheType.EUINT4, 6), fc.encrypt(B4, FheType.EUINT4, 7)


@pytest.mark.parametrize("op", [pytest.param(op, marks=() if op in TIER1_OPS else pytest.mark.slow)
                                for op in VALUE_OPS])
def test_op_values(op, ring8k):
    fc, xa, xb = ring8k
    call, model = VALUE_OPS[op]
    out = call(fc, xa, xb)
    want = np.asarray(model(A4, B4)).astype(np.int64)
    got = fc.decrypt_bool(out) if want.dtype == bool or isinstance(out, type(xa.value.ct)) \
        else np.array(_ints(fc.decrypt(out)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_random_range_values(ring8k):
    fc = ring8k[0]
    r = fc.random_range(FheType.EUINT4, 5, 11)
    assert 0 <= _ints(fc.decrypt(r))[0] < 5


@pytest.mark.slow
def test_sub_and_lt_match_fhe_tpu_at_full_ring():
    """TOY_RADIX's full ring (N = q = 8192) with n cut to 8, byte for byte
    against fhe_tpu: an euint4 sub and lt, which also decrypt right."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "bootstrap_func", _padded(jfb.bootstrap_func))
    try:
        full = _contexts(8192, 8, 13)
        ja, ta = _pair(full, A4, FheType.EUINT4, 14)
        jb, tb = _pair(full, B4, FheType.EUINT4, 15)
        d = full[1].sub(ta, tb)
        _eq_int(full[0].sub(ja, jb), d)
        c = full[1].lt(ta, tb)
        _eq_ct(full[0].lt(ja, jb), c)
    finally:
        mp.undo()
    assert _ints(full[1].decrypt(d)) == list((A4 - B4) % 16)
    assert full[1].decrypt_bool(c).tolist() == (A4 < B4).astype(int).tolist()


@pytest.mark.slow
def test_toy_radix_lt_failures_are_the_reference_s():
    """chip_smoke.py's [radix] euint8 lt on 256 pairs (its SEED, its draws)
    reads rows 36 and 71 wrong on the card: a packed pair carries four
    times one bootstrap output's noise, past TOY_RADIX's margin there.
    fhe_tpu gives the same ciphertexts on those rows, wrong values
    included, at full TOY_RADIX (N = 8192, n = 64) on the CPU."""
    seed = 20261016
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "bootstrap_func", _padded(jfb.bootstrap_func))
    try:
        jfc, tfc = _contexts(8192, 64, seed)
        outs = []
        for fc, t in ((jfc, jfhevm.FheType.EUINT8), (tfc, FheType.EUINT8)):
            rng = np.random.default_rng(seed + 11)
            a, b = rng.integers(0, 256, size=(2, 256)).astype(object)
            b[:32] = a[:32]
            b[32:64:4] = 0
            rng.integers(0, 2, size=256)
            xa, xb = fc.encrypt(a, t, rng), fc.encrypt(b, t, rng)
            rows = [36, 71]
            for x in (xa, xb):
                ct = x.value.ct
                x.value.ct = type(ct)(ct.a[np.array(rows)], ct.b[np.array(rows)], ct.modulus,
                                      ct.pt_mod)
            outs.append(fc.lt(xa, xb))
        _eq_ct(*outs)
    finally:
        mp.undo()
    assert (a[rows] < b[rows]).astype(int).tolist() == [0, 1]
    assert tfc.decrypt_bool(outs[1]).tolist() == [1, 0]
