"""fhe_tpu_torch's functional bootstrapping (tfhe/funcboot.py) and
public-key mode (tfhe/lwe.py) against fhe_tpu on the CPU, byte for byte.

MEDIUM (N = q = 1024: STD128's ring shape, so 2q = 2N is reached;
q_ks = 2^14, where fhe_tpu's mod switch Q -> q_ks is exact) with n cut to 8
in both packages; keys from the same seeds (fhe_tpu's BSK assembly
jitted, as in test_torch_gate.py).  fhe_tpu compiles its bootstrap once
for each (ct_mod, f_mod, pt_mod): the tier-1 tests stay on the three that
eval_func and eval_floor need, (q, q, 4), (2q, 2q, 4) and (q, 8q, 8).
EvalSign and EvalDecomp are held to a plaintext model on the port alone;
their byte-equality with fhe_tpu (about 15 s and 9 s of compiles) is
marked slow.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import BinFheContext as JContext
from fhe_tpu.tfhe import funcboot as jfb
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import rgsw as j_rgsw
from fhe_tpu.tfhe.params import make_params as j_make_params
from fhe_tpu_torch import convert
from fhe_tpu_torch.tfhe import (BinFheContext, DmKey, LmkcdeyKey, RnsKey, funcboot, lwe,
                                make_params)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

IMPLS = (None, "mega", "fused")
# f: Z_4 -> Z_4 of each LUT kind (eprint 2021/1337): f(m + 2) = -f(m),
# f(m + 2) = f(m), neither
FUNCS = {"negacyclic": lambda m, p: m ** 3 % p,
         "periodic": lambda m, p: (m * m + 1) % p,
         "arbitrary": lambda m, p: (m + 1) % p}
KIND = {"negacyclic": 0, "periodic": 1, "arbitrary": 2}


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _eq_ct(jct, tct):
    assert (jct.modulus, jct.pt_mod) == (tct.modulus, tct.pt_mod)
    _eq(jct.a, tct.a)
    _eq(jct.b, tct.b)


def _same(got, want):
    assert (got.modulus, got.pt_mod) == (want.modulus, want.pt_mod)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


@pytest.fixture(scope="module")
def medium():
    """fhe_tpu's and the port's MEDIUM contexts (n cut to 8), with
    key_gen_pair and bt_key_gen (on that pair) from the same seeds."""
    jc = JContext(params=dataclasses.replace(j_make_params("MEDIUM"), n=8))
    tc = BinFheContext(params=dataclasses.replace(make_params("MEDIUM"), n=8),
                       device=torch.device("cpu"))
    bsk_device = j_rgsw._bsk_device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rgsw, "_bsk_device", lambda plan, params, *x: jax.jit(
            functools.partial(bsk_device, plan, params))(*x))
        jsk, jsk_n, jpk = jc.key_gen_pair(11)
        jkey = jc.bt_key_gen(jsk, 12, sk_n=jsk_n)
    tsk, tsk_n, tpk = tc.key_gen_pair(11)
    tkey = tc.bt_key_gen(tsk, 12, sk_n=tsk_n)
    return jc, tc, (jsk, jsk_n, jpk, jkey), (tsk, tsk_n, tpk, tkey)


def _encrypt(medium, m, seed, p, modulus=None):
    """The same message encrypted by both packages from one seed."""
    jc, tc, (jsk, *_), (tsk, *_) = medium
    jct = jc.encrypt(jsk, m, seed, p=p, modulus=modulus)
    tct = tc.encrypt(tsk, m, seed, p=p, modulus=modulus)
    _eq_ct(jct, tct)
    return jct, tct


def _decrypt(medium, ct, p):
    tc, tsk = medium[1], medium[3][0]
    return tc.decrypt(tsk, ct, p).numpy()


def test_keys_match_fhe_tpu(medium):
    _, _, (jsk, jsk_n, jpk, jkey), (tsk, tsk_n, tpk, tkey) = medium
    for jarr, tens in [(jsk.s, tsk.s), (jsk_n.s, tsk_n.s), (jpk.A, tpk.A), (jpk.v, tpk.v),
                       (jkey.bsk, tkey.bsk), (jkey.ksk.a, tkey.ksk.a), (jkey.ksk.b, tkey.ksk.b)]:
        _eq(jarr, tens)
    assert tpk.modulus == jpk.modulus == medium[1].params.Q
    cpk = convert.public_key(np.asarray(jpk.A), np.asarray(jpk.v), jpk.modulus, device="cpu")
    assert torch.equal(cpk.A, tpk.A) and torch.equal(cpk.v, tpk.v)


@pytest.mark.parametrize("kind", list(FUNCS))
def test_luts_match_fhe_tpu(kind, medium):
    """generate_lut, the LUT's kind and the derived tables, host numpy."""
    q = medium[1].params.q
    lut = medium[1].generate_lut(FUNCS[kind], 4)
    want = medium[0].generate_lut(FUNCS[kind], 4)
    assert lut.dtype == want.dtype and np.array_equal(lut, want)
    assert funcboot._lut_property(lut, q) == jfb._lut_property(want, q) == KIND[kind]
    for mod, f_mod in [(q, q), (2 * q, 2 * q), (q, 8 * q), (q // 2, q)]:
        assert np.array_equal(funcboot._f0_table(mod, f_mod), jfb._f0_table(mod, f_mod))
    assert medium[1].max_plaintext_space == medium[0].max_plaintext_space == 4


def test_lwe_helpers_match_fhe_tpu(medium):
    """set_modulus up and down, add_const, sub_const and sub."""
    q = medium[1].params.q
    jct, tct = _encrypt(medium, np.arange(8), 21, 8, 8 * q)
    jct2, tct2 = _encrypt(medium, np.arange(8)[::-1], 22, 8, 8 * q)
    for q_new in (16 * q, 8 * q, 2 * q, q, q // 2):
        _eq_ct(jfb.set_modulus(jct, q_new), funcboot.set_modulus(tct, q_new))
    _eq_ct(jfb.add_const(jct, 3 * q + 5), funcboot.add_const(tct, 3 * q + 5))
    _eq_ct(jfb.sub_const(jct, 7 * q), funcboot.sub_const(tct, 7 * q))
    _eq_ct(jfb.sub(jct, jct2), funcboot.sub(tct, tct2))
    with pytest.raises(ValueError, match="power of two dividing"):
        funcboot.set_modulus(tct, 3 * q)
    with pytest.raises(ValueError, match="sub of ciphertexts"):
        funcboot.sub(tct, funcboot.set_modulus(tct2, q))


@pytest.mark.parametrize("ct_mod,f_mod,p", [(1, 1, 4), (2, 2, 4), (1, 8, 8)],
                         ids=["q,q", "2q,2q", "q,8q"])
def test_bootstrap_func_matches_fhe_tpu(ct_mod, f_mod, p, medium):
    """BootstrapFunc with a random table, byte for byte; ct_mod 2q = 2N
    rotates by every index."""
    jc, tc, (_, _, _, jkey), (_, _, _, tkey) = medium
    q = tc.params.q
    ct_mod, f_mod = ct_mod * q, f_mod * q
    jct, tct = _encrypt(medium, np.arange(8), 31, p)
    jct, tct = jfb.set_modulus(jct, ct_mod), funcboot.set_modulus(tct, ct_mod)
    table = np.random.default_rng(32).integers(0, f_mod, size=ct_mod).astype(np.uint32)
    got = funcboot.bootstrap_func(tc.params, tkey, tct, table, f_mod)
    assert got.a.shape == (8, tc.params.n) and got.modulus == f_mod
    _eq_ct(jfb.bootstrap_func(jc.params, jkey, jct, table, f_mod), got)


@pytest.mark.parametrize("kind", list(FUNCS))
def test_eval_func_matches_fhe_tpu(kind, medium):
    jc, tc, (_, _, _, jkey), (_, _, _, tkey) = medium
    m = np.arange(8) % 4
    jct, tct = _encrypt(medium, m, 41, 4)
    lut = tc.generate_lut(FUNCS[kind], 4)
    got = tc.eval_func(tkey, tct, lut)
    _eq_ct(jc.eval_func(jkey, jct, lut), got)
    np.testing.assert_array_equal(_decrypt(medium, got, 4), FUNCS[kind](m, 4))


def _floor_past(medium, ct) -> np.ndarray:
    """Where EvalFloor's middle phase x = (ct + beta - its first bootstrap)
    mod q leaves [q/4, 3q/4), the range its second LUT assumes: the only
    inputs it can floor wrong.  At 8q the first bootstrap's output noise
    is a good part of beta = q/8 (ROADMAP.md queue 3)."""
    tc, (tsk, _, _, tkey) = medium[1], medium[3]
    q = tc.params.q
    ct1 = funcboot.add_const(ct, funcboot.BETA)
    ct2 = funcboot.bootstrap_func(tc.params, tkey, funcboot.set_modulus(ct1, q),
                                  funcboot._f0_table(q, ct.modulus), ct.modulus)
    mid = funcboot.sub(ct1, ct2)
    x = lwe.noise(tc.params, tsk, mid, np.zeros(mid.batch_shape, np.int64), p=1).numpy() % q
    return (x < q // 4) | (x >= 3 * q // 4)


def test_eval_floor_matches_fhe_tpu(medium):
    """EvalFloor at 8q with p = 8: byte for byte, and the output keeps the
    message wherever the middle phase is inside [q/4, 3q/4)."""
    jc, tc, (_, _, _, jkey), (_, _, _, tkey) = medium
    m = np.random.default_rng(51).integers(0, 8, size=8)
    jct, tct = _encrypt(medium, m, 52, 8, 8 * tc.params.q)
    got = tc.eval_floor(tkey, tct)
    assert got.modulus == 8 * tc.params.q
    _eq_ct(jc.eval_floor(jkey, jct), got)
    wrong = _decrypt(medium, got, 8) != m
    assert not (wrong & ~_floor_past(medium, tct)).any()


def test_mod_switch_identity_at_q_ks(medium):
    """The bootstrap's last switch q_ks -> f_mod is the identity at f_mod =
    16q = q_ks, and exact when it scales up (f_mod = 2 q_ks)."""
    tc = medium[1]
    q_ks = tc.params.q_ks
    assert q_ks == 16 * tc.params.q
    v = torch.arange(q_ks, dtype=torch.int32)
    ct = lwe.LweCiphertext(a=v[:, None], b=v, modulus=q_ks)
    _same(lwe.mod_switch(ct, q_ks), ct)
    up = lwe.mod_switch(ct, 2 * q_ks)
    assert torch.equal(up.b, 2 * v)


def decomp_digits(m: np.ndarray, P: int, mod: int, q: int, p: int, beta: int = 128):
    """A plaintext rendering of eval_decomp's loop on the noise-free phase
    m mod/P: each digit is the phase mod q decrypted at p (set_modulus),
    the floor clears it, and the mod switch scales by 2 beta / q; the last
    is the remainder decrypted at p."""
    v = m.astype(np.int64) * (mod // P)
    digits = []
    while mod > q:
        digits.append(v % q * p // q % p)
        v = v - v % q
        new = mod * 2 * beta // q
        v, mod = v * new // mod, new
    digits.append(v * p // mod % p)
    return digits


@pytest.mark.parametrize("mult", [4, 2])
def test_eval_sign_on_port(mult, medium):
    """EvalSign at 4q (3 bootstraps) and 2q (its last at ct_mod q/2, a
    rotation index step of 4) against the MSB, wherever its first floor's
    middle phase is in range.  Above 4q the floors' noise makes some MSBs
    wrong in fhe_tpu too: test_eval_sign_matches_fhe_tpu, slow."""
    tc, (tsk, _, _, tkey) = medium[1], medium[3]
    m = np.random.default_rng(61 + mult).integers(0, 8, size=8)
    tct = tc.encrypt(tsk, m, 62, p=8, modulus=mult * tc.params.q)
    out = tc.eval_sign(tkey, tct)
    assert out.modulus == tc.params.q
    wrong = _decrypt(medium, out, 2) != (m >= 4)
    assert not (wrong & ~_floor_past(medium, tct)).any()


def test_eval_decomp_on_port(medium):
    """EvalDecomp at 4q = q^2 / (2 beta): two base-4 digits of m in Z_16,
    the high one right wherever the floor's middle phase is in range."""
    tc, tkey = medium[1], medium[3][3]
    q = tc.params.q
    m = np.random.default_rng(71).integers(0, 16, size=8)
    tct = tc.encrypt(medium[3][0], m, 72, p=16, modulus=4 * q)
    digits = tc.eval_decomp(tkey, tct)
    want = decomp_digits(m, 16, 4 * q, q, 4)
    assert [d.modulus for d in digits] == [q, q]
    np.testing.assert_array_equal(want, [m % 4, m // 4])
    np.testing.assert_array_equal(_decrypt(medium, digits[0], 4), want[0])
    wrong = _decrypt(medium, digits[1], 4) != want[1]
    assert not (wrong & ~_floor_past(medium, tct)).any()


def test_every_ntt_impl_gives_the_same_ciphertexts(medium):
    """The arbitrary LUT (2N/ct_mod = 2, then 1), EvalSign at 8q (4 at its
    last bootstrap) and EvalFloor with roundbits (ct_mod beta 2^2 = q/2)
    through "mega" and "fused" equal the default accumulator's."""
    tc, (tsk, _, _, tkey) = medium[1], medium[3]
    q = tc.params.q
    ct = tc.encrypt(tsk, np.arange(8) % 4, 81)
    big = tc.encrypt(tsk, np.arange(8), 82, p=8, modulus=8 * q)
    lut = tc.generate_lut(FUNCS["arbitrary"], 4)
    outs = {impl: [c.eval_func(tkey, ct, lut), c.eval_sign(tkey, big),
                   c.eval_floor(tkey, big, roundbits=1)]
            for impl in IMPLS for c in [dataclasses.replace(tc, ntt_impl=impl)]}
    for impl in IMPLS[1:]:
        for got, want in zip(outs[impl], outs[None]):
            _same(got, want)


def test_named_errors(medium):
    tc, (tsk, _, _, tkey) = medium[1], medium[3]
    p = tc.params
    q = p.q
    ct = tc.encrypt(tsk, [0, 1], 91)
    lut = tc.generate_lut(FUNCS["arbitrary"], 4)
    for key in (DmKey(bsk=None, ksk=None), LmkcdeyKey(rgsw=None, auto=None, ksk=None),
                RnsKey(bsk=None, ksk=None)):
        for call in (lambda: tc.eval_func(key, ct, lut), lambda: tc.eval_floor(key, ct),
                     lambda: funcboot.bootstrap_func(p, key, ct, lut, q)):
            with pytest.raises(ValueError, match="GINX BootstrapKey on a single-limb"):
                call()
    rns = BinFheContext.generate("TOY_RNS", device="cpu")
    with pytest.raises(ValueError, match="TOY_RNS: functional bootstrapping has no path"):
        rns.eval_func(RnsKey(bsk=None, ksk=None), ct, lut)
    wide = funcboot.set_modulus(ct, 2 * q)
    with pytest.raises(ValueError, match="arbitrary-function LUT requires ct modulus <= N"):
        tc.eval_func(tkey, wide, funcboot.generate_lut(FUNCS["arbitrary"], 4, 2 * q))
    with pytest.raises(ValueError, match="EvalSign requires ct modulus > q"):
        tc.eval_sign(tkey, ct)
    with pytest.raises(ValueError, match="EvalDecomp requires ct modulus > q"):
        tc.eval_decomp(tkey, ct)
    with pytest.raises(ValueError, match=f"a LUT over Z_{q} needs {q} entries"):
        tc.eval_func(tkey, ct, lut[:-1])
    with pytest.raises(ValueError, match=r"LUT values must lie in \[0, 1024\)"):
        funcboot.bootstrap_func(p, tkey, ct, lut + q, q)
    with pytest.raises(ValueError, match="LWE modulus 4096 must be a power of two"):
        funcboot.bootstrap_func(p, tkey, funcboot.set_modulus(ct, 4 * q),
                                np.zeros(4 * q, np.uint32), q)
    with pytest.raises(ValueError, match="function must output in Z_p"):
        tc.generate_lut(lambda m, pp: m + 1, 4)


def test_public_key_encryption_matches_fhe_tpu(medium):
    """encrypt_pk (its products on the device as exact float64 matrix
    products) and noise byte-equal to fhe_tpu's host int64 numpy."""
    jc, tc, (_, jsk_n, jpk, _), (_, tsk_n, tpk, _) = medium
    m = np.random.default_rng(101).integers(0, 4, size=8)
    jct, tct = jc.encrypt_pk(jpk, m, 102), tc.encrypt_pk(tpk, m, 102)
    assert tct.a.shape == (8, tc.params.N) and tct.modulus == tc.params.Q
    _eq_ct(jct, tct)
    want = jax.jit(lambda sk, ct: jlwe.noise(jc.params, sk, ct, m))(jsk_n, jct)
    got = lwe.noise(tc.params, tsk_n, tct, m)
    assert got.dtype == torch.int32
    _eq(want, got)
    assert int(got.abs().max()) < 4 * tc.params.N          # N ternary-weighted errors
    np.testing.assert_array_equal(tc.decrypt(tsk_n, tct).numpy(), m)
    with pytest.raises(NotImplementedError, match="Q < 2\\^31"):
        lwe.pub_key_gen(make_params("TOY_RNS"), tsk_n, np.random.default_rng(0))


def test_public_key_switch_then_gate(medium):
    """encrypt_pk with the bootstrap key's ksk switches to (n, q); an AND
    with a secret-key ciphertext decrypts to the truth table."""
    tc, (tsk, _, tpk, tkey) = medium[1], medium[3]
    m1, m2 = np.random.default_rng(111).integers(0, 2, size=(2, 8))
    ct1 = tc.encrypt_pk(tpk, m1, 112, ksk=tkey.ksk)
    assert ct1.a.shape == (8, tc.params.n) and ct1.modulus == tc.params.q
    np.testing.assert_array_equal(tc.decrypt(tsk, ct1).numpy(), m1)
    out = tc.eval_bin_gate(tkey, "AND", ct1, tc.encrypt(tsk, m2, 113))
    np.testing.assert_array_equal(tc.decrypt(tsk, out).numpy(), m1 & m2)


@pytest.mark.slow
@pytest.mark.parametrize("mult", [16, 8])
def test_eval_sign_matches_fhe_tpu(mult, medium):
    jc, tc, (_, _, _, jkey), (_, _, _, tkey) = medium
    m = np.random.default_rng(121).integers(0, 8, size=8)
    jct, tct = _encrypt(medium, m, 122, 8, mult * tc.params.q)
    _eq_ct(jc.eval_sign(jkey, jct), tc.eval_sign(tkey, tct))
    _eq_ct(jfb.eval_sign(jc.params, jkey, jct, scheme_switch=True),
           funcboot.eval_sign(tc.params, tkey, tct, scheme_switch=True))


@pytest.mark.slow
def test_eval_decomp_matches_fhe_tpu(medium):
    """EvalDecomp byte for byte, and fhe_tpu's decrypted digits against the
    plaintext rendering the port's test uses."""
    jc, tc, (jsk, _, _, jkey), (_, _, _, tkey) = medium
    q = tc.params.q
    m = np.random.default_rng(131).integers(0, 16, size=8)
    jct, tct = _encrypt(medium, m, 132, 16, 4 * q)
    jdigits, tdigits = jc.eval_decomp(jkey, jct), tc.eval_decomp(tkey, tct)
    assert len(jdigits) == len(tdigits) == 2
    for jd, td, w in zip(jdigits, tdigits, decomp_digits(m, 16, 4 * q, q, 4)):
        _eq_ct(jd, td)
        np.testing.assert_array_equal(np.asarray(jc.decrypt(jsk, jd, 4)), w)


@pytest.mark.slow
def test_std128_floor_failures_are_the_reference_s():
    """chip_smoke.py's EvalFloor at 8q, STD128 at full width (n = 503): its
    key (SEED) and floor inputs (SEED + 6, drawn in its order).  The port
    on the CPU floors elements 9, 23 and 37 wrong, exactly where the middle
    phase leaves [q/4, 3q/4), and element 0 right; fhe_tpu, keyed and
    encrypting from the same seeds, gives the same four ciphertexts byte
    for byte."""
    seed, batch, idx = 20261016, 4096, [9, 23, 37, 0]
    out, keys = [], []
    for ctx in (BinFheContext.generate("STD128", device="cpu"), JContext.generate("STD128")):
        rng = np.random.default_rng(seed)
        sk = ctx.key_gen(rng)
        if isinstance(ctx, JContext):
            bsk_device = j_rgsw._bsk_device
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_rgsw, "_bsk_device", lambda plan, params, *x: jax.jit(
                    functools.partial(bsk_device, plan, params))(*x))
                key = ctx.bt_key_gen(sk, rng)
        else:
            key = ctx.bt_key_gen(sk, rng)
        q = ctx.params.q
        rng = np.random.default_rng(seed + 6)
        m4 = rng.integers(0, 4, size=batch)
        ctx.encrypt(sk, m4, rng)
        ctx.encrypt(sk, m4[:1], rng)
        m8 = rng.integers(0, 8, size=batch)
        ct = ctx.encrypt(sk, m8, rng, p=8, modulus=8 * q)
        ct = dataclasses.replace(ct, a=ct.a[np.array(idx)], b=ct.b[np.array(idx)])
        out.append(ctx.eval_floor(key, ct))
        keys.append((ctx, sk, key, ct))
    _eq_ct(out[1], out[0])
    tc, tsk, tkey, tct = keys[0]
    wrong = tc.decrypt(tsk, out[0], 8).numpy() != m8[idx]
    assert wrong.tolist() == [True, True, True, False]
    medium = (None, tc, None, (tsk, None, None, tkey))
    assert _floor_past(medium, tct).tolist() == wrong.tolist()
