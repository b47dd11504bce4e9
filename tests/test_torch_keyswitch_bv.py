"""fhe_tpu_torch's BV key switching (pke/rlwe.py: bv_evk_gen, bv_decompose,
bv_key_switch; the schemes' method="bv" keys) against fhe_tpu on the CPU,
byte for byte, on CKKS at N = 256 (tests/test_keyswitch_bv.py's ring, cut
to num_levels = 2, Q 3 limbs: fhe_tpu compiles one NTT a digit), per-limb
digits (digit_bits = 0) and base-2^16 ones; the decrypted values within
fhe_tpu's tolerances; and the carry-over of a BV key (convert.py).  BFV's
BEHZ product relinearized with a BV key is in test_torch_bfv_behz.py.

fhe_tpu runs only jitted; the port's secret key is carried into it as
arrays, so that both draw the key rows from one generator state.  The port
runs with device="cpu" (the plain NTTs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import bgv, ckks, rlwe

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SEED = 53


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _jsk(sk):
    return j_rlwe.SecretKey(s_signed=jnp.asarray(sk.s_signed.numpy()),
                            s_eval_full=_j(sk.s_eval_full), moduli_full=sk.moduli_full)


def _jbv(k):
    return j_rlwe.BvEvalKey(b=_j(k.b), a=_j(k.a), moduli=k.moduli, digit_bits=k.digit_bits,
                            rows_per_limb=k.rows_per_limb)


@pytest.fixture(scope="module")
def setup():
    """The CKKS contexts, the port's keys and two ciphertexts (z1, z2)."""
    kw = dict(N=N, num_levels=2, scale_bits=28, dnum=2)
    ctx, jctx = ckks.CkksContext.create(**kw, device="cpu"), j_ckks.CkksContext.create(**kw)
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    zs = [rng.normal(size=N // 2) * 0.5 for _ in range(2)]
    return ctx, jctx, sk, pk, [ctx.encrypt(pk, z, rng) for z in zs], zs


@pytest.mark.parametrize("digit_bits", [0, 16])
def test_bv_key_decompose_and_switch_match_fhe_tpu(setup, digit_bits):
    """bv_evk_gen of s^2 from one generator state; bv_decompose and
    bv_key_switch of a ciphertext's c1 (fhe_tpu's list of digits,
    stacked): per-limb digits over the whole chain and over a prefix of it
    (the key truncated), base-2^16 digits over the prefix."""
    ctx, jctx, sk, _, (ct, _), _ = setup
    mods = tuple(ctx.params.moduli)
    s = sk.eval_poly(mods)
    key = rlwe.bv_evk_gen(ctx.params, rns.mul(s, s), sk, np.random.default_rng(7), digit_bits)
    cs = (ct.c1, rns.level_reduce(ct.c1, 1)) if digit_bits == 0 else (rns.level_reduce(ct.c1, 1),)

    def fhe_tpu(jsk, *jcs):
        gen = np.random.default_rng(7)
        js = jsk.eval_poly(mods)
        k = j_rlwe.bv_evk_gen(jctx.params, j_rns.mul(js, js), jsk, gen, digit_bits)
        return k, [(jnp.stack([d.data for d in j_rlwe.bv_decompose(jctx.params, k, c)]),
                    j_rlwe.bv_key_switch(jctx.params, k, c)) for c in jcs]

    jkey, jouts = jax.jit(fhe_tpu)(_jsk(sk), *[_jpoly(c) for c in cs])
    assert key.rows_per_limb == jkey.rows_per_limb and key.moduli == jkey.moduli
    assert key.b.shape[0] == (len(mods) if digit_bits == 0 else 2 * len(mods))
    _eq(jkey.b, key.b)
    _eq(jkey.a, key.a)
    for (jdigits, (j0, j1)), c in zip(jouts, cs):
        digits = rlwe.bv_decompose(ctx.params, key, c)
        assert (digits.fmt, digits.moduli) == (rns.EVAL, c.moduli)
        _eq(jdigits, digits.data)
        d0, d1 = rlwe.bv_key_switch(ctx.params, key, c)
        assert d0.moduli == j0.moduli == c.moduli
        _eq(j0.data, d0.data)
        _eq(j1.data, d1.data)


def test_bv_key_switch_refuses_a_basis_off_the_chain(setup):
    ctx, _, sk, _, (ct, _), _ = setup
    key = ctx.relin_key_gen(sk, np.random.default_rng(8), method="bv")
    c = rns.RnsPoly(ct.c1.data[1:], ct.c1.moduli[1:], rns.EVAL)
    with pytest.raises(ValueError, match="prefix"):
        rlwe.bv_key_switch(ctx.params, key, c)


def test_ckks_mul_with_bv_key_matches_fhe_tpu(setup):
    """CKKS mul relinearized with a per-limb BV key (key_switch dispatches
    on the key's type), then rescale: fhe_tpu's bytes, within 1e-3 of z1
    z2."""
    ctx, jctx, sk, _, (ct1, ct2), (z1, z2) = setup
    key = ctx.relin_key_gen(sk, np.random.default_rng(9), method="bv")
    got = ctx.rescale(ctx.mul(ct1, ct2, key))
    jct = lambda c: j_ckks.Ciphertext(_jpoly(c.c0), _jpoly(c.c1), c.scale)
    want = jax.jit(lambda a, b, k: jctx.rescale(jctx.mul(a, b, k)))(jct(ct1), jct(ct2), _jbv(key))
    assert want.scale == got.scale
    _eq(want.c0.data, got.c0.data)
    _eq(want.c1.data, got.c1.data)
    np.testing.assert_allclose(ctx.decrypt(sk, got).real, z1 * z2, atol=1e-3)


def test_ckks_rotation_with_bv_keys_decrypts(setup):
    """rotation_key_gen(method="bv", digit_bits=8) for r = 1 and 3: the
    rotated slots within tests/test_keyswitch_bv.py's 0.02 (at this level
    a key switch's noise is its digits' size against the scale 2^28)."""
    ctx, _, sk, _, (ct, _), (z, _) = setup
    rot = ctx.rotation_key_gen(sk, [1, 3], np.random.default_rng(10), method="bv", digit_bits=8)
    assert all(isinstance(k, rlwe.BvEvalKey) for k in rot.values())
    for r in (1, 3):
        np.testing.assert_allclose(ctx.decrypt(sk, ctx.rotate(ct, r, rot)).real, np.roll(z, -r),
                                   atol=0.02)
    with pytest.raises(ValueError, match="hybrid"):
        ctx.relin_key_gen(sk, np.random.default_rng(10), method="gadget")


def test_convert_carries_a_bv_key(setup):
    ctx, _, sk, _, _, _ = setup
    key = ctx.relin_key_gen(sk, np.random.default_rng(11), method="bv", digit_bits=10)
    got = convert.bv_eval_key(key.b.numpy().astype(np.uint32), key.a.numpy().astype(np.uint32),
                              key.moduli, key.digit_bits, key.rows_per_limb, device="cpu")
    assert torch.equal(got.b, key.b) and torch.equal(got.a, key.a)
    assert (got.moduli, got.digit_bits, got.rows_per_limb) == (key.moduli, 10, key.rows_per_limb)
    with pytest.raises(ValueError, match="row count"):
        convert.bv_eval_key(key.b.numpy()[:-1], key.a.numpy()[:-1], key.moduli, 10,
                            key.rows_per_limb, device="cpu")


def test_bgv_mul_with_bv_key_decrypts():
    """BGV's BV key (noise scaled by t) relinearizes a product and switches
    a rotation; both decrypt exactly."""
    ctx = bgv.BgvContext.create(N=N, num_levels=2, dnum=2, device="cpu")
    rng = np.random.default_rng(SEED + 2)
    sk, pk = ctx.keygen(rng)
    key = ctx.relin_key_gen(sk, rng, method="bv", digit_bits=8)
    m = rng.integers(0, ctx.t, size=N)
    ct = ctx.encrypt(pk, m, rng)
    np.testing.assert_array_equal(ctx.decrypt(sk, ctx.mul(ct, ct, key)), m * m % ctx.t)
    rot = ctx.rotation_key_gen(sk, [2], rng, method="bv")
    i = np.arange(N)
    np.testing.assert_array_equal(ctx.decrypt(sk, ctx.rotate(ct, 2, rot)),
                                  m[((2 * i + 1) * 25 % (2 * N) - 1) // 2])
