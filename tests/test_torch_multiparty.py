"""fhe_tpu_torch's multiparty threshold PKE (pke/multiparty.py, evk_gen's
a_common) against fhe_tpu on the CPU, at tests/test_multiparty.py's sizes
(N = 256): its 8 tests on the port, each decoded within fhe_tpu's own
tolerance there, and the ring data byte for byte from one seed: the joint
keygen, the joint relinearization and rotation keys, the shares with the
flood set to 0, the IntBoot and IntMPBoot shares and refreshed
ciphertexts.

The flooding deviate is the one draw the packages do not share: fhe_tpu
samples it with jax.random threefry, the port with a torch.Generator, both
seeded by the same single numpy draw.  So shares are held equal through
fhe_tpu's `_share_fn` / `_pipeline_fn` at sd = 0.0, the host stream is
held in step after a share, and the port's deviate is held to its standard
deviation.

fhe_tpu runs jitted where it can (key generation with the generator closed
over: its draws happen once, at trace time).  Its IntBoot steps read ring
data on the host and run eagerly; for the module's duration fhe_tpu's
`rns.to_eval` / `to_coeff` are their jitted selves, since eager XLA
compiles the transform op by op (about 12 s a shape on the CPU).  The port
runs with device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import multiparty as j_mp
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import bgv, ckks, multiparty, rlwe

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SEED = 41
CKKS4 = dict(N=N, num_levels=4, scale_bits=28, dnum=2)     # tests/test_multiparty.py:15
CKKS6 = dict(N=N, num_levels=6, scale_bits=26, dnum=2)     # :139, :160
BGV2 = dict(N=N, num_levels=2, plain_mod=65537, mod_bits=28, dnum=2)


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _jct(ct):
    return j_ckks.Ciphertext(_jpoly(ct.c0), _jpoly(ct.c1), ct.scale)


def _jsk(sk):
    return j_rlwe.SecretKey(s_signed=jnp.asarray(sk.s_signed.numpy()),
                            s_eval_full=_j(sk.s_eval_full), moduli_full=sk.moduli_full)


def _same_key(jk, k):
    assert jk.moduli_qp == k.moduli_qp
    _eq(jk.b, k.b)
    _eq(jk.a, k.a)


def _same_ct(jct, ct):
    assert jct.c0.moduli == ct.c0.moduli and jct.scale == ct.scale
    _eq(jct.c0.data, ct.c0.data)
    _eq(jct.c1.data, ct.c1.data)


def _threshold_decrypt(ctx, sks, ct, rng):
    """Lead, mains, fusion and the CKKS decode (fhe_tpu's test helper)."""
    lead = multiparty.decrypt_lead(ctx.params, sks[0], ct.c0, ct.c1, rng)
    mains = [multiparty.decrypt_main(ctx.params, sk, ct.c1, rng) for sk in sks[1:]]
    ph = multiparty.fuse([lead] + mains)
    m = ckks._center(rns.to_bigint(ph), rns.modulus_product(ct.moduli))
    return ckks.decode(m, ctx.params.N, ct.scale)


@pytest.fixture(scope="module", autouse=True)
def _jitted_fhe_tpu_ntts():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rns, "to_eval", jax.jit(j_rns.to_eval))
        mp.setattr(j_rns, "to_coeff", jax.jit(j_rns.to_coeff))
        yield


def _zero_flood(*shape):
    return torch.zeros(shape, dtype=torch.int64)


@pytest.fixture(scope="module")
def ckks4():
    """CKKS at N = 256, 4 levels: both contexts, the port's 3-party joint
    keys from SEED and fhe_tpu's (jitted, the generator closed over)."""
    ctx, jctx = ckks.CkksContext.create(**CKKS4, device="cpu"), j_ckks.CkksContext.create(**CKKS4)
    rng = np.random.default_rng(SEED)
    sks, pk = multiparty.multiparty_keygen(ctx.params, 3, rng, device="cpu")
    jrng = np.random.default_rng(SEED)
    jsks, jpk = jax.jit(lambda: j_mp.multiparty_keygen(jctx.params, 3, jrng))()
    return ctx, jctx, (sks, pk, rng), (jsks, jpk, jrng)


def test_ckks_3party(ckks4):
    """multiparty_keygen draws as fhe_tpu's (3 secrets, the common a, the
    joint b); lead + 2 mains + fusion decode z within fhe_tpu's 0.6 (the
    2^20 flood at a 28-bit scale); after decrypt_lead the host generator
    of each package gives the same next draw."""
    ctx, jctx, (sks, pk, rng), (jsks, jpk, jrng) = ckks4
    for jsk, sk in zip(jsks, sks):
        _eq(jsk.s_signed, sk.s_signed)
        _eq(jsk.s_eval_full, sk.s_eval_full)
    _eq(jpk.b.data, pk.b.data)
    _eq(jpk.a.data, pk.a.data)
    assert rng.integers(1 << 62) == jrng.integers(1 << 62)

    gen = np.random.default_rng(SEED + 1)
    z = gen.normal(size=N // 2)
    ct = ctx.encrypt(pk, z, gen)
    np.testing.assert_allclose(_threshold_decrypt(ctx, sks, ct, gen).real, z, atol=0.6)

    r_port, r_jax = np.random.default_rng(3), np.random.default_rng(3)
    multiparty.decrypt_lead(ctx.params, sks[0], ct.c0, ct.c1, r_port)
    jct = _jct(ct)
    j_mp.decrypt_lead(jctx.params, jsks[0], jct.c0, jct.c1, r_jax)
    assert r_port.integers(1 << 62) == r_jax.integers(1 << 62)


def test_ckks_3party_after_mult(ckks4):
    """The add-only homomorphism under the joint key, within fhe_tpu's 0.8."""
    ctx, _, (sks, pk, _), _ = ckks4
    rng = np.random.default_rng(SEED + 2)
    z1, z2 = rng.normal(size=N // 2), rng.normal(size=N // 2)
    cts = ctx.add(ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng))
    np.testing.assert_allclose(_threshold_decrypt(ctx, sks, cts, rng).real, z1 + z2, atol=0.8)


@pytest.mark.parametrize("lead", [True, False])
def test_shares_match_fhe_tpu_with_the_flood_at_0(ckks4, lead):
    """A lead and a main share with the flood set to 0: the port's `_share`
    against fhe_tpu's `_share_fn` at sd = 0.0, byte for byte."""
    ctx, _, (sks, pk, _), _ = ckks4
    rng = np.random.default_rng(SEED + 3)
    ct = ctx.encrypt(pk, rng.normal(size=N // 2), rng)
    mods = tuple(ct.moduli)
    s = sks[1].eval_poly(mods)
    got = multiparty._share(mods, 1, lead, s.data, ct.c1.data, ct.c0.data, _zero_flood(N))
    want = j_mp._share_fn(mods, N, 1, lead, 0.0)(_j(s.data), _j(ct.c1.data), _j(ct.c0.data),
                                                 jax.random.key(7))
    _eq(want, got)


def test_bgv_5party():
    """BGV 5-party threshold decrypt exact (fhe_tpu's test, the port
    alone); the lead share with the flood at 0 and ns = t byte-equal to
    fhe_tpu's `_share_fn`."""
    ctx = bgv.BgvContext.create(**BGV2, device="cpu")
    rng = np.random.default_rng(SEED + 4)
    sks, pk = multiparty.multiparty_keygen(ctx.params, 5, rng, device="cpu")
    m = rng.integers(0, 65537, size=N)
    ct = ctx.encrypt(pk, m, rng)
    lead = multiparty.decrypt_lead(ctx.params, sks[0], ct.c0, ct.c1, rng)
    mains = [multiparty.decrypt_main(ctx.params, sk, ct.c1, rng) for sk in sks[1:]]
    big = rns.to_bigint(multiparty.fuse([lead] + mains))
    coeffs = bgv.plain_coeffs(big, rns.modulus_product(ct.moduli), 65537)
    np.testing.assert_array_equal(bgv.decode(coeffs, 65537, N, device="cpu"), m % 65537)

    mods = tuple(ct.moduli)
    s = sks[0].eval_poly(mods)
    got = multiparty._share(mods, 65537, True, s.data, ct.c1.data, ct.c0.data, _zero_flood(N))
    want = j_mp._share_fn(mods, N, 65537, True, 0.0)(_j(s.data), _j(ct.c1.data),
                                                     _j(ct.c0.data), jax.random.key(7))
    _eq(want, got)


@pytest.fixture(scope="module")
def pair():
    """A 2-party joint key at N = 256, 4 levels (the port's; fhe_tpu gets
    the carried secrets)."""
    ctx, jctx = ckks.CkksContext.create(**CKKS4, device="cpu"), j_ckks.CkksContext.create(**CKKS4)
    rng = np.random.default_rng(SEED + 5)
    sks, pk = multiparty.multiparty_keygen(ctx.params, 2, rng, device="cpu")
    return ctx, jctx, sks, pk


def _relin_chain(mp, rl, params, sks, rng):
    """fhe_tpu's test_joint_relin_key rounds, in either package."""
    mods = tuple(params.moduli)
    evk1 = rl.evk_gen(params, sks[0].eval_poly(mods), sks[0], rng)
    evk2 = mp.multi_key_switch_gen(params, sks[1].eval_poly(mods), sks[1], evk1, rng)
    evk_ab = mp.multi_add_eval_keys(evk1, evk2)
    sh1 = mp.multi_mult_eval_key(params, evk_ab, sks[0], rng)
    sh2 = mp.multi_mult_eval_key(params, evk_ab, sks[1], rng)
    return evk_ab, mp.multi_add_eval_mult_keys(sh1, sh2)


def test_joint_relin_key(pair):
    """MultiKeySwitchGen -> MultiAddEvalKeys -> MultiMultEvalKey x 2 ->
    MultiAddEvalMultKeys: the (s -> s) and (s^2 -> s) joint keys byte-equal
    to fhe_tpu's from one seed; mul + rescale under the joint key decodes
    within fhe_tpu's 0.8 by threshold decryption."""
    ctx, jctx, sks, pk = pair
    evk_ab, rlk = _relin_chain(multiparty, rlwe, ctx.params, sks, np.random.default_rng(SEED + 6))
    jrng = np.random.default_rng(SEED + 6)
    jab, jrlk = jax.jit(lambda ks: _relin_chain(j_mp, j_rlwe, jctx.params, ks, jrng))(
        [_jsk(sk) for sk in sks])
    _same_key(jab, evk_ab)
    _same_key(jrlk, rlk)

    rng = np.random.default_rng(SEED + 7)
    z1, z2 = rng.normal(size=N // 2) * 0.5, rng.normal(size=N // 2) * 0.5
    prod = ctx.rescale(ctx.mul(ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng), rlk))
    np.testing.assert_allclose(_threshold_decrypt(ctx, sks, prod, rng).real, z1 * z2, atol=0.8)


def _rotation_chain(mp, rl, rns_mod, params, sks, rng):
    mods = tuple(params.moduli)
    k = pow(5, 1, 2 * N)
    rk1 = {1: rl.evk_gen(params, rns_mod.automorphism(sks[0].eval_poly(mods), k), sks[0], rng)}
    rk2 = mp.multi_eval_automorphism_key_gen(params, sks[1], rk1, {1: k}, rng)
    return mp.multi_add_eval_automorphism_keys(rk1, rk2)


def test_joint_rotation_key(pair):
    """MultiEvalAutomorphismKeyGen + MultiAddEvalAutomorphismKeys: the joint
    rotation key byte-equal to fhe_tpu's; EvalRotate under the joint secret
    within fhe_tpu's 0.8."""
    ctx, jctx, sks, pk = pair
    rkj = _rotation_chain(multiparty, rlwe, rns, ctx.params, sks, np.random.default_rng(SEED + 8))
    jrng = np.random.default_rng(SEED + 8)
    jrkj = jax.jit(lambda ks: _rotation_chain(j_mp, j_rlwe, j_rns, jctx.params, ks, jrng))(
        [_jsk(sk) for sk in sks])
    _same_key(jrkj[1], rkj[1])

    rng = np.random.default_rng(SEED + 9)
    z = rng.normal(size=N // 2)
    rot = ctx.rotate(ctx.encrypt(pk, z, rng), 1, rkj)
    np.testing.assert_allclose(_threshold_decrypt(ctx, sks, rot, rng).real, np.roll(z, -1),
                               atol=0.8)


@pytest.fixture(scope="module")
def boot():
    """N = 256, 6 levels, scale 2^26 (fhe_tpu's IntBoot tests): the port's
    2-party joint key and a fresh ciphertext of z."""
    ctx, jctx = ckks.CkksContext.create(**CKKS6, device="cpu"), j_ckks.CkksContext.create(**CKKS6)
    rng = np.random.default_rng(SEED + 10)
    sks, pk = multiparty.multiparty_keygen(ctx.params, 2, rng, device="cpu")
    z = rng.normal(size=N // 2) * 0.5
    return ctx, jctx, sks, pk, z, ctx.encrypt(pk, z, rng)


def test_int_boot_2party(boot):
    """IntBoot (interactive-bootstrapping.cpp:115-135): the server's and
    client's rounded shares, the client's re-encryption and the server's
    add byte-equal to fhe_tpu's (eager, from the same seed); the refreshed
    ciphertext decodes within fhe_tpu's 1.2."""
    ctx, jctx, sks, pk, z, ct = boot
    low = multiparty.int_boot_adjust_scale(ctx, ct, extra_limbs=1)
    assert len(low.moduli) == 2
    h1 = multiparty.int_boot_decrypt(ctx.params, sks[0], low.c0, low.c1)
    h2 = multiparty.int_boot_decrypt(ctx.params, sks[1], low.c1)
    fresh = multiparty.int_boot_encrypt(ctx.params, pk, h2, low, np.random.default_rng(5))
    out = multiparty.int_boot_add(ctx.params, fresh, h1)
    assert len(out.moduli) == len(ctx.params.moduli)

    jlow = j_mp.int_boot_adjust_scale(jctx, _jct(ct), extra_limbs=1)
    _same_ct(jlow, low)
    jsks = [_jsk(sk) for sk in sks]
    jh1 = j_mp.int_boot_decrypt(jctx.params, jsks[0], jlow.c0, jlow.c1)
    jh2 = j_mp.int_boot_decrypt(jctx.params, jsks[1], jlow.c1)
    _eq(jh1.data, h1.data)
    _eq(jh2.data, h2.data)
    jpk = j_rlwe.PublicKey(b=_jpoly(pk.b), a=_jpoly(pk.a))
    jfresh = j_mp.int_boot_encrypt(jctx.params, jpk, jh2, jlow, np.random.default_rng(5))
    _same_ct(jfresh, fresh)
    _same_ct(j_mp.int_boot_add(jctx.params, jfresh, jh1), out)

    got = _threshold_decrypt(ctx, sks, out, np.random.default_rng(SEED + 11))
    np.testing.assert_allclose(got.real, z, atol=1.2)


def test_polynomial_round_is_fhe_tpu_s_on_every_quadrant():
    """PolynomialRound on random residues over a 2-limb basis (every
    quadrant of Qc, both sides of each cut): equal to fhe_tpu's."""
    mods = tuple(ckks.CkksContext.create(**CKKS6, device="cpu").params.moduli[:2])
    gen = np.random.default_rng(SEED + 12)
    data = np.stack([gen.integers(0, q, size=(3, N)) for q in mods], axis=-2)
    p = rns.RnsPoly(torch.from_numpy(data.astype(np.int32)), mods, rns.COEFF)
    want = j_mp._polynomial_round(j_rns.RnsPoly(jnp.asarray(data.astype(np.uint32)), mods,
                                                j_rns.COEFF))
    _eq(want.data, multiparty._polynomial_round(p).data)
    with pytest.raises(ValueError, match="2-limb COEFF"):
        multiparty._polynomial_round(rns.RnsPoly(p.data, mods, rns.EVAL))


def test_interactive_mp_bootstrap(boot):
    """IntMPBoot: the common a and each party's (h0, h1) shares byte-equal
    to fhe_tpu's (jitted, the generator closed over), the aggregate and the
    refreshed full-chain ciphertext too (eager); the joint decrypt within
    fhe_tpu's 1.2."""
    ctx, jctx, sks, pk, z, ct = boot
    low = multiparty.int_boot_adjust_scale(ctx, ct)
    assert len(low.moduli) == ctx.cd + 2
    rng = np.random.default_rng(SEED + 13)
    a = multiparty.int_mp_boot_random_gen(ctx.params, rng, device="cpu")
    shares = [multiparty.int_mp_boot_decrypt(ctx.params, sk, low, a, rng) for sk in sks]
    agg = multiparty.int_mp_boot_add(shares)
    fresh = multiparty.int_mp_boot_encrypt(ctx.params, low, agg, a)
    assert len(fresh.moduli) == len(ctx.params.moduli)

    jrng = np.random.default_rng(SEED + 13)

    def draws(jsks, jlow):
        ja = j_mp.int_mp_boot_random_gen(jctx.params, jrng)
        return ja, [j_mp.int_mp_boot_decrypt(jctx.params, s, jlow, ja, jrng) for s in jsks]

    jlow = _jct(low)
    ja, jshares = jax.jit(lambda ks, c: (lambda x: (x[0], [(s.h0, s.h1) for s in x[1]]))(
        draws(ks, c)))([_jsk(sk) for sk in sks], jlow)
    jshares = [j_mp.IntBootShares(h0=h0, h1=h1, n_parties=2) for h0, h1 in jshares]
    _eq(ja.data, a.data)
    for js, s in zip(jshares, shares):
        _eq(js.h0.data, s.h0.data)
        _eq(js.h1.data, s.h1.data)
    jagg = j_mp.int_mp_boot_add(jshares)
    _same_ct(j_mp.int_mp_boot_encrypt(jctx.params, jlow, jagg, ja), fresh)

    got = _threshold_decrypt(ctx, sks, fresh, np.random.default_rng(SEED + 14))
    np.testing.assert_allclose(got.real, z, atol=1.2)


def test_threshold_decrypt_pipeline(ckks4):
    """The one-call pipeline decodes within fhe_tpu's 0.8 at 3 parties; at
    flood 0 it is fhe_tpu's `_pipeline_fn` at sd = 0.0 byte for byte; and
    with the same deviates it is the fusion of the protocol's shares."""
    ctx, _, (sks, pk, _), _ = ckks4
    rng = np.random.default_rng(SEED + 15)
    z = rng.normal(size=N // 2)
    ct = ctx.encrypt(pk, z, rng)
    ph = multiparty.threshold_decrypt_pipeline(ctx.params, sks, ct.c0, ct.c1, rng)
    Q = rns.modulus_product(ct.moduli)
    got = ckks.decode(ckks._center(rns.to_bigint(ph), Q), N, ct.scale)
    np.testing.assert_allclose(got.real, z, atol=0.8)

    mods = tuple(ct.moduli)
    s_stack = torch.stack([sk.eval_poly(mods).data for sk in sks])
    zero = multiparty._pipeline(mods, 1, s_stack, ct.c0.data, ct.c1.data, _zero_flood(3, N))
    want = j_mp._pipeline_fn(mods, N, 1, 3, 0.0)(_j(s_stack), _j(ct.c0.data), _j(ct.c1.data),
                                                 jax.random.key(7))
    _eq(want, zero)

    e = multiparty._flood(11, (3, N), multiparty.MP_SD, "cpu")
    whole = multiparty._pipeline(mods, 1, s_stack, ct.c0.data, ct.c1.data, e)
    shares = [multiparty.PartialDecryption(rns.RnsPoly(multiparty._share(
        mods, 1, i == 0, s_stack[i], ct.c1.data, ct.c0.data, e[i]), mods, rns.EVAL), i == 0)
        for i in range(3)]
    assert torch.equal(multiparty.fuse(shares).data, whole)


def test_flood_deviate():
    """The port's flood: round(normal x 2^20) int64, its sample standard
    deviation within 2 % of 2^20 over 5 x 4096 draws (the [mp] phase's
    count), its mean near 0; the same seed gives the same deviates, another
    seed others."""
    e = multiparty._flood(123, (5, 4096), multiparty.MP_SD, "cpu")
    assert e.dtype == torch.int64
    sd = float(e.double().std())
    assert abs(sd / multiparty.MP_SD - 1) < 0.02, sd
    assert abs(float(e.double().mean())) < 5 * multiparty.MP_SD / np.sqrt(e.numel())
    assert torch.equal(e, multiparty._flood(123, (5, 4096), multiparty.MP_SD, "cpu"))
    assert not torch.equal(e, multiparty._flood(124, (5, 4096), multiparty.MP_SD, "cpu"))


def test_carried_shares_and_fusion_rules(ckks4):
    """convert: fhe_tpu's partial decryptions (flood from threefry, which no
    seed rebuilds here) and IntBoot shares as numpy arrays give the port's
    objects; the port's fusion of fhe_tpu's shares is fhe_tpu's; a fusion
    without exactly one lead raises."""
    ctx, jctx, (sks, pk, _), (jsks, _, _) = ckks4
    rng = np.random.default_rng(SEED + 16)
    ct = ctx.encrypt(pk, rng.normal(size=N // 2), rng)
    jct = _jct(ct)
    jshares = [j_mp.decrypt_lead(jctx.params, jsks[0], jct.c0, jct.c1, rng)] + [
        j_mp.decrypt_main(jctx.params, s, jct.c1, rng) for s in jsks[1:]]
    carried = [convert.partial_decryption(np.asarray(s.share.data), s.share.moduli, s.is_lead,
                                          device="cpu") for s in jshares]
    _eq(j_mp.fuse(jshares).data, multiparty.fuse(carried).data)
    with pytest.raises(ValueError, match="exactly one lead"):
        multiparty.fuse(carried[1:])
    h = multiparty.IntBootShares(h0=ct.c0, h1=ct.c1, n_parties=3)
    got = convert.int_boot_shares(np.asarray(_j(h.h0.data)), h.h0.moduli, np.asarray(_j(h.h1.data)),
                                  h.h1.moduli, 3, device="cpu")
    assert torch.equal(got.h0.data, h.h0.data) and torch.equal(got.h1.data, h.h1.data)
    assert got.n_parties == 3
