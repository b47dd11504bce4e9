"""fhe_tpu_torch's BGV (pke/bgv.py, BGV's t-lift in lattice/rns.py and
pke/rlwe.py) against fhe_tpu on the CPU, byte for byte, at
tests/test_bgv.py's size (N = 256, t = 65537, num_levels = 3: Q 4 limbs of
28 bits, dnum = 2: P 2 limbs); the decrypted values against numpy; and the
port's decryption of the reference's BGV known-answer vectors.

fhe_tpu runs only jitted, one compiled function per op; its keygen and
encryption run jitted with the generator closed over, so their numpy draws
happen once, at trace time, in fhe_tpu's order.  The port runs with
device="cpu" (the plain NTTs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.math import ntt as j_ntt
from fhe_tpu.pke import bgv as j_bgv
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import bgv, encodings, rlwe
from test_torch_bfv import jencrypt, kat_phase

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
T = 65537
SEED = 41
KW = dict(N=N, num_levels=3, plain_mod=T, mod_bits=28, dnum=2)


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _jct(ct):
    return j_bgv.Ciphertext(_jpoly(ct.c0), _jpoly(ct.c1), pt_scale=ct.pt_scale)


def _jevk(k):
    return j_rlwe.EvalKey(b=_j(k.b), a=_j(k.a), moduli_qp=k.moduli_qp,
                          num_per_part=k.num_per_part)


def _same_ct(jct, ct):
    assert jct.c0.moduli == ct.c0.moduli and jct.pt_scale == ct.pt_scale
    _eq(jct.c0.data, ct.c0.data)
    _eq(jct.c1.data, ct.c1.data)


@pytest.fixture(scope="module")
def ctxs():
    return bgv.BgvContext.create(**KW, device="cpu"), j_bgv.BgvContext.create(**KW)


@pytest.fixture(scope="module")
def seeded(ctxs):
    """From SEED, in each package: keygen, the relinearization key and the
    encryption of m (noise scaled by t), then mul(ct, ct, evk)."""
    ctx, jctx = ctxs
    m = np.random.default_rng(SEED + 1).integers(0, T, size=N)
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    ct = ctx.encrypt(pk, m, rng)
    coeffs = bgv.encode(m, T, N, "cpu")

    def draws(gen):
        jsk, jpk = jctx.keygen(gen)
        jevk = jctx.relin_key_gen(jsk, gen)
        return jsk, jpk, jevk, jencrypt(jctx, j_bgv.Ciphertext, jpk, coeffs, gen, noise_scale=T)

    jrng = np.random.default_rng(SEED)
    jsk, jpk, jevk, jct = jax.jit(lambda: draws(jrng))()
    jmul = jax.jit(lambda c, k: jctx.mul(c, c, k))(jct, jevk)
    return (sk, pk, evk, ct), (jsk, jpk, jevk, jct), m, jmul


def test_keys_and_encryption_match_fhe_tpu(seeded):
    (sk, pk, evk, ct), (jsk, jpk, jevk, jct), _, _ = seeded
    _eq(jsk.s_eval_full, sk.s_eval_full)
    _eq(jpk.b.data, pk.b.data)
    _eq(jpk.a.data, pk.a.data)
    _eq(jevk.b, evk.b)
    _eq(jevk.a, evk.a)
    _same_ct(jct, ct)


def test_seeded_mul_matches_fhe_tpu(ctxs, seeded):
    """The slice as a whole: keygen, encrypt and a relinearized
    multiplication from one seed give fhe_tpu's ciphertext, which decrypts
    to m^2 mod t; carried over as arrays it is the port's."""
    ctx, _ = ctxs
    (sk, _, evk, ct), _, m, jmul = seeded
    out = ctx.mul(ct, ct, evk)
    _same_ct(jmul, out)
    np.testing.assert_array_equal(ctx.decrypt(sk, out), m * m % T)
    got = convert.bgv_ciphertext(np.asarray(jmul.c0.data), np.asarray(jmul.c1.data),
                                 jmul.moduli, jmul.pt_scale, device="cpu")
    assert torch.equal(got.c0.data, out.c0.data) and got.pt_scale == out.pt_scale


def test_encode_decode_match_fhe_tpu():
    """The packed encoding is fhe_tpu's mod-t NTT (its encode's inverse
    butterfly, its decode's forward one), and decode inverts encode."""
    m = np.random.default_rng(3).integers(0, T, size=N)
    plan = j_ntt.make_plan(N, T)
    inv, fwd = jax.jit(lambda v: (j_ntt.inverse_butterfly(plan, v),
                                  j_ntt.forward_butterfly(plan, v)))(jnp.asarray(m.astype(np.uint32)))
    np.testing.assert_array_equal(bgv.encode(m, T, N, "cpu"), np.asarray(inv))
    np.testing.assert_array_equal(bgv.decode(m, T, N, "cpu"), np.asarray(fwd))
    np.testing.assert_array_equal(bgv.decode(bgv.encode(m[:100], T, N, "cpu"), T, N, "cpu")[:100],
                                  m[:100])


@pytest.mark.parametrize("drop_q", [0, 1])
def test_mod_down_eval_matches_fhe_tpu(ctxs, drop_q):
    """BGV's EVAL-domain ModDown (dropped limbs lifted to a multiple of t),
    alone and fused with the drop of one q-limb, on random data over Q u P."""
    ctx, jctx = ctxs
    ext = tuple(ctx.params.moduli) + tuple(ctx.params.special_mods)
    gen = np.random.default_rng(17 + drop_q)
    data = np.stack([gen.integers(0, q, size=(2, N)) for q in ext], axis=-2)
    t = rns.RnsPoly(torch.from_numpy(data).to(torch.int32), ext, rns.EVAL)
    got = rlwe.mod_down_eval(ctx.params, t, drop_q)
    want = jax.jit(lambda x: j_rlwe.mod_down_eval(jctx.params, j_rns.RnsPoly(x, ext, j_rns.EVAL),
                                                  drop_q))(_j(t.data))
    assert got.moduli == want.moduli
    _eq(want.data, got.data)


def test_approx_mod_down_with_t_matches_fhe_tpu(ctxs):
    """approx_mod_down with t (and without), and key_switch_down_poly's
    COEFF branch, which takes t from BGV's parameters."""
    ctx, jctx = ctxs
    q_mods, p_mods = tuple(ctx.params.moduli), tuple(ctx.params.special_mods)
    gen = np.random.default_rng(19)
    data = np.stack([gen.integers(0, q, size=(2, N)) for q in q_mods + p_mods], axis=-2)
    x = rns.RnsPoly(torch.from_numpy(data).to(torch.int32), q_mods + p_mods, rns.COEFF)

    def fhe_tpu(d):
        jx = j_rns.RnsPoly(d, q_mods + p_mods, j_rns.COEFF)
        return (j_rns.approx_mod_down(jx, q_mods, p_mods, T),
                j_rns.approx_mod_down(jx, q_mods, p_mods),
                j_rlwe.key_switch_down_poly(jctx.params, jx))

    want = jax.jit(fhe_tpu)(_j(x.data))
    got = (rns.approx_mod_down(x, q_mods, p_mods, T), rns.approx_mod_down(x, q_mods, p_mods),
           rlwe.key_switch_down_poly(ctx.params, x))
    for w, g in zip(want, got):
        assert (w.moduli, w.fmt) == (g.moduli, g.fmt)
        _eq(w.data, g.data)


def test_mod_reduce_and_match_match_fhe_tpu(ctxs, seeded):
    """mod_reduce of the product twice (pt_scale q_L^-1 each time), and
    _match of the fresh ciphertext with the once-reduced product (the fresh
    one brought down a level and to the product's scale): fhe_tpu's bytes
    and scales; add at different levels and scales, and mul, decrypt."""
    ctx, jctx = ctxs
    (sk, _, evk, ct), _, m, jmul = seeded

    def fhe_tpu(p, c):
        r1 = jctx.mod_reduce(p)
        return (r1, jctx.mod_reduce(r1), *jctx._match(c, r1))

    want = jax.jit(fhe_tpu)(jmul, _jct(ct))
    r1 = ctx.mod_reduce(ctx.mul(ct, ct, evk))
    got = (r1, ctx.mod_reduce(r1), *ctx._match(ct, r1))
    for w, g in zip(want, got):
        _same_ct(w, g)
    red = got[1]
    assert red.pt_scale not in (1, r1.pt_scale) and len(red.moduli) == len(ct.moduli) - 2
    np.testing.assert_array_equal(ctx.decrypt(sk, red), m * m % T)
    np.testing.assert_array_equal(ctx.decrypt(sk, ctx.add(ct, red)), (m + m * m) % T)
    np.testing.assert_array_equal(ctx.decrypt(sk, ctx.mul(red, ct, evk)), m * m % T * m % T)


def test_rotate_matches_fhe_tpu(ctxs, seeded):
    """rotate by 1 with a HYBRID key (noise scaled by t): fhe_tpu's bytes;
    the slots move as the automorphism 5 moves the mod-t NTT's points."""
    ctx, jctx = ctxs
    (sk, _, _, ct), _, m, _ = seeded
    rot = ctx.rotation_key_gen(sk, [1], np.random.default_rng(SEED + 3))
    got = ctx.rotate(ct, 1, rot)
    _same_ct(jax.jit(lambda c, k: jctx.rotate(c, 1, {1: k}))(_jct(ct), _jevk(rot[1])), got)
    i = np.arange(N)
    np.testing.assert_array_equal(ctx.decrypt(sk, got), m[((2 * i + 1) * 5 % (2 * N) - 1) // 2])


def test_leveled_ops_decrypt(ctxs, seeded):
    """sub, add_plain and mul_plain (also after a mod_reduce: add_plain
    scales the plaintext by pt_scale), the unrelinearized product, coef
    encoding, and the refusal to mod-reduce a degree-2 ciphertext."""
    ctx, _ = ctxs
    (sk, pk, evk, ct), _, m, _ = seeded
    w = np.arange(N) % 11
    dec = lambda c, **kw: ctx.decrypt(sk, c, **kw)
    red = ctx.mod_reduce(ct)
    np.testing.assert_array_equal(dec(ctx.sub(ct, red)), np.zeros(N, dtype=np.int64))
    np.testing.assert_array_equal(dec(ctx.add_plain(red, w)), (m + w) % T)
    np.testing.assert_array_equal(dec(ctx.mul_plain(red, w)), m * w % T)
    prod = ctx.mul(ct, ct)
    np.testing.assert_array_equal(dec(prod), m * m % T)
    with pytest.raises(ValueError, match="relinearized"):
        ctx.add(prod, red)
    rng = np.random.default_rng(SEED + 4)
    v = np.arange(-20, 20)
    c = ctx.encrypt(pk, v, rng, encoding="coef")
    np.testing.assert_array_equal(dec(ctx.add(c, c), encoding="coef")[:40], 2 * v)


def test_decrypt_reference_kat():
    """The reference's BGV vectors (N = 4096, three 45-bit moduli,
    coefficient-packed) through the port's decryption and decoding."""
    big, Q, t, msg = kat_phase("bgv")
    got = encodings.decode_coef_packed(bgv.plain_coeffs(big, Q, t), t, signed=False)
    np.testing.assert_array_equal(got, msg.astype(np.int64))
