"""fhe_tpu_torch's BFV (pke/bfv.py, the HPS / BEHZ kit of lattice/rns.py)
against fhe_tpu on the CPU, byte for byte, at tests/test_bfv.py's size (N =
256, 3 limbs of 28 bits, t = 65537, dnum = 2: P 2 limbs, R and Bsk 5); the
decrypted values against numpy; the coefficient and string encodings; and
the port's decryption of the reference's BFV known-answer vectors.

fhe_tpu runs only jitted, one compiled function per op; its keygen and
encryption run jitted with the generator closed over, so their numpy draws
happen once, at trace time, in fhe_tpu's order.  The port runs with
device="cpu" (the plain NTTs).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import bfv as j_bfv
from fhe_tpu.pke import encodings as j_enc
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import bfv, encodings

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
T = 65537
SEED = 31
KW = dict(N=N, num_limbs=3, plain_mod=T, mod_bits=28, dnum=2)
VEC = os.path.join(os.path.dirname(__file__), "vectors")


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _jct(ct):
    return j_bfv.Ciphertext(_jpoly(ct.c0), _jpoly(ct.c1))


def _jevk(k):
    return j_rlwe.EvalKey(b=_j(k.b), a=_j(k.a), moduli_qp=k.moduli_qp,
                          num_per_part=k.num_per_part)


def _same_ct(jct, ct):
    assert jct.c0.moduli == ct.c0.moduli
    _eq(jct.c0.data, ct.c0.data)
    _eq(jct.c1.data, ct.c1.data)
    assert (jct.c2 is None) == (ct.c2 is None)


def _random_poly(gen, moduli, lead=(2,)):
    data = np.stack([gen.integers(0, q, size=lead + (N,)) for q in moduli], axis=-2)
    return rns.RnsPoly(torch.from_numpy(data).to(torch.int32), tuple(moduli), rns.COEFF)


def jencrypt(jctx, ciphertext, pk, coeffs, rng, scale: int = 1, **kw):
    """fhe_tpu's encryption of the plaintext of coefficients `coeffs` (the
    packed encoding's output) times `scale`, to be jitted: its
    make_plaintext without the encoding, whose numpy conversion cannot be
    traced (test_torch_bgv.py holds the port's encode to fhe_tpu's NTT),
    then encrypt_pk, which draws as encrypt does."""
    mods = tuple(jctx.params.moduli)
    pt = j_rns.mul_scalar(j_rlwe.signed_to_rns(coeffs, mods), scale)
    return ciphertext(*j_rlwe.encrypt_pk(jctx.params, pk, j_rns.to_eval(pt), rng, **kw))


@pytest.fixture(scope="module")
def ctxs():
    return bfv.BfvContext.create(**KW, device="cpu"), j_bfv.BfvContext.create(**KW)


@pytest.fixture(scope="module")
def seeded(ctxs):
    """From SEED, in each package: keygen, the relinearization key and the
    encryption of m (one draw order), then mul(ct, ct, evk) of each."""
    ctx, jctx = ctxs
    m = np.random.default_rng(SEED + 1).integers(0, 100, size=N)
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    ct = ctx.encrypt(pk, m, rng)
    coeffs = bfv.bgv.encode(m, T, N, "cpu")

    def draws(gen):
        jsk, jpk = jctx.keygen(gen)
        jevk = jctx.relin_key_gen(jsk, gen)
        return jsk, jpk, jevk, jencrypt(jctx, j_bfv.Ciphertext, jpk, coeffs, gen, jctx.Q // T)

    jrng = np.random.default_rng(SEED)
    jsk, jpk, jevk, jct = jax.jit(lambda: draws(jrng))()
    jmul = jax.jit(lambda c, k: jctx.mul(c, c, k))(jct, jevk)
    return (sk, pk, evk, ct), (jsk, jpk, jevk, jct), m, jmul


def test_keys_and_encryption_match_fhe_tpu(seeded):
    (sk, pk, evk, ct), (jsk, jpk, jevk, jct), _, _ = seeded
    _eq(jsk.s_signed, sk.s_signed)
    _eq(jsk.s_eval_full, sk.s_eval_full)
    _eq(jpk.b.data, pk.b.data)
    _eq(jpk.a.data, pk.a.data)
    _eq(jevk.b, evk.b)
    _eq(jevk.a, evk.a)
    _same_ct(jct, ct)


def test_seeded_mul_matches_fhe_tpu(ctxs, seeded):
    """The slice as a whole: keygen, encrypt and a relinearized HPS
    multiplication from one seed give fhe_tpu's ciphertext, which
    decrypts to m^2 mod t."""
    ctx, _ = ctxs
    (sk, _, evk, ct), _, m, jmul = seeded
    out = ctx.mul(ct, ct, evk)
    _same_ct(jmul, out)
    np.testing.assert_array_equal(ctx.decrypt(sk, out), m * m % T)


def test_convert_carries_bfv_ciphertexts(ctxs, seeded):
    """fhe_tpu's seeded product carried over as arrays is the port's; a
    ciphertext with c2 carries its three components."""
    ctx, _ = ctxs
    (sk, _, evk, ct), _, m, jmul = seeded
    arrays = lambda c: [np.asarray(getattr(c, k).data) for k in ("c0", "c1")]
    got = convert.bfv_ciphertext(*arrays(jmul), jmul.moduli, device="cpu")
    want = ctx.mul(ct, ct, evk)
    assert got.c2 is None and got.moduli == want.moduli
    assert torch.equal(got.c0.data, want.c0.data) and torch.equal(got.c1.data, want.c1.data)
    prod = ctx.mul(ct, ct)
    back = convert.bfv_ciphertext(*[getattr(prod, k).data.numpy() for k in ("c0", "c1")],
                                  prod.moduli, c2=prod.c2.data.numpy(), device="cpu")
    assert torch.equal(back.c2.data, prod.c2.data)
    np.testing.assert_array_equal(ctx.decrypt(sk, back), m * m % T)


@pytest.fixture(scope="module")
def pair(ctxs, seeded):
    """A second ciphertext, of m2, under the seeded key."""
    ctx, _ = ctxs
    (_, pk, _, _), _, _, _ = seeded
    rng = np.random.default_rng(SEED + 2)
    m2 = rng.integers(0, T, size=N)
    return ctx.encrypt(pk, m2, rng), m2


def test_mul_decrypts(ctxs, seeded, pair):
    """mul of two ciphertexts by either technique, relinearized or with
    c2, and square: m m2 (m^2) mod t.  (fhe_tpu's bytes: HPS above, BEHZ in
    test_torch_keyswitch_bv.py.)"""
    ctx, _ = ctxs
    (sk, _, evk, ct), _, m, _ = seeded
    ct2, m2 = pair
    for technique in ("hps", "behz"):
        for key in (evk, None):
            got = ctx.mul(ct, ct2, key, technique=technique)
            assert (got.c2 is None) == (key is not None)
            np.testing.assert_array_equal(ctx.decrypt(sk, got), m * m2 % T)
        np.testing.assert_array_equal(ctx.decrypt(sk, ctx.square(ct, evk, technique)), m * m % T)


def test_rotate_matches_fhe_tpu(ctxs, seeded):
    """rotate by 1 with a HYBRID key: fhe_tpu's bytes; the slots move as
    the automorphism 5 moves the mod-t NTT's points."""
    ctx, jctx = ctxs
    (sk, _, _, ct), _, m, _ = seeded
    rot = ctx.rotation_key_gen(sk, [1], np.random.default_rng(SEED + 3))
    got = ctx.rotate(ct, 1, rot)
    _same_ct(jax.jit(lambda c, k: jctx.rotate(c, 1, {1: k}))(_jct(ct), _jevk(rot[1])), got)
    i = np.arange(N)
    np.testing.assert_array_equal(ctx.decrypt(sk, got), m[((2 * i + 1) * 5 % (2 * N) - 1) // 2])


def test_leveled_ops_decrypt(ctxs, seeded, pair):
    """add, sub, add_plain, mul_plain and dot_product against numpy."""
    ctx, _ = ctxs
    (sk, _, _, ct), _, m, _ = seeded
    ct2, m2 = pair
    w = np.arange(N) % 7
    dec = lambda c: ctx.decrypt(sk, c)
    np.testing.assert_array_equal(dec(ctx.add(ct, ct2)), (m + m2) % T)
    np.testing.assert_array_equal(dec(ctx.sub(ct, ct2)), (m - m2) % T)
    np.testing.assert_array_equal(dec(ctx.add_plain(ct, w)), (m + w) % T)
    np.testing.assert_array_equal(dec(ctx.mul_plain(ct, w)), m * w % T)
    np.testing.assert_array_equal(dec(ctx.dot_product([ct, ct2], [w, w + 1])),
                                  (m * w + m2 * (w + 1)) % T)


# ---------------------------------------------------------------------------
# the HPS / BEHZ kit of lattice/rns.py
# ---------------------------------------------------------------------------

def test_scale_and_round_matches_fhe_tpu(ctxs):
    ctx, jctx = ctxs
    q_mods, r_mods = tuple(ctx.params.moduli), bfv.aux_basis(ctx.params)
    assert r_mods == jctx._aux_basis()
    p = _random_poly(np.random.default_rng(5), q_mods + r_mods)
    want = jax.jit(lambda x: j_rns.scale_and_round_t_over_q(
        j_rns.RnsPoly(x, q_mods + r_mods, j_rns.COEFF), q_mods, r_mods, T))(_j(p.data))
    got = rns.scale_and_round_t_over_q(p, q_mods, r_mods, T)
    assert got.moduli == want.moduli == r_mods
    _eq(want.data, got.data)


def test_behz_conversions_match_fhe_tpu(ctxs):
    """fast_base_conv_q_to_bsk on random residues over q, fast_rns_floor_q
    of residues over q and Bsk, fast_base_conv_sk of residues over Bsk."""
    ctx, _ = ctxs
    q_mods, bsk = tuple(ctx.params.moduli), bfv.aux_basis(ctx.params)
    gen = np.random.default_rng(6)
    x_q, x_k = _random_poly(gen, q_mods), _random_poly(gen, bsk)

    def fhe_tpu(xq, xk):
        jq, jk = j_rns.RnsPoly(xq, q_mods, j_rns.COEFF), j_rns.RnsPoly(xk, bsk, j_rns.COEFF)
        return (j_rns.fast_base_conv_q_to_bsk(jq, bsk), j_rns.fast_rns_floor_q(jq, jk),
                j_rns.fast_base_conv_sk(jk, q_mods))

    want = jax.jit(fhe_tpu)(_j(x_q.data), _j(x_k.data))
    got = (rns.fast_base_conv_q_to_bsk(x_q, bsk), rns.fast_rns_floor_q(x_q, x_k),
           rns.fast_base_conv_sk(x_k, q_mods))
    for w, g in zip(want, got):
        assert w.moduli == g.moduli
        _eq(w.data, g.data)


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

def test_encodings_match_fhe_tpu():
    """The port's copy of fhe_tpu/pke/encodings.py gives its outputs."""
    v = np.array([-5, 0, 7, 32768, -32768])
    np.testing.assert_array_equal(encodings.encode_coef_packed(v, T, 16),
                                  j_enc.encode_coef_packed(v, T, 16))
    c = encodings.encode_coef_packed(v, T, 16)
    np.testing.assert_array_equal(encodings.decode_coef_packed(c, T, 5), v)
    assert encodings.decode_string(encodings.encode_string("homomorphic", 32)) == "homomorphic"
    np.testing.assert_array_equal(encodings.encode_string(b"\x01ab", 8),
                                  j_enc.encode_string(b"\x01ab", 8))
    with pytest.raises(ValueError):
        encodings.encode_string("x", 8, t=257)
    with pytest.raises(ValueError):
        encodings.encode_coef_packed(np.array([T]), T, 8)


def test_coef_and_string_encodings_round_trip():
    """BFV with coefficient packing (add) and, at t = 256, strings."""
    ctx = bfv.BfvContext.create(N=N, num_limbs=2, device="cpu")
    rng = np.random.default_rng(8)
    sk, pk = ctx.keygen(rng)
    a, b = np.arange(-10, 10), np.arange(20)
    s = ctx.add(ctx.encrypt(pk, a, rng, encoding="coef"), ctx.encrypt(pk, b, rng, encoding="coef"))
    np.testing.assert_array_equal(ctx.decrypt(sk, s, encoding="coef")[:20], a + b)
    sctx = bfv.BfvContext.create(N=N, num_limbs=2, plain_mod=256, device="cpu")
    sk, pk = sctx.keygen(rng)
    ct = sctx.encrypt(pk, "encrypted text", rng, encoding="string")
    assert sctx.decrypt(sk, ct, encoding="string") == "encrypted text"


# ---------------------------------------------------------------------------
# the reference's known-answer vectors (tools/ref_pke_kat_dump.cpp): N =
# 4096, three 60-bit moduli, coefficient-packed; the phase on the host in
# exact integers, decrypted by the port's rounding and decoding
# ---------------------------------------------------------------------------

def _vec(name):
    return np.load(os.path.join(VEC, name))


def kat_phase(scheme: str):
    """(the exact phase coefficients c0 + c1 s in [0, Q), Q, t, message) of
    tests/vectors/<scheme>_*: s ternary (residues 0, 1, q - 1), c1 s as
    signed sums of its negacyclic shifts in 30-bit halves (no int64
    overflow at 60-bit limbs), CRT by Garner."""
    with open(os.path.join(VEC, "manifest_pke.json")) as f:
        t = json.load(f)[scheme]["t"]
    mods = [int(q) for q in _vec(f"{scheme}_moduli.npy")]
    sk, msg = _vec(f"{scheme}_sk.npy"), _vec(f"{scheme}_msg.npy")
    c0, c1 = _vec(f"{scheme}_ct_c0.npy"), _vec(f"{scheme}_ct_c1.npy")
    L, n = c0.shape
    limbs = []
    for l, q in enumerate(mods[:L]):
        s = np.where(sk[l] == q - 1, -1, sk[l].astype(np.int64))
        halves = [(c1[l] & ((1 << 30) - 1)).astype(np.int64), (c1[l] >> 30).astype(np.int64)]
        acc = [np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64)]
        for j in np.flatnonzero(s):
            for h, c in zip(acc, halves):
                rolled = np.roll(c, j)
                rolled[:j] = -rolled[:j]                     # X^N = -1
                h += int(s[j]) * rolled
        prod = (acc[0].astype(object) + acc[1].astype(object) * (1 << 30)) % q
        limbs.append((prod + c0[l].astype(object)) % q)
    x, m = np.zeros(n, dtype=object), 1
    for l, q in enumerate(mods[:L]):
        x = x + (limbs[l] - x) % q * pow(m % q, -1, q) % q * m
        m *= q
    return x, m, t, msg


def test_decrypt_reference_kat():
    big, Q, t, msg = kat_phase("bfv")
    got = encodings.decode_coef_packed(bfv.round_t_over_q(big, Q, t), t, signed=False)
    np.testing.assert_array_equal(got, msg.astype(np.int64))
