"""fhe_tpu_torch's proxy re-encryption (pke/pre.py) against fhe_tpu on the
CPU, at tests/test_pre.py's sizes (N = 256): its 3 tests on the port, each
decrypted within fhe_tpu's own tolerance there (CKKS) or exactly (BGV),
and the re-encryption keys and re-encrypted ciphertexts byte for byte from
one seed: CKKS with a HYBRID key and the re-randomization under pk_new,
BGV with a HYBRID key and with a BV key (digit_bits, noise x t).

The port's keys and ciphertexts are carried into fhe_tpu as arrays; fhe_tpu
runs jitted with the generator closed over (its draws happen once, at
trace time).  The port runs with device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import bgv as j_bgv
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import pre as j_pre
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch.pke import bgv, ckks, pre, rlwe

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SEED = 43
CKKS3 = dict(N=N, num_levels=3, scale_bits=26, dnum=2)     # tests/test_pre.py:13
BGV2 = dict(N=N, num_levels=2, plain_mod=65537, mod_bits=28, dnum=2)


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


def _jpk(pk):
    return j_rlwe.PublicKey(b=_jpoly(pk.b), a=_jpoly(pk.a))


def _hop_matches_fhe_tpu(jparams, sk_a, sk_b, pk_b, ct, seed: int, port_out, **kw):
    """fhe_tpu's re_key_gen then re_encrypt (with pk_b when given) on the
    carried keys and ciphertext, from seed: the key and the ciphertext the
    port made from the same seed, byte for byte."""
    rk_rng, enc_rng = np.random.default_rng(seed), np.random.default_rng(seed + 1)

    def hop(a, b, pk, c0, c1):
        rk = j_pre.re_key_gen(jparams, a, b, rk_rng, **kw)
        return rk, j_pre.re_encrypt(jparams, rk, c0, c1, enc_rng if pk else None, pk)

    jpk = _jpk(pk_b) if pk_b is not None else None
    jrk, (j0, j1) = jax.jit(hop)(_jsk(sk_a), _jsk(sk_b), jpk, _jpoly(ct.c0), _jpoly(ct.c1))
    rk, (c0, c1) = port_out
    _eq(jrk.b, rk.b)
    _eq(jrk.a, rk.a)
    _eq(j0.data, c0.data)
    _eq(j1.data, c1.data)


def _hop(params, sk_a, sk_b, pk_b, ct, seed: int, **kw):
    """The port's re_key_gen then re_encrypt, from seed (rk, (c0, c1))."""
    rk = pre.re_key_gen(params, sk_a, sk_b, np.random.default_rng(seed), **kw)
    rng = np.random.default_rng(seed + 1) if pk_b is not None else None
    return rk, pre.re_encrypt(params, rk, ct.c0, ct.c1, rng, pk_b)


@pytest.fixture(scope="module")
def ckks3():
    ctx = ckks.CkksContext.create(**CKKS3, device="cpu")
    return ctx, j_ckks.CkksContext.create(**CKKS3)


def test_ckks_pre_single_hop(ckks3):
    """Alice -> Bob with re-randomization under Bob's public key: the key
    and the re-encrypted ciphertext byte-equal to fhe_tpu's; Bob decrypts
    within fhe_tpu's 1e-2, Alice's key does not decrypt it."""
    ctx, jctx = ckks3
    rng = np.random.default_rng(SEED)
    sk_a, pk_a = ctx.keygen(rng)
    sk_b, pk_b = ctx.keygen(rng)
    z = rng.normal(size=N // 2)
    ct = ctx.encrypt(pk_a, z, rng)
    out = _hop(ctx.params, sk_a, sk_b, pk_b, ct, SEED + 1)
    _hop_matches_fhe_tpu(jctx.params, sk_a, sk_b, pk_b, ct, SEED + 1, out)
    ct_b = ckks.Ciphertext(*out[1], ct.scale)
    np.testing.assert_allclose(ctx.decrypt(sk_b, ct_b).real, z, atol=1e-2)
    assert np.abs(ctx.decrypt(sk_a, ct_b).real - z).max() > 0.1


def test_ckks_pre_multihop(ckks3):
    """Alice -> Bob -> Carol without re-randomization, within fhe_tpu's
    2e-2."""
    ctx, _ = ckks3
    rng = np.random.default_rng(SEED + 2)
    keys = [ctx.keygen(rng) for _ in range(3)]
    rk_ab = pre.re_key_gen(ctx.params, keys[0][0], keys[1][0], rng)
    rk_bc = pre.re_key_gen(ctx.params, keys[1][0], keys[2][0], rng)
    z = rng.normal(size=N // 2)
    ct = ctx.encrypt(keys[0][1], z, rng)
    c0, c1 = pre.re_encrypt(ctx.params, rk_ab, ct.c0, ct.c1)
    c0, c1 = pre.re_encrypt(ctx.params, rk_bc, c0, c1)
    got = ctx.decrypt(keys[2][0], ckks.Ciphertext(c0, c1, ct.scale))
    np.testing.assert_allclose(got.real, z, atol=2e-2)


@pytest.fixture(scope="module")
def bgv2():
    ctx = bgv.BgvContext.create(**BGV2, device="cpu")
    rng = np.random.default_rng(SEED + 3)
    sk_a, pk_a = ctx.keygen(rng)
    sk_b, pk_b = ctx.keygen(rng)
    m = rng.integers(0, 65537, size=N)
    return ctx, j_bgv.BgvContext.create(**BGV2), (sk_a, sk_b, pk_b), m, ctx.encrypt(pk_a, m, rng)


@pytest.mark.parametrize("method, digit_bits", [("hybrid", 0), ("bv", 14)])
def test_bgv_pre(bgv2, method, digit_bits):
    """BGV Alice -> Bob with re-randomization, a HYBRID key (fhe_tpu's test)
    and a BV key of 14-bit digits (two a limb): the key (noise x t) and the
    re-encryption byte-equal to fhe_tpu's; Bob decrypts it exactly."""
    ctx, jctx, (sk_a, sk_b, pk_b), m, ct = bgv2
    kw = dict(method=method, digit_bits=digit_bits)
    out = _hop(ctx.params, sk_a, sk_b, pk_b, ct, SEED + 4, **kw)
    assert isinstance(out[0], rlwe.BvEvalKey) == (method == "bv")
    _hop_matches_fhe_tpu(jctx.params, sk_a, sk_b, pk_b, ct, SEED + 4, out, **kw)
    got = ctx.decrypt(sk_b, bgv.Ciphertext(*out[1]))
    np.testing.assert_array_equal(got, m % 65537)
