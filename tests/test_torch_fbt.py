"""fhe_tpu_torch's CKKS functional bootstrapping (pke/fbt.py) on the CPU:
its host setup and the RLWE multiprecision schemelet byte-equal to
fhe_tpu's, the schemelet's exact negacyclic product (NTTs over three
31-bit primes and a centred CRT) against fhe_tpu's object convolution,
and the dense FBT and multi-value bootstrap byte-equal to fhe_tpu's
fbt.py run over the port's ops (test_torch_bootstrap.py's `Bridge`),
decrypted to the LUT exactly.

Sizes and seeds are fhe_tpu's tests/test_fbt.py's: N = 256, 18 levels of
26 bits (first 30), dnum = 3, a weight-4 secret, r = 2, big_q = 2^33.
The sparse FBT and the multiprecision sign are in test_torch_fbt_eval.py,
whose `slow` test runs fhe_tpu's own fbt.py (its context and ring ops) on
the port's keys and ciphertext."""

import numpy as np
import pytest
import torch

from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import fbt as j_fbt
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import ckks, fbt, rlwe
from test_torch_bootstrap import Bridge, PortModule, same_ct, to_j

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
H = 4
BIG_Q = 1 << 33
CTX = dict(N=N, num_levels=18, scale_bits=26, dnum=3, first_bits=30)


@pytest.fixture(scope="module")
def fhe_tpu_fbt_over_the_port():
    """fhe_tpu's fbt.py, bootstrap.py and advanced.py with their ring and
    RLWE modules the port's."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (j_fbt, j_boot):
            mp.setattr(module, "rns", PortModule(rns))
            mp.setattr(module, "rlwe", PortModule(rlwe))
        mp.setattr(j_adv, "rns", PortModule(rns))
        yield


def fbt_case(seed: int, **setup_kw):
    """tests/test_fbt.py's fbt_ctx on the port: context, weight-4 keys, setup
    (r = 2), FBT keys."""
    ctx = ckks.CkksContext.create(device="cpu", **CTX)
    rng = np.random.default_rng(seed)
    sk, _ = ctx.keygen(rng, h=H)
    precom = fbt.setup(ctx, h=H, r=2, **setup_kw)
    keys = fbt.keygen(ctx, sk, precom, rng)
    return ctx, sk, precom, keys, rng


def same_mp(got, want, what=""):
    """Two schemelet ciphertexts hold the same integers, modulus and delta."""
    assert (got.q, got.delta) == (want.q, want.delta), what
    for g, w in ((got.c0, want.c0), (got.c1, want.c1)):
        assert [int(x) for x in g] == [int(x) for x in w], what


def lut_decrypted(ctx, sk, out, p: int) -> np.ndarray:
    return fbt.decrypt_coeff(ctx, sk, fbt.convert_ckks_to_rlwe(ctx, out, BIG_Q,
                                                               target_delta=BIG_Q / p), p)


# ---------------------------------------------------------------------------
# host setup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p, order", [(4, 1), (4, 2), (8, 2), (8, 3), (16, 2), (5, 3)])
def test_hermite_coefficients_match_fhe_tpu(p, order):
    f = lambda x: (3 * x * x + 1) % p
    np.testing.assert_array_equal(fbt.get_hermite_trig_coefficients(f, p, order, 2.0),
                                  j_fbt.get_hermite_trig_coefficients(f, p, order, 2.0))


def test_setup_and_depth_match_fhe_tpu():
    """_exp_cheb_coeffs, setup (dense and sparse) and get_fbt_depth equal
    fhe_tpu's, and a bad slot count raises the same ValueError."""
    for K, r in ((6, 2), (36, 3), (204, 3)):
        assert fbt._exp_cheb_coeffs(K, r) == j_fbt._exp_cheb_coeffs(K, r)
    ctx = ckks.CkksContext.create(device="cpu", **CTX)
    for kw in ({}, dict(slots=32), dict(slots=8)):
        got, want = fbt.setup(ctx, h=H, r=2, **kw), j_fbt.setup(ctx, h=H, r=2, **kw)
        assert (got.slots, got.K, got.r, got.rot_indices, got.bsgs_g) == \
            (want.slots, want.K, want.r, want.rot_indices, want.bsgs_g)
        assert got.exp_coeffs == want.exp_coeffs
        np.testing.assert_array_equal(got.E_lo, want.E_lo)
    for args in ((4, 2, 4, 2), (16, 2, 64, 3), (8, 3, 4, 2), (4, 1, 4, 0, 2)):
        assert fbt.get_fbt_depth(*args) == j_fbt.get_fbt_depth(*args)
    for mod in (fbt, j_fbt):
        with pytest.raises(ValueError, match="slots must be"):
            mod.setup(ctx, h=H, slots=48)


# ---------------------------------------------------------------------------
# the schemelet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, a_bits, b_kind", [(256, 33, "ternary"), (256, 70, "ternary"),
                                               (256, 40, "wide"), (2048, 63, "ternary")],
                         ids=["256-33", "256-70", "256-wide", "2048-63"])
def test_negacyclic_mul_by_ntt_is_the_object_convolution(n, a_bits, b_kind):
    """The exact product by NTTs equals fhe_tpu's object convolution: a
    uniform below 2^a_bits against a ternary secret (the schemelet's
    products) or against signed 20-bit integers (more primes)."""
    rng = np.random.default_rng(n + a_bits)
    a = np.array([int(x) for x in rng.integers(0, 1 << 62, size=n)], dtype=object)
    a = a * (1 << max(0, a_bits - 62)) % (1 << a_bits)
    if b_kind == "ternary":
        b = np.array([int(x) for x in rng.integers(-1, 2, size=n)], dtype=object)
    else:
        b = np.array([int(x) for x in rng.integers(-(1 << 20), 1 << 20, size=n)], dtype=object)
    got = fbt._negacyclic_mul(a, b, device="cpu")
    assert [int(x) for x in got] == [int(x) for x in j_fbt._negacyclic_mul(a, b)]


def test_mul_primes_and_a_refused_length():
    """Three primes = 1 mod 2^17 below 2^31 hold a 2^63 product at N = 2^16;
    a length that is not a power of two (or above 2^16) raises."""
    qs = fbt.mul_primes(3)
    assert all(q < 1 << 31 and q % (1 << 17) == 1 for q in qs)
    assert rns.modulus_product(qs) > 2 * (1 << 16) * (1 << 63)
    with pytest.raises(ValueError, match="power of two"):
        fbt._negacyclic_mul(np.ones(24, dtype=object), np.ones(24, dtype=object), device="cpu")


def test_schemelet_matches_fhe_tpu(fhe_tpu_fbt_over_the_port):
    """From one seed: encrypt_coeff, decrypt_coeff, mod_switch and both
    conversions (dense and sparse num_values) equal fhe_tpu's; the
    round trip decrypts to the message (test_schemelet_roundtrip)."""
    ctx = ckks.CkksContext.create(N=128, num_levels=3, scale_bits=26, dnum=2, device="cpu")
    msg = np.random.default_rng(5).integers(0, 16, size=128)
    sk, _ = ctx.keygen(np.random.default_rng(5), h=4)
    got = fbt.encrypt_coeff(ctx, sk, msg, 1 << 40, 16, np.random.default_rng(6))
    want = j_fbt.encrypt_coeff(ctx, sk, msg, 1 << 40, 16, np.random.default_rng(6))
    same_mp(got, want, "encrypt_coeff")
    np.testing.assert_array_equal(fbt.decrypt_coeff(ctx, sk, got, 16), msg)
    np.testing.assert_array_equal(fbt.decrypt_coeff(ctx, sk, got, 16),
                                  j_fbt.decrypt_coeff(ctx, sk, want, 16))
    low = fbt.mod_switch(got, 1 << 33)
    same_mp(low, j_fbt.mod_switch(want, 1 << 33), "mod_switch")
    np.testing.assert_array_equal(fbt.decrypt_coeff(ctx, sk, low, 16), msg)
    b = Bridge(ctx)
    for num in (None, 32):
        ct = fbt.convert_rlwe_to_ckks(ctx, low, num_values=num)
        same_ct(ct, j_fbt.convert_rlwe_to_ckks(b, low, num_values=num), "convert_rlwe_to_ckks")
        for target in (None, (1 << 33) / 16):
            same_mp(fbt.convert_ckks_to_rlwe(ctx, ct, 1 << 33, target_delta=target),
                    j_fbt.convert_ckks_to_rlwe(b, to_j(ct), 1 << 33, target_delta=target),
                    "convert_ckks_to_rlwe")


def test_convert_carries_fbt_state():
    """convert.rlwe_mp_ciphertext and convert.fbt_precom carry fhe_tpu's
    schemelet ciphertext and FbtPrecom."""
    ctx = ckks.CkksContext.create(device="cpu", **CTX)
    want = j_fbt.setup(ctx, h=H, r=2, slots=32)
    got = convert.fbt_precom(want.slots, want.K, want.r, want.exp_coeffs, want.E_lo,
                             want.rot_indices, want.bsgs_g)
    assert isinstance(got, fbt.FbtPrecom)
    assert (got.slots, got.K, got.r, got.exp_coeffs, got.rot_indices, got.bsgs_g) == \
        (want.slots, want.K, want.r, want.exp_coeffs, want.rot_indices, want.bsgs_g)
    np.testing.assert_array_equal(got.E_lo, want.E_lo)
    sk, _ = ctx.keygen(np.random.default_rng(1), h=H)
    j_ct = j_fbt.encrypt_coeff(ctx, sk, np.arange(N) % 4, BIG_Q, 4, np.random.default_rng(2))
    ct = convert.rlwe_mp_ciphertext(j_ct.c0, j_ct.c1, j_ct.q, j_ct.delta)
    assert isinstance(ct, fbt.RlweMpCiphertext)
    same_mp(ct, j_ct, "carried")
    np.testing.assert_array_equal(fbt.decrypt_coeff(ctx, sk, ct, 4), np.arange(N) % 4)


# ---------------------------------------------------------------------------
# the FBT, against fhe_tpu's fbt.py over the port's ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """tests/test_fbt.py's fbt_ctx (seed 42) and a message of N digits in
    Z_4, encrypted under big_q and converted."""
    ctx, sk, precom, keys, rng = fbt_case(42)
    msg = rng.integers(0, 4, size=N)
    ct = fbt.convert_rlwe_to_ckks(ctx, fbt.encrypt_coeff(ctx, sk, msg, BIG_Q, 4, rng))
    return ctx, sk, precom, keys, msg, ct


def test_arbitrary_lut_fully_packed(dense, fhe_tpu_fbt_over_the_port):
    """test_arbitrary_lut_fully_packed: (x - 2) mod 4 at order 2 over all N
    coefficients, 0 wrong, byte-equal to fhe_tpu's eval_fbt."""
    ctx, sk, precom, keys, msg, ct = dense
    func = lambda x: (x % 4 - 2) % 4
    coeffs = fbt.get_hermite_trig_coefficients(func, 4, 2, 1.0)
    out = fbt.eval_fbt(ctx, ct, coeffs, precom, keys)
    same_ct(out, j_fbt.eval_fbt(Bridge(ctx), to_j(ct), coeffs, precom, keys), "eval_fbt")
    np.testing.assert_array_equal(lut_decrypted(ctx, sk, out, 4), [func(int(m)) for m in msg])


def test_multi_value_bootstrap(dense, fhe_tpu_fbt_over_the_port):
    """test_multi_value_bootstrap: x^2 and 3x + 1 mod 4 from one power
    basis; eval_mvb_precompute, eval_mvb_no_decoding and eval_hom_decoding
    byte-equal to fhe_tpu's, 0 wrong; eval_fbt_no_decoding then decoding
    is eval_fbt."""
    ctx, sk, precom, keys, msg, ct = dense
    b = Bridge(ctx)
    fs = [lambda x: (x * x) % 4, lambda x: (3 * x + 1) % 4]
    cs = [fbt.get_hermite_trig_coefficients(f, 4, 2, 1.0) for f in fs]
    deg = max(len(c) for c in cs) - 1
    sp = fbt.eval_mvb_precompute(ctx, ct, precom, keys, deg)
    j_sp = j_fbt.eval_mvb_precompute(b, to_j(ct), precom, keys, deg)
    assert sorted(sp.powers_re) == sorted(j_sp.powers_re) == list(range(1, deg + 1))
    for j in sp.powers_re:
        same_ct(sp.powers_re[j], j_sp.powers_re[j], f"z_re^{j}")
        same_ct(sp.powers_im[j], j_sp.powers_im[j], f"z_im^{j}")
    for f, c in zip(fs, cs):
        enc = fbt.eval_mvb_no_decoding(ctx, sp, c, precom, keys)
        same_ct(enc, j_fbt.eval_mvb_no_decoding(b, j_sp, c, precom, keys), "no_decoding")
        out = fbt.eval_hom_decoding(ctx, enc, precom, keys, post_scale=2.0)
        same_ct(out, j_fbt.eval_hom_decoding(b, to_j(enc), precom, keys, post_scale=2.0),
                "eval_hom_decoding")
        out = ckks.Ciphertext(out.c0, out.c1, out.scale * 2.0)
        np.testing.assert_array_equal(lut_decrypted(ctx, sk, out, 4), [f(int(m)) for m in msg])
    # eval_fbt_no_decoding is the precompute at the LUT's own degree (the
    # same powers) and the series
    same_ct(fbt.eval_fbt_no_decoding(ctx, ct, cs[1], precom, keys),
            to_j(fbt.eval_mvb_no_decoding(ctx, sp, cs[1], precom, keys)), "eval_fbt_no_decoding")
