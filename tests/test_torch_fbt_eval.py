"""fhe_tpu_torch's sparse FBT and multiprecision sign (pke/fbt.py) on the
CPU: byte-equal to fhe_tpu's fbt.py run over the port's ops
(test_torch_bootstrap.py's `Bridge`) and decrypted exactly, at fhe_tpu's
tests/test_fbt.py and examples/functional_bootstrapping_ckks.py sizes
(N = 256, 18 levels, a weight-4 secret, r = 2).

The `slow` test runs fhe_tpu's own fbt.py -- its context, ring ops and key
switch -- on the port's keys and ciphertext (its time in its docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import fbt as j_fbt
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch.pke import ckks, fbt
from test_torch_bootstrap import Bridge, same_ct, to_j
from test_torch_fbt import (BIG_Q, CTX, H, N, fbt_case,  # noqa: F401 (fixture)
                            fhe_tpu_fbt_over_the_port, lut_decrypted, same_mp)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

NUM_VALUES = 64                 # d = N / num_values = 4, 32 CKKS slots


def sparse_case():
    """test_arbitrary_lut_sparse (seed 43): 64 digits in Z_4 on the stride-4
    subring coefficients, converted with num_values."""
    ctx, sk, precom, keys, rng = fbt_case(43, slots=NUM_VALUES // 2)
    vals = rng.integers(0, 4, size=NUM_VALUES)
    msg = np.zeros(N, dtype=np.int64)
    msg[::N // NUM_VALUES] = vals
    ct_rlwe = fbt.encrypt_coeff(ctx, sk, msg, BIG_Q, 4, rng)
    ct = fbt.convert_rlwe_to_ckks(ctx, ct_rlwe, num_values=NUM_VALUES)
    return ctx, sk, precom, keys, vals, ct


def test_arbitrary_lut_sparse(fhe_tpu_fbt_over_the_port):
    """(3x + 2) mod 4 over 64 digits: the partial sums, vertical
    rectangular CoeffsToSlots, one branch, horizontal SlotsToCoeffs;
    byte-equal to fhe_tpu's eval_fbt, 0 wrong."""
    ctx, sk, precom, keys, vals, ct = sparse_case()
    func = lambda x: (3 * x + 2) % 4
    coeffs = fbt.get_hermite_trig_coefficients(func, 4, 2, 1.0)
    out = fbt.eval_fbt(ctx, ct, coeffs, precom, keys)
    same_ct(out, j_fbt.eval_fbt(Bridge(ctx), to_j(ct), coeffs, precom, keys), "sparse eval_fbt")
    got = lut_decrypted(ctx, sk, out, 4)[::N // NUM_VALUES]
    np.testing.assert_array_equal(got, [func(int(v)) for v in vals])


def test_sign_multiprecision(fhe_tpu_fbt_over_the_port):
    """The example's multiprecision sign: 4-bit values through 2-bit
    digits (p_in = 16, p_digit = 4, Q = 4 big_q): two FBTs, the digit
    subtraction and the exact modulus switch; byte-equal to fhe_tpu's
    (its RLWE result), every sign bit right."""
    ctx, sk, precom, keys, rng = fbt_case(2)
    vals = rng.integers(0, 16, size=N)
    ct = fbt.encrypt_coeff(ctx, sk, vals, BIG_Q << 2, 16, rng)
    got = fbt.eval_sign_multiprecision(ctx, ct, 16, 4, BIG_Q, precom, keys, order=2)
    want = j_fbt.eval_sign_multiprecision(Bridge(ctx), ct, 16, 4, BIG_Q, precom, keys, order=2)
    same_mp(got, want, "eval_sign_multiprecision")
    np.testing.assert_array_equal(fbt.decrypt_coeff(ctx, sk, got, 2), vals >= 8)
    with pytest.raises(ValueError, match="Q/p_in"):
        fbt.eval_sign_multiprecision(ctx, ct, 16, 4, BIG_Q << 1, precom, keys)


def test_hermite_trig_series_on_slots(fhe_tpu_fbt_over_the_port):
    """eval_hermite_trig_series (the slot-domain pipeline) on slot values
    m/4 + small noise: byte-equal to fhe_tpu's, f(m) within 1e-2."""
    ctx = ckks.CkksContext.create(device="cpu", **CTX)
    rng = np.random.default_rng(7)
    sk, pk = ctx.keygen(rng, h=H)
    precom = fbt.setup(ctx, h=H, r=2)
    keys = fbt.keygen(ctx, sk, precom, rng)
    m = rng.integers(0, 4, size=N // 2)
    ct = ctx.encrypt(pk, m / 4.0 / precom.K, rng)
    f = lambda v: (v + 1) % 4
    herm = fbt.get_hermite_trig_coefficients(f, 4, 2, 1.0)
    out = fbt.eval_hermite_trig_series(ctx, ct, precom.exp_coeffs, -1.0, 1.0, herm, keys,
                                       r=precom.r)
    same_ct(out, j_fbt.eval_hermite_trig_series(Bridge(ctx), to_j(ct), precom.exp_coeffs, -1.0,
                                                1.0, herm, keys, r=precom.r), "hermite series")
    assert np.abs(ctx.decrypt(sk, out).real - [f(int(v)) for v in m]).max() < 1e-2


def _jkey(k):
    return j_rlwe.EvalKey(b=jnp.asarray(k.b.numpy().astype(np.uint32)),
                          a=jnp.asarray(k.a.numpy().astype(np.uint32)),
                          moduli_qp=k.moduli_qp, num_per_part=k.num_per_part)


@pytest.mark.slow
def test_fhe_tpu_own_sparse_fbt_on_the_port_keys(monkeypatch):
    """fhe_tpu's own eval_fbt (its context, ring ops and key switch, eager
    jax) on the port's keys and ciphertext gives the port's bytes: the
    sparse LUT of test_arbitrary_lut_sparse.  About 21 minutes on an
    8-core CPU, nearly all of it jax compiling op by op."""
    for module in (j_fbt, j_boot, j_adv):   # fhe_tpu's own modules, whatever ran before
        monkeypatch.setattr(module, "rns", j_rns)
    for module in (j_fbt, j_boot):
        monkeypatch.setattr(module, "rlwe", j_rlwe)
    ctx, _, precom, keys, _, ct = sparse_case()
    jctx = j_ckks.CkksContext.create(**CTX)
    assert jctx.params.moduli == ctx.params.moduli
    jkeys = {"rot": {r: _jkey(k) for r, k in keys["rot"].items()},
             "conj": _jkey(keys["conj"]), "evk": _jkey(keys["evk"])}
    coeffs = fbt.get_hermite_trig_coefficients(lambda x: (3 * x + 2) % 4, 4, 2, 1.0)
    want = j_fbt.eval_fbt(jctx, to_j(ct), coeffs, precom, jkeys)
    same_ct(fbt.eval_fbt(ctx, ct, coeffs, precom, keys), want, "fhe_tpu's own")
