"""fhe_tpu_torch's comparison, min and max through FHEW sign bootstraps
(pke/schemeswitch.py: eval_compare_scheme_switching, eval_min/max_scheme_
switching and their _alt forms) on the CPU: byte-equal to fhe_tpu's
schemeswitch.py run over the port's ops (test_torch_schemeswitch.py's
`fhe_tpu_schemeswitch_over_the_port`), within fhe_tpu's
tests/test_schemeswitch.py bounds, at its sizes and values (N = 128;
15 levels for compare, 18 for min/max; 26-bit scale, dnum = 2).

The FHEW side is TOY_RADIX (N = q = 8192, q_ks = 2^20: EvalSign's ladder
is two floors and a sign bootstrap) with its LWE dimension cut from 64 to
2, so that the sign bootstraps run in seconds on the CPU; the ring and its
moduli are the set's.  The Alt forms are in
test_torch_schemeswitch_alt.py."""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_tpu.pke import schemeswitch as j_ss
from fhe_tpu_torch.pke import ckks
from fhe_tpu_torch.pke import schemeswitch as ss
from fhe_tpu_torch.tfhe import BinFheContext, make_params
from test_torch_bootstrap import Bridge, same_ct, to_j
from test_torch_schemeswitch import (N, SLOTS,  # noqa: F401 (fixture)
                                     fhe_tpu_schemeswitch_over_the_port, same_lwe)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CUT_N = 2


def toy_radix(rng):
    """TOY_RADIX cut to n = CUT_N: its context, secret and bootstrap key."""
    tctx = BinFheContext(params=dataclasses.replace(make_params("TOY_RADIX"), n=CUT_N),
                         device=torch.device("cpu"))
    tsk = tctx.key_gen(rng)
    return tctx, tsk, tctx.bt_key_gen(tsk, rng)


def test_compare_scheme_switching(fhe_tpu_schemeswitch_over_the_port):
    """test_compare_scheme_switching (seed 21, 15 levels): sign(z1 - z2) of
    4 strictly unequal pairs at p = 8, 1 iff z1 < z2; byte-equal to
    fhe_tpu's."""
    ctx = ckks.CkksContext.create(N=N, num_levels=15, scale_bits=26, dnum=2, device="cpu")
    rng = np.random.default_rng(21)
    sk, pk = ctx.keygen(rng)
    tctx, tsk, tkey = toy_radix(rng)
    key = ss.ckks_to_fhew_setup(ctx, sk, tctx.params, tsk, rng)
    z1, z2 = np.zeros(SLOTS), np.zeros(SLOTS)
    z1[:4] = [1.0, 3.0, 2.0, 0.0]
    z2[:4] = [2.0, 1.0, 4.0, 3.0]
    ct1, ct2 = ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng)
    out = ss.eval_compare_scheme_switching(ctx, key, ct1, ct2, tctx, tkey, num_values=4)
    same_lwe(out, j_ss.eval_compare_scheme_switching(Bridge(ctx), key, to_j(ct1), to_j(ct2),
                                                     tctx, tkey, num_values=4), "compare")
    got = tctx.decrypt(tsk, dataclasses.replace(out, pt_mod=2), p=2).numpy()
    np.testing.assert_array_equal(got, (z1[:4] < z2[:4]).astype(int))


@pytest.fixture(scope="module")
def minmax():
    """test_min_max_scheme_switching's 18-level context and keys."""
    ctx = ckks.CkksContext.create(N=N, num_levels=18, scale_bits=26, dnum=2, device="cpu")
    rng = np.random.default_rng(22)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    tctx, tsk, tkey = toy_radix(rng)
    key = ss.ckks_to_fhew_setup(ctx, sk, tctx.params, tsk, rng)
    k2 = ss.fhew_to_ckks_setup(ctx, sk, tsk, pk, rng)
    rot = ctx.rotation_key_gen(sk, ss.min_max_rotation_indices(4), rng)
    return ctx, sk, pk, evk, tctx, tkey, key, k2, rot, rng


def min_max_case(minmax, alt: bool):
    """Min over [3, 1, 2, 4] (within 0.2 of 1, the one-hot argmin's slot 1
    above 0.6) and max over [1, 3] (within 0.2 of 3), by the tournament or
    its Alt form; every output ciphertext byte-equal to fhe_tpu's."""
    ctx, sk, pk, evk, tctx, tkey, key, k2, rot, rng = minmax
    fns = ((ss.eval_min_scheme_switching_alt, j_ss.eval_min_scheme_switching_alt,
            ss.eval_max_scheme_switching_alt, j_ss.eval_max_scheme_switching_alt) if alt else
           (ss.eval_min_scheme_switching, j_ss.eval_min_scheme_switching,
            ss.eval_max_scheme_switching, j_ss.eval_max_scheme_switching))
    z = np.zeros(SLOTS)
    z[:4] = [3.0, 1.0, 2.0, 4.0]
    ct = ctx.encrypt(pk, z, rng)
    mn, ind = fns[0](ctx, key, k2, ct, tctx, tkey, evk, rot, num_values=4)
    j_mn, j_ind = fns[1](Bridge(ctx), key, k2, to_j(ct), tctx, tkey, evk, rot, num_values=4)
    same_ct(mn, j_mn, "min")
    same_ct(ind, j_ind, "argmin")
    assert abs(ctx.decrypt(sk, mn).real[0] - 1.0) < 0.2
    got_ind = ctx.decrypt(sk, ind).real[:4]
    assert np.argmax(got_ind) == 1 and got_ind[1] > 0.6, got_ind
    z2 = np.zeros(SLOTS)
    z2[:2] = [1.0, 3.0]
    ct2 = ctx.encrypt(pk, z2, rng)
    mx, _ = fns[2](ctx, key, k2, ct2, tctx, tkey, evk, rot, num_values=2)
    same_ct(mx, fns[3](Bridge(ctx), key, k2, to_j(ct2), tctx, tkey, evk, rot, num_values=2)[0],
            "max")
    assert abs(ctx.decrypt(sk, mx).real[0] - 3.0) < 0.2


def test_min_max_scheme_switching(minmax, fhe_tpu_schemeswitch_over_the_port):
    """test_min_max_scheme_switching: the tournament (CKKS mask expansion)."""
    min_max_case(minmax, alt=False)
