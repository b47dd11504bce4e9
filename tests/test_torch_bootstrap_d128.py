"""The sparse bootstrap at d = N / (2 slots) = 128 (ROADMAP queue 3): at
N = 2^11 with 8 slots and the SPARSE_ENCAPSULATED raise, fhe_tpu_torch's
eval_bootstrap decrypts to garbage.  These tests show that the fault is
fhe_tpu's composition, not the port's: fhe_tpu's bootstrap.py, run over
the port's ops (test_torch_bootstrap.py's `Bridge`), gives the port's
ciphertexts byte for byte, and its CoeffsToSlots output already leaves
[-1, 1], the interval of the sine's Chebyshev series.

Why: the partial sum (the trace onto the subring) multiplies each subring
coefficient by d exactly, its overflow integer I with it, so the slot
value before the sine is (m + d I) / K; fhe_tpu's setup grows the sine
range only by sqrt(d) (K = ((h + 1)/2 + 4) sqrt(d), `setup`'s random-walk
heuristic).  With the weight-64 helper, I has standard deviation ~2.3, so
d |I| > K as soon as |I| >= 4 at d = 128 (K = 408), and a degree-453
Chebyshev series evaluated past 1 overflows.  At d = 8 (K = 102, the
card's [boot] sparse case) |I| would have to reach 13.

The ring, chain and seed are chip_smoke.py's [boot] card-against-CPU
ring: N = 2^11, 22 levels at composite degree 2 (scale 2^52, q0 ~2^60),
P 12, dnum = 4, track_scale, a dense secret with a weight-64 helper, r = 3,
SEED + 51.  The whole bootstraps take about a minute each on one thread,
so they are `slow`; tier-1 runs the pipeline up to the sine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import params as j_params
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import bootstrap, ckks, params, rlwe
from test_torch_bootstrap import (Bridge, fhe_tpu_bootstrap_over_the_port,  # noqa: F401
                                  lowest, same_ct, to_j)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

SMALL = dict(N=1 << 11, num_levels=22, scale_bits=52, composite_degree=2, first_bits=60, dnum=4,
             track_scale=True)
SEED = 20261016 + 51            # chip_smoke.py SEED + 51, its N = 2^11 ring's
H = 64


def sparse_case(slots: int):
    """The encapsulated sparse bootstrap's context, keys and a level-0
    ciphertext of `slots` complex values in [-0.4, 0.4]^2."""
    ctx = ckks.CkksContext(params.make_ckks_params(**SMALL), torch.device("cpu"))
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    pre = bootstrap.setup(ctx, h=H, r=3, slots=slots)
    keys = bootstrap.keygen(ctx, sk, pre, rng, encapsulate_h=H)
    z = rng.uniform(-0.4, 0.4, size=slots) + 1j * rng.uniform(-0.4, 0.4, size=slots)
    return ctx, sk, pre, keys, z, lowest(ctx, ctx.encrypt(pk, z, rng, slots=slots))


class _AtTheSine(Exception):
    pass


def _until_the_sine(module, run):
    """Runs run() with module.eval_chebyshev_series_ps replaced by a stop:
    the ciphertext the sine would have received."""
    seen = []

    def stop(ctx, ct, *args, **kwargs):
        seen.append(ct)
        raise _AtTheSine
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "eval_chebyshev_series_ps", stop)
        with pytest.raises(_AtTheSine):
            run()
    return seen[0]


def test_coeffs_to_slots_range_is_fhe_tpu_s(fhe_tpu_bootstrap_over_the_port):
    """The sine's input at d = 128 (raise, partial sums, rectangular
    CoeffsToSlots, conjugate add) byte-equal to fhe_tpu's bootstrap.py
    over the port's ops; its slot values leave [-1, 1], as the subring's
    overflow integers times d say (|x| <= (1 + d max|I|) / K, d max|I| >
    K = 408).  The same raise's integers on the d = 8 subring (every 8th
    coefficient, 256 of them) stay inside that case's K = 102."""
    ctx, sk, pre, keys, _, ct = sparse_case(8)
    got = _until_the_sine(bootstrap, lambda: bootstrap.eval_bootstrap(ctx, ct, pre, keys))
    want = _until_the_sine(j_boot, lambda: j_boot.eval_bootstrap(Bridge(ctx), to_j(ct), pre,
                                                                  keys))
    same_ct(got, want, "the sine's input")
    x = np.abs(ctx.decrypt(sk, got).real).max()
    raised = bootstrap._raise(ctx, ct, keys)
    ph = ckks._center(rns.to_bigint(rlwe.decrypt_phase(sk, raised.c0, raised.c1)),
                      rns.modulus_product(raised.moduli))
    I = np.rint(ph / bootstrap._q0(ctx))
    # the subring of 8 slots is every N / 16 = 128th coefficient, of 128
    # slots every 8th
    i128, i8 = np.abs(I[::128]).max(), np.abs(I[::8]).max()
    assert pre.K == 408 and 1 < x <= (1 + 128 * i128) / pre.K * 1.01, (x, i128)
    assert 128 * i128 > pre.K
    assert 8 * i8 + 1 < bootstrap.setup(ctx, h=H, r=3, slots=128).K == 102


@pytest.mark.slow
def test_d128_bootstrap_is_fhe_tpu_s(fhe_tpu_bootstrap_over_the_port):
    """The whole d = 128 bootstrap: fhe_tpu's eval_bootstrap over the port's
    ops gives the port's output byte for byte, and it decrypts past 1e100
    (the degree-453 series past its interval).  About 3 minutes on one
    thread."""
    ctx, sk, pre, keys, z, ct = sparse_case(8)
    out = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    same_ct(out, j_boot.eval_bootstrap(Bridge(ctx), to_j(ct), pre, keys), "d = 128 bootstrap")
    assert np.abs(ctx.decrypt(sk, out, slots=8, sparse=True) - z).max() > 1e100


def _jkey(k):
    return j_rlwe.EvalKey(b=jnp.asarray(k.b.numpy().astype(np.uint32)),
                          a=jnp.asarray(k.a.numpy().astype(np.uint32)),
                          moduli_qp=k.moduli_qp, num_per_part=k.num_per_part)


@pytest.mark.slow
def test_fhe_tpu_own_d128_bootstrap(monkeypatch):
    """fhe_tpu's own eval_bootstrap_jit (its ring, key switch and raise,
    jitted) on the port's chain, keys and ciphertext gives the port's bytes
    at d = 128: fhe_tpu fails the same way.  fhe_tpu's own chain drifts
    at this depth (ROADMAP queue 3), so its context takes the port's
    track_scale moduli.  Its compile takes over 40 minutes on an 8-core
    CPU."""
    for module in (j_boot, j_adv):      # fhe_tpu's own modules, whatever ran before
        monkeypatch.setattr(module, "rns", j_rns)
    monkeypatch.setattr(j_boot, "rlwe", j_rlwe)
    ctx, _, pre, keys, _, ct = sparse_case(8)
    p = ctx.params
    jctx = j_ckks.CkksContext(j_params.PkeParams(
        scheme="CKKS", N=p.N, moduli=tuple(p.moduli), special_mods=tuple(p.special_mods),
        num_part_q=p.num_part_q, scale_bits=p.scale_bits, composite_degree=p.composite_degree))
    assert j_ckks._level_scales(jctx.params) == ckks._level_scales(p)
    jkeys = {"rot": {r: _jkey(k) for r, k in keys["rot"].items()},
             **{name: _jkey(keys[name]) for name in ("conj", "evk", "swk_down", "swk_up")}}
    want = j_boot.eval_bootstrap_jit(jctx, pre, jkeys)(to_j(ct))
    same_ct(bootstrap.eval_bootstrap(ctx, ct, pre, keys), jax.device_get(want), "fhe_tpu's own")


@pytest.mark.slow
def test_overflow_integers_of_the_encapsulated_raise():
    """The distribution behind ROADMAP queue 3's numbers: the overflow
    integers I = round(phase / q0) of the encapsulated raise at N = 2^11
    (weight-64 helper), over all 2048 coefficients of 12 seeds: standard
    deviation ~2.3 (the sum of 64 uniform terms and one), |I| >= 7 with
    probability ~0.005, which d = 32 (K = 204) cannot absorb at 2048
    coefficients and d = 8 (K = 102, |I| up to 12) can.  About 3 minutes
    on one thread."""
    ctx = ckks.CkksContext(params.make_ckks_params(**SMALL), torch.device("cpu"))
    q0 = bootstrap._q0(ctx)
    mods = tuple(ctx.params.moduli)
    found = []
    for seed in range(12):
        rng = np.random.default_rng(SEED + 1000 + seed)
        sk, pk = ctx.keygen(rng)
        sk2 = rlwe.keygen(ctx.params, rng, h=H, device="cpu")
        keys = {"swk_down": rlwe.evk_gen(ctx.params, sk.eval_poly(mods), sk2, rng),
                "swk_up": rlwe.evk_gen(ctx.params, sk2.eval_poly(mods), sk, rng)}
        ct = lowest(ctx, ctx.encrypt(pk, rng.uniform(-0.4, 0.4, size=1024), rng))
        raised = bootstrap._raise(ctx, ct, keys)
        ph = ckks._center(rns.to_bigint(rlwe.decrypt_phase(sk, raised.c0, raised.c1)),
                          rns.modulus_product(raised.moduli))
        found.append(np.rint(ph / q0))
    I = np.abs(np.concatenate(found))
    p7 = float((I >= 7).mean())
    print(f"std {np.concatenate(found).std():.3f}, P(|I| >= 7) = {p7:.4g}, max |I| {I.max():g}")
    assert 2.1 < np.concatenate(found).std() < 2.5 and 0.002 < p7 < 0.008 and I.max() < 13
