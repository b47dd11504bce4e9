"""fhe_tpu_torch's hoisted CKKS rotations (fast_rotation_precompute with
fast_rotation, and fast_rotation_ext summed under one key_switch_down) and
the leveled add / sub / add_plain / mul_plain / rescale against fhe_tpu on
the CPU, byte for byte, at tests/test_ckks.py's size (N = 256, num_levels
= 4, scale_bits = 26, dnum = 2), and their decrypted values within the
tolerances of fhe_tpu's tests/test_ckks.py.

The port's keys are carried into fhe_tpu as arrays (test_torch_ckks.py and
test_torch_ckks_ops.py hold them equal to fhe_tpu's own); fhe_tpu runs
only jitted, one compiled function per group of ops.  The port runs with
device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch.pke import ckks

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SLOTS = N // 2
ROTS = (1, SLOTS - 1)
SEED = 23


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _jct(ct):
    return j_ckks.Ciphertext(_jpoly(ct.c0), _jpoly(ct.c1), ct.scale)


def _jevk(k):
    return j_rlwe.EvalKey(b=_j(k.b), a=_j(k.a), moduli_qp=k.moduli_qp,
                          num_per_part=k.num_per_part)


def _same_ct(jct, ct):
    assert jct.c0.moduli == ct.c0.moduli and jct.scale == ct.scale
    _eq(jct.c0.data, ct.c0.data)
    _eq(jct.c1.data, ct.c1.data)


@pytest.fixture(scope="module")
def setup():
    """Both contexts, the port's keys (sk, pk, relinearization, rotations
    by ROTS, conjugation), the ciphertext of z and a plaintext vector w."""
    kw = dict(N=N, num_levels=4, scale_bits=26, dnum=2)
    ctx, jctx = ckks.CkksContext.create(**kw, device="cpu"), j_ckks.CkksContext.create(**kw)
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    rot = ctx.rotation_key_gen(sk, ROTS, rng)
    conj = ctx.conj_key_gen(sk, rng)
    z = rng.normal(size=SLOTS) + 1j * rng.normal(size=SLOTS)
    w = rng.normal(size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    return ctx, jctx, (sk, pk, evk, rot, conj), ct, z, w


def _fhe_tpu(setup, fn, *args):
    """fn(jctx, *args) jitted, on the port's objects carried into fhe_tpu."""
    jctx = setup[1]
    return jax.jit(lambda *xs: fn(jctx, *xs))(*args)


@pytest.mark.parametrize("r", ROTS)
def test_fast_rotation(setup, r):
    """The hoisted pair (fast_rotation_precompute, fast_rotation): z rolled
    left by r within 1e-3; by 1 fhe_tpu's bytes.  (Not rotate's bytes: the
    automorphism permutes the ModUp's slack with the digits.)"""
    ctx, _, (sk, pk, evk, rot, conj), ct, z, _ = setup
    got = ctx.fast_rotation(ct, r, rot, ctx.fast_rotation_precompute(ct))
    if r == 1:
        _same_ct(_fhe_tpu(setup, lambda jc, c, k: jc.fast_rotation(
            c, 1, {1: k}, jc.fast_rotation_precompute(c)), _jct(ct), _jevk(rot[1])), got)
    np.testing.assert_allclose(ctx.decrypt(sk, got), np.roll(z, -r), atol=1e-3)


def test_fast_rotation_ext_sum_matches_fhe_tpu(setup):
    """EvalFastRotationExt over Q + P, summed, then one KeySwitchDown."""
    ctx, _, (sk, pk, evk, rot, conj), ct, z, _ = setup
    ext_sum = lambda c, x, keys: c.key_switch_down(c.add(*[
        c.fast_rotation_ext(x, r, keys, c.fast_rotation_precompute(x)) for r in ROTS]))
    got = ext_sum(ctx, ct, rot)
    _same_ct(_fhe_tpu(setup, lambda jc, c, keys: ext_sum(jc, c, keys), _jct(ct),
                      {r: _jevk(k) for r, k in rot.items()}), got)
    np.testing.assert_allclose(ctx.decrypt(sk, got), sum(np.roll(z, -r) for r in ROTS),
                               atol=1e-3)


LEVELED = {  # op -> (the call on a context c, ciphertext x, plaintext w; value; tolerance)
    "add": (lambda c, x, w: c.add(x, x), lambda z, w: 2 * z, 1e-4),
    "sub": (lambda c, x, w: c.sub(x, c.add(x, x)), lambda z, w: -z, 1e-4),
    "add_plain": (lambda c, x, w: c.add_plain(x, w), lambda z, w: z + w, 1e-4),
    "mul_plain": (lambda c, x, w: c.mul_plain(x, w), None, None),
    "rescale": (lambda c, x, w: c.rescale(c.mul_plain(x, w)), lambda z, w: z * w, 1e-3),
}


@pytest.fixture(scope="module")
def leveled(setup):
    """fhe_tpu's result of each of LEVELED, from one jitted function."""
    ct, w = setup[3], setup[5]
    return _fhe_tpu(setup, lambda jc, x: {op: f(jc, x, w) for op, (f, _, _) in LEVELED.items()},
                    _jct(ct))


@pytest.mark.parametrize("op", list(LEVELED))
def test_leveled_op_matches_fhe_tpu(setup, leveled, op):
    """add, sub, add_plain within 1e-4 of their values; mul_plain, then
    rescale, within 1e-3 (fhe_tpu's tests/test_ckks.py tolerances)."""
    ctx, _, (sk, pk, evk, rot, conj), ct, z, w = setup
    f, value, tol = LEVELED[op]
    got = f(ctx, ct, w)
    _same_ct(leveled[op], got)
    if tol is not None:
        np.testing.assert_allclose(ctx.decrypt(sk, got), value(z, w), atol=tol)
