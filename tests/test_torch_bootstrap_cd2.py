"""fhe_tpu_torch's CKKS at composite degree 2 (two limbs a level, the
bootstrap's chain) against fhe_tpu on the CPU, byte for byte, at
tests/test_scheme_matrix.py's entry (N = 256, 8 levels, scale 2^52, dnum
= 2, seed 17): keygen, relinearization and rotation keys, encrypt, mul +
relinearize + rescale, rotate, and the decrypted values within that
test's bounds.

fhe_tpu runs jitted with the generator closed over (each draw once, at
trace time, in its order); each encryption is its own trace.
"""

import jax
import numpy as np
import pytest
import torch

from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu_torch.pke import ckks
from test_torch_bootstrap import same_ct

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CFG = dict(N=1 << 8, num_levels=8, scale_bits=52, dnum=2, composite_degree=2)
SEED = 17


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


@pytest.fixture(scope="module")
def both():
    """test_scheme_matrix's draws on the port and on fhe_tpu."""
    ctx = ckks.CkksContext.create(**CFG, device="cpu")
    jctx = j_ckks.CkksContext.create(**CFG)
    assert ctx.params.moduli == jctx.params.moduli
    assert ctx.params.special_mods == jctx.params.special_mods
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    rot = ctx.rotation_key_gen(sk, [1], rng)
    n = ctx.params.N // 2
    z1, z2 = rng.normal(size=n) * 0.5, rng.normal(size=n) * 0.5
    c1, c2 = ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng)
    jrng = np.random.default_rng(SEED)
    jsk, jpk = jax.jit(lambda: jctx.keygen(jrng))()
    jevk = jax.jit(lambda s: jctx.relin_key_gen(s, jrng))(jsk)
    jrot = jax.jit(lambda s: jctx.rotation_key_gen(s, [1], jrng))(jsk)
    jz1, jz2 = jrng.normal(size=n) * 0.5, jrng.normal(size=n) * 0.5
    jc1 = jax.jit(lambda: jctx.encrypt(jpk, jz1, jrng))()
    jc2 = jax.jit(lambda: jctx.encrypt(jpk, jz2, jrng))()
    assert np.array_equal(z1, jz1) and np.array_equal(z2, jz2)
    return ((ctx, sk, evk, rot, c1, c2, z1, z2),
            (jctx, jsk, jpk, jevk, jrot, jc1, jc2))


def test_keys_and_encryption_match_fhe_tpu(both):
    (ctx, sk, evk, rot, c1, c2, z1, _), (_, jsk, _, jevk, jrot, jc1, jc2) = both
    _eq(jsk.s_eval_full, sk.s_eval_full)
    for got, want in ((evk, jevk), (rot[1], jrot[1])):
        _eq(want.b, got.b)
        _eq(want.a, got.a)
    for got, want in ((c1, jc1), (c2, jc2)):
        same_ct(got, want)
    assert np.abs(ctx.decrypt(sk, c1).real - z1).max() < 1e-6


def test_mul_rescale_and_rotate_match_fhe_tpu(both):
    """mul + relinearize + rescale (and the fused mul_rescale) and rotate
    by 1 equal fhe_tpu's on the same ciphertexts and keys; decrypted
    within test_scheme_matrix's 4e-3."""
    (ctx, sk, evk, rot, c1, c2, z1, z2), (jctx, _, _, jevk, jrot, jc1, jc2) = both
    prod = ctx.rescale(ctx.mul(c1, c2, evk))
    jprod = jax.jit(lambda a, b: jctx.rescale(jctx.mul(a, b, jevk)))(jc1, jc2)
    same_ct(prod, jprod, "mul + rescale")
    same_ct(ctx.mul_rescale(c1, c2, evk), jprod, "mul_rescale")
    assert len(prod.moduli) == len(c1.moduli) - 2
    assert np.abs(ctx.decrypt(sk, prod).real - z1 * z2).max() < 4e-3
    r = ctx.rotate(c1, 1, rot)
    same_ct(r, jax.jit(lambda a: jctx.rotate(a, 1, jrot))(jc1), "rotate")
    assert np.abs(ctx.decrypt(sk, r).real - np.roll(z1, -1)).max() < 4e-3
