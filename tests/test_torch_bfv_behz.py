"""fhe_tpu_torch's BFV product by BEHZ (pke/bfv.py, the BEHZ kit of
lattice/rns.py) relinearized with a BV key (pke/rlwe.py) against fhe_tpu's
on the CPU, byte for byte, at tests/test_bfv.py's size (N = 256, 3 limbs of
28 bits, t = 65537, dnum = 2), and decrypted; a BFV rotation with a
base-2^10 BV key.  (HPS and the kit's functions alone are in
test_torch_bfv.py: fhe_tpu compiles each whole product for about 14 s on
the CPU, so each file keeps one.)

fhe_tpu runs only jitted, on the port's ciphertexts and key carried over as
arrays.  The port runs with device="cpu" (the plain NTTs).
"""

import jax
import numpy as np
import pytest
import torch

from fhe_tpu.pke import bfv as j_bfv
from fhe_tpu_torch.pke import bfv, rlwe
from test_torch_bfv import _eq, _jpoly
from test_torch_keyswitch_bv import _jbv

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SEED = 54


@pytest.fixture(scope="module")
def setup():
    """The contexts, the port's keys (a per-limb BV relinearization key),
    the ciphertexts of m1 and m2, and their BEHZ product relinearized with
    the BV key."""
    kw = dict(N=N, num_limbs=3, plain_mod=65537, mod_bits=28, dnum=2)
    ctx, jctx = bfv.BfvContext.create(**kw, device="cpu"), j_bfv.BfvContext.create(**kw)
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    key = ctx.relin_key_gen(sk, rng, method="bv")
    m1, m2 = rng.integers(0, ctx.t, size=(2, N))
    ct1, ct2 = ctx.encrypt(pk, m1, rng), ctx.encrypt(pk, m2, rng)
    return ctx, jctx, sk, key, (ct1, ct2), (m1, m2), ctx.mul(ct1, ct2, key, technique="behz")


def test_behz_mul_with_bv_key_matches_fhe_tpu(setup):
    ctx, jctx, _, key, (ct1, ct2), _, got = setup
    assert isinstance(key, rlwe.BvEvalKey) and got.c2 is None
    jct = lambda c: j_bfv.Ciphertext(_jpoly(c.c0), _jpoly(c.c1))
    want = jax.jit(lambda a, b, k: jctx.mul(a, b, k, technique="behz"))(jct(ct1), jct(ct2),
                                                                        _jbv(key))
    _eq(want.c0.data, got.c0.data)
    _eq(want.c1.data, got.c1.data)


def test_behz_mul_with_bv_key_decrypts(setup):
    ctx, _, sk, _, _, (m1, m2), got = setup
    np.testing.assert_array_equal(ctx.decrypt(sk, got), m1 * m2 % ctx.t)


def test_rotation_with_bv_key_decrypts(setup):
    """A rotation by 1 with a base-2^10 BV key moves the slots as the
    automorphism 5 moves the mod-t NTT's points."""
    ctx, _, sk, _, (ct1, _), (m1, _), _ = setup
    rot = ctx.rotation_key_gen(sk, [1], np.random.default_rng(SEED + 1), method="bv",
                               digit_bits=10)
    i = np.arange(N)
    np.testing.assert_array_equal(ctx.decrypt(sk, ctx.rotate(ct1, 1, rot)),
                                  m1[((2 * i + 1) * 5 % (2 * N) - 1) // 2])
