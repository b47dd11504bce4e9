"""fhe_tpu_torch's bootstrap keys (pke/bootstrap.py keygen) against
fhe_tpu's from one seed, byte for byte, and their carry-over
(convert.bootstrap_keys), on the CPU.

fhe_tpu runs jitted with the generator closed over, so its draws happen
once, at trace time, in its order: the secret and public key, then
bootstrap.keygen's rotation keys, conjugation key, relinearization key and
the SPARSE_ENCAPSULATED helper secret's two switching keys.  Sizes are
fhe_tpu's tests/test_bootstrap.py's (N = 128, 13 levels at composite
degree 2, dnum = 2), on a dense secret with a weight-16 helper.
"""

import jax
import numpy as np
import pytest
import torch

from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu_torch import convert
from fhe_tpu_torch.pke import bootstrap, ckks
from test_torch_bootstrap import CTX, H

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

SEED = 11


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


@pytest.fixture(scope="module")
def both():
    """The port's (sk, keys) and fhe_tpu's, each from SEED."""
    ctx = ckks.CkksContext.create(num_levels=13, device="cpu", **CTX)
    jctx = j_ckks.CkksContext.create(num_levels=13, **CTX)
    rng = np.random.default_rng(SEED)
    sk, _ = ctx.keygen(rng)
    pre = bootstrap.setup(ctx, h=H, level_budget=(2, 2))
    keys = bootstrap.keygen(ctx, sk, pre, rng, encapsulate_h=H)
    jrng = np.random.default_rng(SEED)
    jsk, _ = jax.jit(lambda: jctx.keygen(jrng))()
    jpre = j_boot.setup(jctx, h=H, level_budget=(2, 2))
    jkeys = jax.jit(lambda s: j_boot.keygen(jctx, s, jpre, jrng, encapsulate_h=H))(jsk)
    return (ctx, sk, keys), (jsk, jkeys)


def _same_key(got, want):
    assert (got.moduli_qp, got.num_per_part) == (want.moduli_qp, want.num_per_part)
    _eq(want.b, got.b)
    _eq(want.a, got.a)


def test_bootstrap_keys_match_fhe_tpu(both):
    """Every key of the dict, in fhe_tpu's draw order: the BSGS rotation
    keys of the level budget, conj, evk, swk_down and swk_up."""
    (_, sk, keys), (jsk, jkeys) = both
    _eq(jsk.s_signed, sk.s_signed)
    assert sorted(keys) == sorted(jkeys)
    assert sorted(keys["rot"]) == sorted(jkeys["rot"])
    for r in keys["rot"]:
        _same_key(keys["rot"][r], jkeys["rot"][r])
    for name in ("conj", "evk", "swk_down", "swk_up"):
        _same_key(keys[name], jkeys[name])


def test_convert_bootstrap_keys(both):
    """fhe_tpu's dict carried over equals the port's own keys."""
    (_, _, keys), (_, jkeys) = both
    carried = convert.bootstrap_keys(jkeys, device="cpu")
    assert sorted(carried["rot"]) == sorted(keys["rot"])
    for r in keys["rot"]:
        assert torch.equal(carried["rot"][r].b, keys["rot"][r].b)
        assert torch.equal(carried["rot"][r].a, keys["rot"][r].a)
    for name in ("conj", "evk", "swk_down", "swk_up"):
        assert torch.equal(carried[name].b, keys[name].b)
        assert torch.equal(carried[name].a, keys[name].a)
    with pytest.raises(ValueError, match="bootstrap key dict"):
        convert.bootstrap_keys({"rot": {}, "evk": jkeys["evk"]}, device="cpu")
