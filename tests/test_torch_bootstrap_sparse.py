"""fhe_tpu_torch's sparsely packed, SPARSE_ENCAPSULATED and iterative
(META-BTS) bootstraps (pke/bootstrap.py) on the CPU: byte-equal to
fhe_tpu's bootstrap.py run over the port's ops (test_torch_bootstrap.py's
`Bridge`) and decrypted within fhe_tpu's tests/test_bootstrap.py bounds,
at its sizes and seeds (N = 128, composite degree 2, 13 levels).

The `slow` test runs fhe_tpu's own bootstrap, jitted, on the port's keys
and ciphertext (its time in its docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch.pke import bootstrap
from test_torch_bootstrap import (CTX, H, SLOTS, Bridge, boot_case,  # noqa: F401 (fixture)
                                  fhe_tpu_bootstrap_over_the_port, lowest, same_ct, to_j)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


def test_sparse_bootstrap(fhe_tpu_bootstrap_over_the_port):
    """test_sparse_bootstrap (8 slots, seed 7): partial sum, one sine
    branch, rectangular transforms; >= 1 usable level, within 1e-3."""
    slots = 8
    ctx, sk, pk, pre, keys, rng = boot_case(7, slots=slots)
    z = rng.uniform(-0.4, 0.4, size=slots) + 1j * rng.uniform(-0.4, 0.4, size=slots)
    ct = lowest(ctx, ctx.encrypt(pk, z, rng, slots=slots))
    out = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    same_ct(out, j_boot.eval_bootstrap(Bridge(ctx), to_j(ct), pre, keys), "sparse")
    assert len(out.moduli) >= 2 * ctx.cd
    assert np.abs(ctx.decrypt(sk, out, slots=slots, sparse=True) - z).max() < 1e-3


def test_sparse_encapsulated_bootstrap(fhe_tpu_bootstrap_over_the_port):
    """test_sparse_encapsulated_bootstrap (seed 11): a dense main secret,
    the raise under the weight-16 helper; within 1e-3."""
    ctx, sk, pk, pre, keys, rng = boot_case(11, dense=True, encapsulate=True)
    z = rng.uniform(-0.4, 0.4, size=SLOTS)
    ct = lowest(ctx, ctx.encrypt(pk, z, rng))
    out = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    same_ct(out, j_boot.eval_bootstrap(Bridge(ctx), to_j(ct), pre, keys), "encapsulated")
    assert len(out.moduli) >= 3 * ctx.cd
    assert np.abs(ctx.decrypt(sk, out).real - z).max() < 1e-3


def test_iterative_bootstrap_improves_precision(fhe_tpu_bootstrap_over_the_port):
    """test_iterative_bootstrap_improves_precision (seed 42, a coarse sine
    fit tol = 1e-4): two iterations at 8 bits beat one at least 4x; the
    two-iteration output byte-equal to fhe_tpu's."""
    ctx, sk, pk, _, keys, rng = boot_case(42)
    pre = bootstrap.setup(ctx, h=H, tol=1e-4)
    z = rng.uniform(-0.4, 0.4, size=SLOTS)
    ct = lowest(ctx, ctx.encrypt(pk, z, rng))
    one = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    two = bootstrap.eval_bootstrap_iterative(ctx, ct, pre, keys, precision_bits=8)
    same_ct(two, j_boot.eval_bootstrap_iterative(Bridge(ctx), to_j(ct), pre, keys,
                                                 precision_bits=8), "iterative")
    e1 = np.abs(ctx.decrypt(sk, one).real - z).max()
    e2 = np.abs(ctx.decrypt(sk, two).real - z).max()
    assert e1 > 5e-6
    assert e2 < e1 / 4
    assert len(two.moduli) >= 2 * ctx.cd


def _jkey(k):
    return j_rlwe.EvalKey(b=jnp.asarray(k.b.numpy().astype(np.uint32)),
                          a=jnp.asarray(k.a.numpy().astype(np.uint32)),
                          moduli_qp=k.moduli_qp, num_per_part=k.num_per_part)


@pytest.mark.slow
def test_fhe_tpu_own_bootstrap_on_the_port_keys():
    """fhe_tpu's own eval_bootstrap_jit (its ring, its key switch, jitted)
    on the port's keys and ciphertext gives the port's bytes: the sparse
    8-slot bootstrap of test_sparse_bootstrap.  About 540 s on an 8-core
    CPU, nearly all of it jax compiling the bootstrap."""
    slots = 8
    ctx, _, pk, pre, keys, rng = boot_case(7, slots=slots)
    z = rng.uniform(-0.4, 0.4, size=slots) + 1j * rng.uniform(-0.4, 0.4, size=slots)
    ct = lowest(ctx, ctx.encrypt(pk, z, rng, slots=slots))
    jctx = j_ckks.CkksContext.create(num_levels=13, **CTX)
    jkeys = {"rot": {r: _jkey(k) for r, k in keys["rot"].items()},
             "conj": _jkey(keys["conj"]), "evk": _jkey(keys["evk"])}
    want = j_boot.eval_bootstrap_jit(jctx, pre, jkeys)(to_j(ct))
    same_ct(bootstrap.eval_bootstrap(ctx, ct, pre, keys), jax.device_get(want), "fhe_tpu's own")
