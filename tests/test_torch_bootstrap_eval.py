"""fhe_tpu_torch's fully packed bootstraps (pke/bootstrap.py
eval_bootstrap: the dense transforms and the level budgets (2, 2) and
(3, 3)) on the CPU: byte-equal to fhe_tpu's bootstrap.py run over the
port's ops (test_torch_bootstrap.py's `Bridge`), and decrypted within
fhe_tpu's tests/test_bootstrap.py bounds, at its sizes and seeds (N =
128, composite degree 2, a weight-16 secret)."""

import numpy as np
import pytest
import torch

from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu_torch.pke import bootstrap
from test_torch_bootstrap import (SLOTS, Bridge, boot_case,  # noqa: F401 (fixture)
                                  fhe_tpu_bootstrap_over_the_port, lowest, same_ct, to_j)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dense():
    """tests/test_bootstrap.py's boot_setup: 13 levels, seed 42."""
    return boot_case(42)


def test_bootstrap_refreshes_levels(dense, fhe_tpu_bootstrap_over_the_port):
    """A level-0 ciphertext comes back with >= 2 usable levels, within
    1e-4 of z (test_bootstrap_refreshes_levels); byte-equal to fhe_tpu's;
    eval_bootstrap_jit's closure gives the same bytes; the output
    multiplies to z^2 within 1e-4 (test_bootstrap_output_is_computable)."""
    ctx, sk, pk, pre, keys, rng = dense
    z = rng.uniform(-0.4, 0.4, size=SLOTS)
    ct = lowest(ctx, ctx.encrypt(pk, z, rng))
    assert len(ct.moduli) == ctx.cd
    out = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    same_ct(out, j_boot.eval_bootstrap(Bridge(ctx), to_j(ct), pre, keys), "eval_bootstrap")
    again = bootstrap.eval_bootstrap_jit(ctx, pre, keys)(ct)
    assert torch.equal(again.c0.data, out.c0.data) and torch.equal(again.c1.data, out.c1.data)
    assert len(out.moduli) >= 3 * ctx.cd
    assert np.abs(ctx.decrypt(sk, out).real - z).max() < 1e-4
    sq = ctx.rescale(ctx.mul(out, out, keys["evk"]))
    assert np.abs(ctx.decrypt(sk, sq).real - z * z).max() < 1e-4


@pytest.mark.parametrize("budget, levels", [((2, 2), 15), ((3, 3), 17)],
                         ids=["budget22", "budget33"])
def test_bootstrap_level_budget(budget, levels, fhe_tpu_bootstrap_over_the_port):
    """test_bootstrap_level_budget (15 levels, seed 77; (3, 3) spends two
    more): the collapsed special-FFT transforms, byte-equal to fhe_tpu's,
    within 1e-4."""
    ctx, sk, pk, pre, keys, rng = boot_case(77, num_levels=levels, level_budget=budget)
    assert len(pre.cts_levels) == len(pre.stc_levels) == budget[0]
    z = rng.uniform(-0.4, 0.4, size=SLOTS)
    ct = lowest(ctx, ctx.encrypt(pk, z, rng))
    out = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
    same_ct(out, j_boot.eval_bootstrap(Bridge(ctx), to_j(ct), pre, keys), "eval_bootstrap")
    assert len(out.moduli) >= 2 * ctx.cd
    assert np.abs(ctx.decrypt(sk, out).real - z).max() < 1e-4
