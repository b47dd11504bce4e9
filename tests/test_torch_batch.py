"""fhe_tpu_torch.parallel, the batch API, on the CPU at TOY: the result
counts, ASYNC futures, NO_BOOTSTRAP, eval_func_batch, the unported mesh=,
and the flags against fhe_tpu's.
"""

import numpy as np
import pytest
import torch

from fhe_tpu.parallel import batch as jbatch
from fhe_tpu_torch import BinFheContext
from fhe_tpu_torch.parallel import (BatchFlags, BatchFuture, BatchResult, bootstrap_batch,
                                    eval_bin_gate_batch, eval_func_batch)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy():
    ctx = BinFheContext.generate("TOY", device="cpu")
    sk = ctx.key_gen(1)
    key = ctx.bt_key_gen(sk, 2)
    rng = np.random.default_rng(3)
    m1, m2 = rng.integers(0, 2, size=(2, 8))
    return ctx, sk, key, m1, m2, ctx.encrypt(sk, m1, rng), ctx.encrypt(sk, m2, rng)


def _same_ct(got, want):
    torch.testing.assert_close(got.a, want.a, rtol=0, atol=0)
    torch.testing.assert_close(got.b, want.b, rtol=0, atol=0)


def test_flags_match_fhe_tpu():
    assert {f.name: f.value for f in BatchFlags} == {f.name: f.value for f in jbatch.BatchFlags}


@pytest.mark.parametrize("impl", [None, "mega", "fused"])
def test_gate_batch_counts_and_decrypts(impl, toy):
    ctx, sk, key, m1, m2, ct1, ct2 = toy
    ctx = BinFheContext(params=ctx.params, device=ctx.device, ntt_impl=impl)
    out, res = eval_bin_gate_batch(ctx, key, "AND", ct1, ct2)
    assert res == BatchResult(success=True, processed=8, failed=0, error="")
    np.testing.assert_array_equal(ctx.decrypt(sk, out).numpy(), m1 & m2)


def test_async_future_equals_sync_result(toy):
    ctx, _, key, _, _, ct1, ct2 = toy
    sync, _ = eval_bin_gate_batch(ctx, key, "XOR", ct1, ct2)
    fut, res = eval_bin_gate_batch(ctx, key, "XOR", ct1, ct2, BatchFlags.ASYNC)
    assert isinstance(fut, BatchFuture) and res.success and res.processed == 8
    assert fut.done()
    _same_ct(fut.result(), sync)
    fut, res = bootstrap_batch(ctx, key, ct1, BatchFlags.ASYNC)
    _same_ct(fut.result(), ctx.bootstrap(key, ct1))


def test_bootstrap_batch_and_no_bootstrap(toy):
    ctx, sk, key, m1, _, ct1, _ = toy
    out, res = bootstrap_batch(ctx, key, ct1, BatchFlags.NO_BOOTSTRAP)
    assert out is ct1 and res == BatchResult(True, 8)
    out, res = bootstrap_batch(ctx, key, ct1)
    assert res == BatchResult(True, 8)
    np.testing.assert_array_equal(ctx.decrypt(sk, out).numpy() % 2, m1)


def test_eval_func_batch_succeeds(toy):
    """A LUT bootstrap over the batch, ASYNC: the identity over Z_2, the
    context's plaintext space (an arbitrary LUT at TOY: two bootstraps at
    2q)."""
    ctx, sk, key, m1, _, _, _ = toy
    assert ctx.max_plaintext_space == 2
    ct = ctx.encrypt(sk, m1, 5, p=2)
    fut, res = eval_func_batch(ctx, key, ct, ctx.generate_lut(lambda m, p: m, 2),
                               BatchFlags.ASYNC)
    assert res == BatchResult(success=True, processed=8, failed=0, error="")
    assert fut.done()
    np.testing.assert_array_equal(ctx.decrypt(sk, fut.result(), 2).numpy(), m1)


def test_mesh_raises_naming_its_roadmap_item(toy):
    ctx, _, key, _, _, ct1, ct2 = toy
    calls = [lambda: bootstrap_batch(ctx, key, ct1, mesh=object()),
             lambda: eval_bin_gate_batch(ctx, key, "AND", ct1, ct2, mesh=object()),
             lambda: eval_func_batch(ctx, key, ct1, None, mesh=object())]
    for call in calls:
        with pytest.raises(NotImplementedError, match="item 17"):
            call()


def test_failures_are_reported(toy):
    """An exception inside the batch call comes back as success=False: an
    eval_func LUT of the wrong length, and a gate with an unknown ntt_impl."""
    ctx, _, key, _, _, ct1, ct2 = toy
    out, res = eval_func_batch(ctx, key, ct1, np.arange(4))
    assert out is None
    assert (res.success, res.processed, res.failed) == (False, 0, 8)
    assert "a LUT over Z_512 needs 512 entries" in res.error
    bad = BinFheContext(params=ctx.params, device=ctx.device, ntt_impl="lanes")
    out, res = eval_bin_gate_batch(bad, key, "AND", ct1, ct2)
    assert out is None and not res.success and "ntt_impl" in res.error
