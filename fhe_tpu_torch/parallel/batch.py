"""The batch API facade (port of fhe_tpu/parallel/batch.py).

BootstrapBatch / EvalBinGateBatch / EvalFuncBatch of the reference's
batch layer (binfhe-batch.h: BatchFlags, BatchResult).  Every context
call already takes a whole batch, so a batch call is one context call:

* ASYNC returns a `BatchFuture` at once.  The kernels are in flight on
  the current CUDA stream; the future holds an event recorded after the
  launches, `done()` queries it and `result()` waits for it.  Without
  ASYNC the call waits for the stream before it returns.
* A call that raises is reported as `BatchResult(success=False, ...)`
  with the error, as the reference reports a partial failure.
* `mesh=` (sharding the batch over several cards) is ROADMAP queue 1
  item 17 and raises NotImplementedError; `make_mesh`, `shard_batch`
  and `replicate` wait for that item.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class BatchFlags(enum.IntFlag):
    """binfhe-batch.h BatchFlags, with fhe_tpu's names and values.
    INPLACE is accepted as a no-op: a batch call returns new tensors."""
    DEFAULT = 0
    ASYNC = 1 << 0
    INPLACE = 1 << 1
    NO_BOOTSTRAP = 1 << 2
    TPU_PREFER = 1 << 3
    CPU_FORCE = 1 << 4


@dataclasses.dataclass
class BatchResult:
    """binfhe-batch.h BatchResult."""
    success: bool
    processed: int
    failed: int = 0
    error: str = ""


@dataclasses.dataclass
class BatchFuture:
    """An asynchronous batch result.  `event` is None for CPU tensors,
    whose result is complete when the call returns."""
    value: object
    event: torch.cuda.Event | None = None

    def result(self):
        if self.event is not None:
            self.event.synchronize()
        return self.value

    def done(self) -> bool:
        return self.event is None or self.event.query()


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the batch sharded over several cards) is not ported to "
            "fhe_tpu_torch yet (ROADMAP.md queue 1, item 17)")


def _finish(out, flags: BatchFlags):
    device = out.a.device
    if flags & BatchFlags.ASYNC:
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return BatchFuture(out, event)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out


def _batch_size(ct) -> int:
    return int(np.prod(ct.batch_shape)) if ct.batch_shape else 1


def _run(call, n: int, flags: BatchFlags):
    try:
        return _finish(call(), flags), BatchResult(True, n)
    except Exception as e:              # the reference's partial-failure report
        return None, BatchResult(False, 0, n, str(e))


def bootstrap_batch(ctx, key, cts, flags: BatchFlags = BatchFlags.DEFAULT, mesh=None):
    """BootstrapBatch: refresh a whole ciphertext batch.
    Returns (result or future, BatchResult)."""
    _no_mesh(mesh)
    n = _batch_size(cts)
    if flags & BatchFlags.NO_BOOTSTRAP:
        return cts, BatchResult(True, n)
    return _run(lambda: ctx.bootstrap(key, cts), n, flags)


def eval_bin_gate_batch(ctx, key, gate, cts1, cts2,
                        flags: BatchFlags = BatchFlags.DEFAULT, mesh=None):
    """EvalBinGateBatch: one two-input gate over a whole batch."""
    _no_mesh(mesh)
    return _run(lambda: ctx.eval_bin_gate(key, gate, cts1, cts2), _batch_size(cts1), flags)


def eval_func_batch(ctx, key, cts, lut, flags: BatchFlags = BatchFlags.DEFAULT, mesh=None):
    """EvalFuncBatch: a LUT bootstrap over a whole batch."""
    _no_mesh(mesh)
    return _run(lambda: ctx.eval_func(key, cts, lut), _batch_size(cts), flags)
