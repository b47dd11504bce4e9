"""Batch execution (port of fhe_tpu/parallel): the batch API facade."""

from .batch import (BatchFlags, BatchFuture, BatchResult, bootstrap_batch,
                    eval_bin_gate_batch, eval_func_batch)

__all__ = ["BatchFlags", "BatchFuture", "BatchResult", "bootstrap_batch",
           "eval_bin_gate_batch", "eval_func_batch"]
