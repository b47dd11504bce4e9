"""Console entry points for the installed package.

Port of fhe_tpu/cli.py.  `fhe-tpu-torch-bench` runs the inline STD128 AND
measurement on the first CUDA card (it never runs the repo's bench.py,
which drives fhe_tpu); `fhe-tpu-torch-server` is `server:main`.
"""

from __future__ import annotations

import json
import os
import subprocess


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def bench_main():
    """`fhe-tpu-torch-bench`: AND gates a second at batch FHE_BENCH_BATCH
    (4096) on FHE_BENCH_PARAMS (STD128), timed with CUDA events after one
    warm-up gate; the outputs are checked against the truth table.  Needs
    a CUDA card."""
    import numpy as np
    import torch

    from .tfhe import BinFheContext, Gate

    if not torch.cuda.is_available():
        raise RuntimeError("fhe-tpu-torch-bench measures the card: no CUDA device")
    param_set = os.environ.get("FHE_BENCH_PARAMS", "STD128")
    batch = int(os.environ.get("FHE_BENCH_BATCH", "4096"))
    ctx = BinFheContext.generate(param_set, device="cuda")
    rng = np.random.default_rng(2026)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    m1 = rng.integers(0, 2, size=batch)
    m2 = rng.integers(0, 2, size=batch)
    ct1, ct2 = ctx.encrypt(sk, m1, rng), ctx.encrypt(sk, m2, rng)
    ctx.eval_bin_gate(key, Gate.AND, ct1, ct2)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = ctx.eval_bin_gate(key, Gate.AND, ct1, ct2)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    wrong = int((ctx.decrypt(sk, out).cpu().numpy() != (m1 & m2)).sum())
    print(json.dumps({"metric": f"tfhe_{param_set.lower()}_and_gates_per_sec_h100",
                      "value": batch / ms * 1e3, "unit": "gates/s", "batch": batch,
                      "device_ms": ms, "wrong": wrong,
                      "device": torch.cuda.get_device_name(0), "card": card_line()}))
    if wrong:
        raise RuntimeError(f"{wrong} of {batch} AND outputs decrypt wrong")
