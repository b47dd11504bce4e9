#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fhe_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path once -- the batched, bootstrapped STD128 GINX
gate -- through its public entry points on the first CUDA device:

1. device: card name and power limit, torch, nvcc, triton;
2. build: compiles every kernel from fhe_tpu_torch/csrc/ (nvcc, sm_90a);
3. kernels against their plain PyTorch versions on the card, byte-equal;
4. main path: STD128 keygen, AND and XOR on 4096 independent random bit
   pairs and one single-gate AND, decrypted against the truth tables, with
   the kernels' launch counters reset just before and read just after;
5. timings with CUDA events: gates/s at batch 4096, single-gate latency,
   and each kernel against its plain version at the main path's shapes.

It exits non-zero, and prints no result, when there is no CUDA device or
any phase fails.  Its last two lines are a JSON object of the kernels and
the card's `nvidia-smi` name and power limit, then
{"ok": true, "device": {...}}.  Keys and inputs are made from SEED.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
BATCH = 4096
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "ntt_forward": ("fhe_tpu_torch/csrc/ntt.cu", "fhe_tpu/math/ntt_pallas.py:64"),
    "ntt_inverse": ("fhe_tpu_torch/csrc/ntt.cu", "fhe_tpu/math/ntt_pallas.py:79"),
    "blind_rotate": ("fhe_tpu_torch/csrc/blind_rotate.cu", "fhe_tpu/tfhe/boot_mxu.py:230"),
}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_report(card: str) -> None:
    from fhe_tpu_torch.kernels import _build
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} {torch.cuda.get_device_name(0)}")
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                        check=True, timeout=60)
    print(f"[device] nvcc: {nv.stdout.strip().splitlines()[-1]}")
    spec = importlib.util.find_spec("triton")
    print(f"[device] triton importable: {spec is not None}")


def build() -> None:
    from fhe_tpu_torch.kernels import _build
    lib = _build.library()
    print(f"[build] {'built' if lib.built else 'loaded cached'} {lib.path.name} "
          f"in {lib.seconds:.2f} s")
    for line in lib.log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")


class Errors:
    """Largest |kernel - plain| seen per kernel in this run."""

    def __init__(self):
        self.max = {name: 0 for name in KERNELS}

    def compare(self, name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max[name] = max(self.max[name], err)
        print(f"[kernels] {what}: max |kernel - plain| = {err}")
        if err != 0:
            fail(f"{what}: kernel disagrees with its plain version")


def _residues(rng, high, shape, dev):
    return torch.from_numpy(rng.integers(0, high, size=shape)).to(dev, torch.int32)


def check_kernels(dev, errors: Errors) -> None:
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.tfhe import boot, make_params
    rng = np.random.default_rng(SEED + 1)
    q = 134215681
    for rows, N in [(64, 1024), (4024, 1024), (64, 512)]:
        plan = ntt.make_plan(N, q, dev)
        x = _residues(rng, q, (rows, N), dev)
        f = ntt.ntt_forward(plan, x)
        errors.compare("ntt_forward", f, ntt.forward_butterfly(plan, x), f"ntt_forward [{rows}, {N}]")
        i = ntt.ntt_inverse(plan, f)
        errors.compare("ntt_inverse", i, ntt.inverse_butterfly(plan, f), f"ntt_inverse [{rows}, {N}]")
        errors.compare("ntt_inverse", i, x, f"ntt_inverse(ntt_forward) [{rows}, {N}] round trip")
    for name, steps in [("STD128", 16), ("TOY", 64)]:
        p = make_params(name)
        acc = _residues(rng, p.Q, (8, 2, p.N), dev)
        bsk = _residues(rng, p.Q, (steps, 2, p.digits_g2, 2, p.N), dev)
        a = _residues(rng, p.q, (8, steps), dev)
        errors.compare("blind_rotate", boot.blind_rotate(p, bsk, acc, a),
                       boot.blind_rotate_plain(p, bsk, acc, a),
                       f"blind_rotate {name} B=8 steps={steps} random key")
    torch.cuda.synchronize()


def main_path(dev):
    """STD128 keygen + AND/XOR at batch 4096 + one single gate, decrypted."""
    from fhe_tpu_torch import BinFheContext, kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ctx = BinFheContext.generate("STD128", device=dev)
    rng = np.random.default_rng(SEED)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    print(f"[main] STD128 keygen (sk, ksk {tuple(key.ksk.a.shape)}, bsk "
          f"{tuple(key.bsk.shape)}) on {dev}: {keygen_s:.3f} s")
    m1 = rng.integers(0, 2, size=BATCH)
    m2 = rng.integers(0, 2, size=BATCH)
    ct1, ct2 = ctx.encrypt(sk, m1, rng), ctx.encrypt(sk, m2, rng)
    truth = {"AND": m1 & m2, "XOR": m1 ^ m2}
    for gate, want in truth.items():
        t0 = time.perf_counter()
        out = ctx.eval_bin_gate(key, gate, ct1, ct2)
        got = ctx.decrypt(sk, out).cpu().numpy()
        first_s = time.perf_counter() - t0
        if out.a.shape != (BATCH, ctx.params.n) or out.modulus != ctx.params.q:
            fail(f"{gate}: output ciphertext shape {tuple(out.a.shape)} mod {out.modulus}")
        wrong = int((got != want).sum())
        print(f"[main] {gate} batch {BATCH}: {wrong} wrong of {BATCH} "
              f"(ones in output: {int(got.sum())}), first call {first_s:.3f} s")
        if wrong:
            fail(f"{gate} does not decrypt to its truth table")
    one1, one2 = ctx.encrypt(sk, m1[:1], rng), ctx.encrypt(sk, m2[:1], rng)
    got = ctx.decrypt(sk, ctx.eval_bin_gate(key, "AND", one1, one2)).cpu().numpy()
    print(f"[main] single AND({m1[0]}, {m2[0]}) = {got.tolist()}")
    if got.tolist() != [int(m1[0] & m2[0])]:
        fail("single-gate AND is wrong")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[main] kernel launches in the main path: {launches}")
    for name in KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the main path")
    print(f"[main] peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return ctx, sk, key, (ct1, ct2, one1, one2), launches


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms; the caller has warmed fn up."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(dev, ctx, key, cts, errors: Errors, card: str) -> dict:
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.tfhe import boot
    ct1, ct2, one1, one2 = cts
    p = ctx.params
    batch_ms = time_ms(lambda: ctx.eval_bin_gate(key, "AND", ct1, ct2), reps=3)
    single_ms = time_ms(lambda: ctx.eval_bin_gate(key, "AND", one1, one2), reps=5)
    print(f"[time] STD128 AND batch {BATCH}: {batch_ms:.3f} ms = "
          f"{BATCH / batch_ms * 1e3:.1f} gates/s  ({card})")
    print(f"[time] STD128 single-gate AND latency: {single_ms:.3f} ms  ({card})")

    rng = np.random.default_rng(SEED + 2)
    plan = ntt.make_plan(p.N, p.Q, dev)
    x_f = _residues(rng, p.Q, (BATCH, p.N), dev)            # the test vectors
    x_i = _residues(rng, p.Q, (2 * BATCH, p.N), dev)        # extract_lwe
    acc = _residues(rng, p.Q, (BATCH, 2, p.N), dev)
    a = _residues(rng, p.q, (BATCH, p.n), dev)
    cases = {
        "ntt_forward": (f"[{BATCH}, {p.N}]", lambda: ntt.ntt_forward(plan, x_f),
                        lambda: ntt.forward_butterfly(plan, x_f), 5),
        "ntt_inverse": (f"[{2 * BATCH}, {p.N}]", lambda: ntt.ntt_inverse(plan, x_i),
                        lambda: ntt.inverse_butterfly(plan, x_i), 5),
        "blind_rotate": (f"[{BATCH}, 2, {p.N}] x {p.n} steps, STD128 key",
                         lambda: boot.blind_rotate(p, key.bsk, acc, a),
                         lambda: boot.blind_rotate_plain(p, key.bsk, acc, a), 1),
    }
    result = {}
    for name, (shape, kern, plain, reps) in cases.items():
        errors.compare(name, kern(), plain(), f"{name} {shape} (main-path shape)")
        k_ms = time_ms(kern, reps=max(reps, 3))
        p_ms = time_ms(plain, reps=reps)
        print(f"[time] {name} {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms  ({card})")
        result[name] = (k_ms, p_ms)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    from fhe_tpu_torch import kernels  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    card = card_line()
    device_report(card)
    build()
    errors = Errors()
    check_kernels(dev, errors)
    ctx, sk, key, cts, launches = main_path(dev)
    times = timings(dev, ctx, key, cts, errors, card)
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errors.max[name],
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
