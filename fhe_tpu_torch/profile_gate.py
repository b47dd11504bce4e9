"""Where the time of a gate goes, on one CUDA card.

    python3 -m fhe_tpu_torch.profile_gate [--seed S] [--batch B] [--set NAME] [--method M]

Makes the keys of --set (default STD128; --method AP for DM, the
*_LMKCDEY sets for LMKCDEY) from the seed on cuda:0, then prints:

1. a batch sweep of the whole AND gate (CUDA events, median of 3);
2. at --batch, the gate's stages one by one (CUDA events, median of 3):
   test vector, forward NTT, blind rotation (for DM and LMKCDEY the whole
   accumulator, its forward NTT included), extraction, and the three
   parts of switch_ct_to_qn (on a 2-limb RNS set, --set STD192 say:
   the limb-stacked forward NTT, the RNS blind rotation, extraction with
   the exact mod switch Q -> q_ks, key switch, mod switch to q); and the
   peak device memory of one gate;
3. one torch.profiler trace of the gate at --batch: the host wall time,
   the device busy time (the union of the CUDA kernel and memcpy/memset
   intervals), their ratio (busy share), the kernels by device time and
   the PyTorch operators by their own device time;
4. for GINX, the blind-rotation kernels alone at batch 1 and 4096 (CUDA
   events, median of 3): the scan in both orders and kernel 5's n
   launches, with the ciphertexts per block (C) that the wrappers choose.

Every line carries the card's name and power limit.  PERF.md's tables of
where the AP, LMKCDEY and RNS gates' time goes come from
`--set STD128_AP --method AP`, `--set STD128_LMKCDEY` and `--set STD192`.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import time

import numpy as np
import torch

from . import BinFheContext
from .math import ntt as nttmod
from .lattice import rns
from .tfhe import boot, lwe, rgsw, rgsw_rns
from .tfhe.params import Gate

SWEEP = (1, 8, 64, 256, 1024, 4096, 8192)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median CUDA-event time of 3 calls of fn() in ms, after one warm-up."""
    fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep(ctx, sk, key, rng, card: str) -> None:
    for batch in SWEEP:
        ct1 = ctx.encrypt(sk, rng.integers(0, 2, size=batch), rng)
        ct2 = ctx.encrypt(sk, rng.integers(0, 2, size=batch), rng)
        ms = time_ms(lambda: ctx.eval_bin_gate(key, Gate.AND, ct1, ct2))
        print(f"[sweep] AND batch {batch}: {ms:.3f} ms = {batch / ms * 1e3:.1f} gates/s  ({card})")


def rns_parts(p, key, comb, device) -> dict:
    """The RNS gate's stages (rgsw_rns.eval_bin_gate_rns), each on the
    inputs the gate gives it."""
    plan = rns.make_rns_plan(p.N, p.moduli_rns, device)
    tv = rgsw_rns._gate_test_vector_rns(p, comb.b, Gate.AND)
    acc = rgsw_rns.initial_acc_rns(p, tv)
    rot = rgsw_rns.blind_rotate_rns(p, key.bsk, acc, comb.a)
    offset = p.Q // 8 + 1
    ext = rgsw_rns.extract_switch_rns(p, rot, offset)
    ks = lwe.key_switch(p, key.ksk, ext)
    return {
        "test vector": lambda: rgsw_rns._gate_test_vector_rns(p, comb.b, Gate.AND),
        "forward NTT (limb-stacked kernel)": lambda: rns.ntt_forward(plan, tv),
        "blind rotation (PyTorch ops around the limb-stacked kernels)":
            lambda: rgsw_rns.blind_rotate_rns(p, key.bsk, acc, comb.a),
        "extraction + exact mod switch Q -> q_ks (limb-stacked inverse NTT kernel)":
            lambda: rgsw_rns.extract_switch_rns(p, rot, offset),
        "key switch": lambda: lwe.key_switch(p, key.ksk, ext),
        "mod switch q_ks -> q": lambda: lwe.mod_switch(ks, p.q),
    }


def stages(ctx, sk, key, rng, batch: int):
    """Two ciphertext batches and the gate's stages on them, each a call
    on the inputs the gate gives it."""
    p = ctx.params
    ct1 = ctx.encrypt(sk, rng.integers(0, 2, size=batch), rng)
    ct2 = ctx.encrypt(sk, rng.integers(0, 2, size=batch), rng)
    if p.moduli_rns:
        comb = lwe.add(ct1, ct2)
        parts = {"lwe add": lambda: lwe.add(ct1, ct2), **rns_parts(p, key, comb, ctx.device)}
        return ct1, ct2, parts
    plan = nttmod.make_plan(p.N, p.Q, ctx.device)
    comb = lwe.add(ct1, ct2)
    consts = boot.gate_constants(p, Gate.AND)
    tv = boot.make_gate_test_vector(p, comb.b, consts)
    acc1 = nttmod.ntt_forward(plan, tv)
    acc = torch.stack([torch.zeros_like(acc1), acc1], dim=1).contiguous()
    ginx = isinstance(key, rgsw.BootstrapKey)
    rotate = ((lambda: boot.blind_rotate(p, key, acc, comb.a)) if ginx else
              (lambda: boot.run_accumulator(p, key, tv, comb.a)))
    rot = rotate()
    offset = p.Q // 8 + 1
    ext = boot.extract_lwe(p, rot, offset)
    ms1 = lwe.mod_switch(ext, p.q_ks)
    ks = lwe.key_switch(p, key.ksk, ms1)
    parts = {
        "lwe add": lambda: lwe.add(ct1, ct2),
        "test vector": lambda: boot.make_gate_test_vector(p, comb.b, consts),
        "forward NTT (kernel)": lambda: nttmod.ntt_forward(plan, tv),
        "blind rotation (kernel)" if ginx else "accumulator (forward NTT included)": rotate,
        "extract_lwe (flip + inverse NTT kernel)": lambda: boot.extract_lwe(p, rot, offset),
        "mod switch Q -> q_ks": lambda: lwe.mod_switch(ext, p.q_ks),
        "key switch": lambda: lwe.key_switch(p, key.ksk, ms1),
        "mod switch q_ks -> q": lambda: lwe.mod_switch(ks, p.q),
    }
    return ct1, ct2, parts


def time_stages(ctx, key, ct1, ct2, parts: dict, batch: int, card: str) -> None:
    """Each stage timed alone, their sum beside the whole gate, and the
    gate's peak device memory."""
    total = 0.0
    for name, fn in parts.items():
        ms = time_ms(fn)
        total += ms
        print(f"[stage] batch {batch} {name}: {ms:.3f} ms  ({card})")
    gate_ms = time_ms(lambda: ctx.eval_bin_gate(key, Gate.AND, ct1, ct2))
    print(f"[stage] batch {batch} sum of stages {total:.3f} ms, whole AND gate "
          f"{gate_ms:.3f} ms  ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(ctx.device)
    base = torch.cuda.memory_allocated(ctx.device)
    ctx.eval_bin_gate(key, Gate.AND, ct1, ct2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(ctx.device)
    print(f"[stage] batch {batch} one AND gate: peak device memory {peak / 2**30:.3f} GiB, "
          f"{(peak - base) / 2**30:.3f} GiB above the keys and inputs  ({card})")


def _union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def trace(ctx, key, ct1, ct2, batch: int, card: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ctx.eval_bin_gate(key, Gate.AND, ct1, ct2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.eval_bin_gate(key, Gate.AND, ct1, ct2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[trace] batch {batch}: the profiler saw no device events; busy share "
              f"not measured (host wall {wall_us / 1e3:.3f} ms)  ({card})")
        return
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    print(f"[trace] batch {batch} AND gate: host wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({len(dev)} device events), busy share "
          f"{busy_us / wall_us:.3f}  ({card})")
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[trace]   {us / 1e3:9.3f} ms  x{count:<3d} {name[:110]}")
    ops = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
           if e.key.startswith("aten::")]
    for us, count, name in sorted(ops, reverse=True)[:12]:
        if us > 0:
            print(f"[trace] operator {us / 1e3:9.3f} ms self device time  x{count:<6d} {name}")


def rotation(ctx, key, rng, card: str) -> None:
    from .kernels import blind_rotate as kbr
    from .kernels import blind_rotate_br as kbr_br
    p = ctx.params
    pows = boot._psi_powers_mont_words(p.N, p.Q, ctx.device)
    kernels = (("natural scan", kbr.blind_rotate), ("bit-reversed scan", kbr_br.blind_rotate_mega),
               (f"kernel 5 x {p.n}", kbr_br.blind_rotate_fused))
    sms = torch.cuda.get_device_properties(ctx.device).multi_processor_count
    for batch in (1, 4096):
        acc = torch.from_numpy(rng.integers(0, p.Q, size=(batch, 2, p.N))).to(ctx.device,
                                                                              torch.int32)
        a = torch.from_numpy(rng.integers(0, p.q, size=(batch, p.n))).to(ctx.device, torch.int32)
        times = [(name, time_ms(lambda: fn(p, key.bsk_br, acc, a, pows))) for name, fn in kernels]
        print(f"[rotation] batch {batch}, C = {kbr.choose_c(batch, sms)}: "
              + ", ".join(f"{name} {ms:.3f} ms" for name, ms in times) + f"  ({card})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=20261016)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--set", default="STD128")
    parser.add_argument("--method", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gate: no CUDA device")
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}")
    ctx = BinFheContext.generate(args.set, method=args.method, device="cuda")
    print(f"[device] {args.set} ({ctx.params.method.value})")
    rng = np.random.default_rng(args.seed)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    sweep(ctx, sk, key, rng, card)
    ct1, ct2, parts = stages(ctx, sk, key, rng, args.batch)
    time_stages(ctx, key, ct1, ct2, parts, args.batch, card)
    trace(ctx, key, ct1, ct2, args.batch, card)
    if isinstance(key, rgsw.BootstrapKey):
        rotation(ctx, key, rng, card)


if __name__ == "__main__":
    main()
