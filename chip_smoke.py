#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fhe_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path -- the batched, bootstrapped STD128 GINX gate
-- through its public entry points on the first CUDA device, once through
each of the three accumulators (`ntt_impl` None, "mega", "fused"):

1. device: card name and power limit, torch, nvcc, triton;
2. build: compiles every kernel from fhe_tpu_torch/csrc/ (nvcc, sm_90a);
3. kernels against their plain PyTorch versions on the card, byte-equal:
   the NTT kernels at every N of csrc/ntt_shapes.h with 1, 3 and
   P x SMs + 1 rows (P rows a block: the last block has masked rows), a
   prime below 2^30 (lazy butterflies) and one in (2^30, 2^31) (canonical),
   natural and bit-reversed output and the round trip, and N = 2^14
   refused with a ValueError; the blind rotations at batch 1, 8 and an odd
   4097, which the wrappers run two ciphertexts to a block with one masked
   lane;
4. main path, once per accumulator: STD128 keygen (once), AND and XOR on
   4096 independent random bit pairs, one single-gate AND, CMUX at batch
   4096 and the batch API's ASYNC AND, decrypted against the truth tables,
   with the kernels' launch counters reset just before each accumulator's
   run and read just after; the three accumulators' outputs must be
   identical;
5. timings with CUDA events: gates/s at batch 4096 and single-gate latency
   per accumulator, and each kernel against its plain version at the main
   path's shapes, beside its bound (the least time the card could take);
   the NTT kernels, and their plain versions, with a cold L2 (each call
   after writing a 256 MB buffer, so that it reads its input from device
   memory: `profile_ntt.time_cold_ms`), also at the single gate's shapes;
   the blind-rotation kernels' resident blocks per SM at batch 4096.

The build lines give each kernel's registers and spills (`-Xptxas -v`); a
spill in any NTT kernel, or in a blind-rotation kernel at STD128's shape,
fails the run.

It exits non-zero, and prints no result, when there is no CUDA device or
any phase fails.  Its last three lines are a JSON object of the kernels,
the card's `nvidia-smi` name and power limit, then
{"ok": true, "device": {...}}.  Keys and inputs are made from SEED.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
BATCH = 4096
IMPLS = (None, "mega", "fused")
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "ntt_forward": ("fhe_tpu_torch/csrc/ntt.cuh", "fhe_tpu/math/ntt_pallas.py:64"),
    "ntt_inverse": ("fhe_tpu_torch/csrc/ntt.cuh", "fhe_tpu/math/ntt_pallas.py:79"),
    "blind_rotate": ("fhe_tpu_torch/csrc/blind_rotate.cuh", "fhe_tpu/tfhe/boot_mxu.py:230"),
    "blind_rotate_mega": ("fhe_tpu_torch/csrc/blind_rotate.cuh",
                          "fhe_tpu/tfhe/boot_pallas.py:235"),
    "rotate_step_br": ("fhe_tpu_torch/csrc/blind_rotate.cuh",
                       "fhe_tpu/tfhe/boot_pallas.py:153"),
}
# the accumulator kernel each ntt_impl runs, and its launches per gate
ACC_KERNEL = {None: "blind_rotate", "mega": "blind_rotate_mega", "fused": "rotate_step_br"}
HBM_BYTES_PER_S = 3.35e12       # NVIDIA H100 SXM data sheet
IMUL_PER_CLOCK_PER_SM = 64      # CUDA C++ Programming Guide throughput table, cc 9.0


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def kernel_reports(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) per compiled kernel in the
    ptxas report, named by their template arguments: blind rotations
    (log2 N, dG2, C[, natural]), NTTs (log2 N, lazy[, out_br])."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            args = ", ".join(re.findall(r"L[ib](\d+)E", mangled))
            kind = ("scan_kernel" if "scan_kernel" in mangled else
                    "step_kernel" if "step_kernel" in mangled else
                    "ntt_forward_kernel" if "forward_kernel" in mangled else
                    "ntt_inverse_kernel")
            name, spill = f"{kind}<{args}>" if args else kind, 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def build() -> None:
    from fhe_tpu_torch.kernels import _build
    lib = _build.library()
    print(f"[build] {'built' if lib.built else 'loaded cached'} {lib.path.name} "
          f"in {lib.seconds:.2f} s ({len(_build.units())} units, one nvcc each)")
    reports = kernel_reports(lib.log)
    for name, regs, spill in reports:
        print(f"[build] {name}: {regs} registers, {spill} bytes spill stores")
    spilled = [name for name, _, spill in reports if name.startswith(
        ("scan_kernel<10, 4,", "step_kernel<10, 4,", "ntt_")) and spill]
    if lib.built and spilled:
        fail(f"NTT kernels or kernels at STD128's shape spill: {spilled}")


class Errors:
    """Largest |kernel - plain| seen per kernel in this run."""

    def __init__(self):
        self.max = {name: 0 for name in KERNELS}

    def compare(self, name: str, got: torch.Tensor, want: torch.Tensor, what: str,
                show: bool = True) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max[name] = max(self.max[name], err)
        if show:
            print(f"[kernels] {what}: max |kernel - plain| = {err}")
        if err != 0:
            fail(f"{what}: kernel disagrees with its plain version")


def _residues(rng, high, shape, dev):
    return torch.from_numpy(rng.integers(0, high, size=shape)).to(dev, torch.int32)


def check_ntt_kernels(dev, errors: Errors) -> None:
    """Kernels 1 and 2 at every instantiated N, rows 1, 3 and P x SMs + 1,
    q on both sides of 2^30; N = 2^14 refused before any launch."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.kernels import ntt as kntt
    from fhe_tpu_torch.math import ntt, primes
    rng = np.random.default_rng(SEED + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for N in kntt.sizes():
        rows_all = (1, 3, kntt.rows_per_block(N) * sms + 1)
        for q in (primes.last_prime(27, 2 * N), primes.last_prime(31, 2 * N)):
            plan = ntt.make_plan(N, q, dev)
            for rows in rows_all:
                at = f"[{rows}, {N}] q={q}"
                x = _residues(rng, q, (rows, N), dev)
                f = ntt.ntt_forward(plan, x)
                errors.compare("ntt_forward", f, ntt.forward_butterfly(plan, x),
                               f"ntt_forward {at}", show=False)
                errors.compare("ntt_forward", ntt.ntt_forward(plan, x, out_br=True),
                               ntt.forward_butterfly(plan, x, out_br=True),
                               f"ntt_forward out_br {at}", show=False)
                i = ntt.ntt_inverse(plan, f)
                errors.compare("ntt_inverse", i, ntt.inverse_butterfly(plan, f),
                               f"ntt_inverse {at}", show=False)
                errors.compare("ntt_inverse", i, x, f"ntt round trip {at}", show=False)
            arith = "lazy" if q < kntt.LAZY_Q else "canonical"
            print(f"[kernels] ntt N={N} q={q} ({arith}), rows {rows_all}: forward, forward "
                  f"out_br, inverse, round trip byte-equal to the plain versions")
    N = 1 << 14
    plan = ntt.make_plan(N, primes.last_prime(27, 2 * N), dev)
    before = kernels.launch_counts()
    for what, fn in (("forward", ntt.ntt_forward), ("inverse", ntt.ntt_inverse)):
        try:
            fn(plan, torch.zeros(1, N, dtype=torch.int32, device=dev))
        except ValueError as e:
            print(f"[kernels] ntt {what} N={N}: ValueError: {e}")
        else:
            fail(f"ntt {what} at N = {N} was not refused")
    if kernels.launch_counts() != before:
        fail(f"ntt at N = {N} launched a kernel")


def check_kernels(dev, errors: Errors) -> None:
    from fhe_tpu_torch.tfhe import boot, boot_pallas, make_params, rgsw
    check_ntt_kernels(dev, errors)
    rng = np.random.default_rng(SEED + 1)
    for name, steps, B in [("STD128", 16, 8), ("STD128", 16, 1), ("STD128", 16, 4097),
                           ("TOY", 64, 8)]:
        p = make_params(name)
        acc = _residues(rng, p.Q, (B, 2, p.N), dev)
        bsk = _residues(rng, p.Q, (steps, 2, p.digits_g2, 2, p.N), dev)
        a = _residues(rng, p.q, (B, steps), dev)
        what = f"{name} B={B} steps={steps} random key"
        errors.compare("blind_rotate", boot.blind_rotate(p, rgsw.BootstrapKey(bsk, None), acc, a),
                       boot.blind_rotate_plain(p, bsk, acc, a), f"blind_rotate {what}")
        want = boot_pallas.blind_rotate_mega_plain(p, bsk, acc, a)
        errors.compare("blind_rotate_mega", boot_pallas.blind_rotate_mega(p, bsk, acc, a), want,
                       f"blind_rotate_mega {what}")
        errors.compare("rotate_step_br", boot_pallas.blind_rotate_fused(p, bsk, acc, a), want,
                       f"rotate_step_br x {steps} launches (blind_rotate_fused) {what}")
        errors.compare("rotate_step_br", boot_pallas.rotate_step_br(p, bsk[0], acc, a[:, 0]),
                       boot_pallas.rotate_step_br_plain(p, bsk[0], acc, a[:, 0]),
                       f"rotate_step_br one step {name} B={B}")
    torch.cuda.synchronize()


def run_path(ctx, sk, key, bits, cts, impl):
    """One accumulator's run of the main path; returns its output
    ciphertexts and the launches of each kernel in it."""
    from fhe_tpu_torch import kernels
    from fhe_tpu_torch.parallel import BatchFlags, eval_bin_gate_batch
    m1, m2, sel = bits
    ct1, ct2, cs, one1, one2 = cts
    ctx = dataclasses.replace(ctx, ntt_impl=impl)
    tag = f"[main] ntt_impl={impl}"

    def decrypt_check(what, out, want, shape=(BATCH,)):
        if out.a.shape != shape + (ctx.params.n,) or out.modulus != ctx.params.q:
            fail(f"{what}: output ciphertext shape {tuple(out.a.shape)} mod {out.modulus}")
        got = ctx.decrypt(sk, out).cpu().numpy()
        wrong = int((got != want).sum())
        print(f"{tag} {what}: {wrong} wrong of {got.size} (ones in output: {int(got.sum())})")
        if wrong:
            fail(f"{what} with ntt_impl={impl} does not decrypt to its truth table")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {"AND": ctx.eval_bin_gate(key, "AND", ct1, ct2),
            "XOR": ctx.eval_bin_gate(key, "XOR", ct1, ct2),
            "single AND": ctx.eval_bin_gate(key, "AND", one1, one2),
            "CMUX": ctx.eval_cmux(key, ct1, ct2, cs)}
    fut, res = eval_bin_gate_batch(ctx, key, "AND", ct1, ct2, BatchFlags.ASYNC)
    if not res.success or res.processed != BATCH:
        fail(f"eval_bin_gate_batch with ntt_impl={impl}: {res}")
    outs["batch API AND"] = fut.result()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    first_s = time.perf_counter() - t0
    gates = 7                       # AND, XOR, single AND, 3 NANDs of the CMUX, batch API
    print(f"{tag} {gates} gates (first calls) in {first_s:.3f} s; launches: {launches}")
    decrypt_check(f"AND batch {BATCH}", outs["AND"], m1 & m2)
    decrypt_check(f"XOR batch {BATCH}", outs["XOR"], m1 ^ m2)
    decrypt_check("single AND", outs["single AND"], (m1 & m2)[:1], shape=(1,))
    decrypt_check(f"CMUX batch {BATCH}", outs["CMUX"], np.where(sel == 1, m2, m1))
    decrypt_check(f"eval_bin_gate_batch ASYNC AND batch {BATCH}", outs["batch API AND"], m1 & m2)
    per_gate = ctx.params.n if impl == "fused" else 1
    for name in KERNELS:
        want = gates * per_gate if name == ACC_KERNEL[impl] else (
            0 if name in ACC_KERNEL.values() else None)
        if want is None and launches[name] <= 0:
            fail(f"kernel {name} was not launched by the main path with ntt_impl={impl}")
        if want is not None and launches[name] != want:
            fail(f"kernel {name}: {launches[name]} launches with ntt_impl={impl}, "
                 f"expected {want}")
    return outs, launches


def main_path(dev):
    """STD128 keygen, then each accumulator's run; the outputs must agree."""
    from fhe_tpu_torch import BinFheContext
    t0 = time.perf_counter()
    ctx = BinFheContext.generate("STD128", device=dev)
    rng = np.random.default_rng(SEED)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    torch.cuda.synchronize()
    print(f"[main] STD128 keygen (sk, ksk {tuple(key.ksk.a.shape)}, bsk "
          f"{tuple(key.bsk.shape)}) on {dev}: {time.perf_counter() - t0:.3f} s")
    bits = tuple(rng.integers(0, 2, size=BATCH) for _ in range(3))
    cts = tuple(ctx.encrypt(sk, m, rng) for m in bits)
    cts += (ctx.encrypt(sk, bits[0][:1], rng), ctx.encrypt(sk, bits[1][:1], rng))
    launches, first = {}, None
    for impl in IMPLS:
        outs, launches[impl] = run_path(ctx, sk, key, bits, cts, impl)
        if first is None:
            first = outs
            continue
        for what, out in outs.items():
            if not (torch.equal(out.a, first[what].a) and torch.equal(out.b, first[what].b)):
                fail(f"{what}: ntt_impl={impl} output differs from ntt_impl=None")
        print(f"[main] ntt_impl={impl}: all {len(outs)} outputs identical to ntt_impl=None")
    print(f"[main] peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    path_launches = {name: launches[None][name] for name in ("ntt_forward", "ntt_inverse")}
    path_launches.update({name: launches[impl][name] for impl, name in ACC_KERNEL.items()})
    return ctx, key, cts, path_launches


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


def timed_once(fn):
    """(CUDA-event ms, result) of one call of fn()."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_multiplies(p) -> int:
    """32-bit integer multiplies of one CGGI step of one ciphertext, as the
    step (csrc/cggi_step.cuh) does them: a Shoup product is 3 (low, high,
    low); a 32 x 32 -> 64-bit product 2 (its low and high words); a REDC 2.
    2 inverse NTTs with the N^-1 scale and dG2 forward NTTs, one Shoup
    product a butterfly; per slot, the external product's 2 signs x 2
    columns each sum dG2 64-bit products and reduce once, the monomial
    multiply-add's 2 columns each sum two and reduce once, and the 2
    monomial indices are one multiply each."""
    butterflies = p.N // 2 * (p.N.bit_length() - 1)
    ntts = 2 * (3 * butterflies + 3 * p.N) + p.digits_g2 * 3 * butterflies
    external = 2 * 2 * (2 * p.digits_g2 + 2) * p.N
    monomial = 2 * (2 * 2 + 2) * p.N
    return ntts + external + monomial + 2 * p.N


def bound(nbytes: int, muls: int, int_peak: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and 32-bit multiplies over the integer multiply peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muls / int_peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ntt(dev, plan, x_f, x_i, errors: Errors, int_peak: float, card: str) -> dict:
    """Kernels 1 and 2 against their plain versions with a cold L2, at the
    main path's shapes (the batch's test vectors and extract_lwe's rows;
    the forward in both orders) and the single gate's; returns the
    main-path natural-order times for the kernels line."""
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.profile_ntt import FLUSH_WORDS, time_cold_ms
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)
    butterflies = plan.N // 2 * plan.logN
    twiddles = _nbytes(plan.fwd_w, plan.fwd_ws)
    fwd = lambda x: (lambda: ntt.ntt_forward(plan, x), lambda: ntt.forward_butterfly(plan, x))
    fwd_br = lambda x: (lambda: ntt.ntt_forward(plan, x, out_br=True),
                        lambda: ntt.forward_butterfly(plan, x, out_br=True))
    inv = lambda x: (lambda: ntt.ntt_inverse(plan, x), lambda: ntt.inverse_butterfly(plan, x))
    cases = [  # (kernel, order, input, (kernel call, plain call), multiplies a row, main)
        ("ntt_forward", "natural", x_f, fwd(x_f), 3 * butterflies, True),
        ("ntt_forward", "out_br", x_f, fwd_br(x_f), 3 * butterflies, False),
        ("ntt_inverse", "natural", x_i, inv(x_i), 3 * (butterflies + plan.N), True),
        ("ntt_forward", "natural", x_f[:1], fwd(x_f[:1]), 3 * butterflies, False),
        ("ntt_forward", "out_br", x_f[:1], fwd_br(x_f[:1]), 3 * butterflies, False),
        ("ntt_inverse", "natural", x_i[:2], inv(x_i[:2]), 3 * (butterflies + plan.N), False),
    ]
    result = {}
    for name, order, x, (kern, plain), muls, main in cases:
        shape = f"[{x.shape[0]}, {plan.N}] {order}"
        errors.compare(name, kern(), plain(), f"{name} {shape}")
        k_ms = time_cold_ms(kern, 21, flush)
        p_ms = time_cold_ms(plain, 5, flush)
        b_ms, b_by = bound(_nbytes(x, x) + twiddles, muls * x.shape[0], int_peak)
        print(f"[time] {name} {shape}, cold L2: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}, kernel at {b_ms / k_ms:.3f} of its bound  ({card})")
        if main:
            result[name] = (k_ms, p_ms, b_ms, b_by)
    return result


def timings(dev, ctx, key, cts, errors: Errors, card: str) -> dict:
    from fhe_tpu_torch.math import ntt
    from fhe_tpu_torch.tfhe import boot, boot_pallas
    ct1, ct2, _, one1, one2 = cts
    p = ctx.params
    for impl in IMPLS:
        c = dataclasses.replace(ctx, ntt_impl=impl)
        batch_ms = time_ms(lambda: c.eval_bin_gate(key, "AND", ct1, ct2), reps=3)
        single_ms = time_ms(lambda: c.eval_bin_gate(key, "AND", one1, one2), reps=5)
        print(f"[time] ntt_impl={impl} STD128 AND batch {BATCH}: {batch_ms:.3f} ms = "
              f"{BATCH / batch_ms * 1e3:.1f} gates/s  ({card})")
        print(f"[time] ntt_impl={impl} STD128 single-gate AND latency: {single_ms:.3f} ms  "
              f"({card})")

    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int_peak = sms * IMUL_PER_CLOCK_PER_SM * clock
    print(f"[bound] memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet); 32-bit integer "
          f"multiply peak {int_peak / 1e12:.3f} T/s = {sms} SMs x {IMUL_PER_CLOCK_PER_SM}/clock "
          f"x {clock / 1e9:.3f} GHz max SM clock (derived, not a data-sheet rate)")

    from fhe_tpu_torch.kernels import blind_rotate as kbr
    c = kbr.choose_c(BATCH, sms)
    for kind in kbr.KINDS:
        blocks = kbr.occupancy(p, c, kind)
        print(f"[occupancy] {kind} blind-rotation kernel, batch {BATCH}: {c} ciphertexts x "
              f"{p.N // 8} threads a block, {blocks} resident blocks per SM")
        if blocks < 2:
            fail(f"{kind} blind-rotation kernel: {blocks} resident block per SM at batch {BATCH}")

    rng = np.random.default_rng(SEED + 2)
    plan = ntt.make_plan(p.N, p.Q, dev)
    x_f = _residues(rng, p.Q, (BATCH, p.N), dev)            # the test vectors
    x_i = _residues(rng, p.Q, (2 * BATCH, p.N), dev)        # extract_lwe
    acc = _residues(rng, p.Q, (BATCH, 2, p.N), dev)
    a = _residues(rng, p.q, (BATCH, p.n), dev)
    bsk_br = key.bsk_br
    pows = boot._psi_powers_mont_words(p.N, p.Q, dev)
    twiddles = _nbytes(plan.fwd_w, plan.fwd_ws)
    rot_bytes = _nbytes(acc, acc, key.bsk, a, pows) + 2 * twiddles
    step_bytes = _nbytes(acc, acc, key.bsk[0], a[:, 0], pows) + 2 * twiddles
    step_muls = step_multiplies(p) * BATCH
    fused = lambda: boot_pallas.blind_rotate_fused(p, bsk_br, acc, a)
    # name -> (shape, kernel, plain, timed run of the kernel and its launches,
    #          reps of that run, plain reps, bytes, multiplies)
    cases = {
        "blind_rotate": (f"[{BATCH}, 2, {p.N}] x {p.n} steps, STD128 key",
                         lambda: boot.blind_rotate(p, key, acc, a),
                         lambda: boot.blind_rotate_plain(p, key.bsk, acc, a), None, 1, 3, 1,
                         rot_bytes, step_muls * p.n),
        "blind_rotate_mega": (f"[{BATCH}, 2, {p.N}] x {p.n} steps, STD128 key, bit-reversed",
                              lambda: boot_pallas.blind_rotate_mega(p, bsk_br, acc, a),
                              lambda: boot_pallas.blind_rotate_mega_plain(p, bsk_br, acc, a),
                              None, 1, 3, 1, rot_bytes, step_muls * p.n),
        # one step; the kernel's time per launch is taken over the n launches
        # of blind_rotate_fused, which also runs nothing else on the card
        "rotate_step_br": (f"[{BATCH}, 2, {p.N}] x 1 step, STD128 key, bit-reversed",
                           lambda: boot_pallas.rotate_step_br(p, bsk_br[0], acc, a[:, 0]),
                           lambda: boot_pallas.rotate_step_br_plain(p, bsk_br[0], acc, a[:, 0]),
                           fused, p.n, 3, 3, step_bytes, step_muls),
    }
    result, mega_plain = time_ntt(dev, plan, x_f, x_i, errors, int_peak, card), None
    for name, (shape, kern, plain, run, launches, k_reps, p_reps, nbytes, muls) in cases.items():
        got = kern()
        if p_reps == 1:
            p_ms, want = timed_once(plain)
        else:
            want = plain()
            p_ms = time_ms(plain, reps=p_reps)
        errors.compare(name, got, want, f"{name} {shape} (main-path shape)")
        if name == "blind_rotate_mega":
            mega_plain = want
        if run is None:
            k_ms = time_ms(kern, reps=k_reps)
        else:
            errors.compare(name, run(), mega_plain,
                           f"{name} x {launches} launches (blind_rotate_fused) [{BATCH}, 2, {p.N}]")
            run_ms = time_ms(run, reps=k_reps)
            k_ms = run_ms / launches
            print(f"[time] {name} x {launches} launches (blind_rotate_fused) [{BATCH}, 2, {p.N}]: "
                  f"{run_ms:.3f} ms; one call of the single-step wrapper {time_ms(kern, 5):.3f} ms "
                  f"(with its index computation and the host's issue time)  ({card})")
        b_ms, b_by = bound(nbytes, muls, int_peak)
        print(f"[time] {name} {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms by {b_by} ({nbytes} bytes, {muls} multiplies), kernel at "
              f"{b_ms / k_ms:.3f} of its bound  ({card})")
        result[name] = (k_ms, p_ms, b_ms, b_by)
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
    ctx, key, cts, launches = main_path(dev)
    times = timings(dev, ctx, key, cts, errors, card)
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errors.max[name],
             "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": times[name][2],
             "bound_by": times[name][3], "library_ms": None}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
