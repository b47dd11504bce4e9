"""The NTT kernels alone on one CUDA card, with a cold L2, and every
kernel's registers and spills.

    python3 -m fhe_tpu_torch.profile_ntt [--reps R]

Builds the package's kernels and prints each one's registers and spill
stores (`nvcc -Xptxas -v`) and, for the NTT kernels at N = 1024, their
SASS instructions by kind (`cuobjdump -sass`), then times the forward NTT (natural order and
`out_br`) and the inverse on the STD128 ring (N = 1024, its Q) at the main
path's shapes, [4096, 1024] and [8192, 1024], and at the single gate's,
[1, 1024] and [2, 1024]: the median of R calls (CUDA events), each after
writing a 256 MB buffer, so that the call reads its input from device
memory and not from the 50 MB L2, and spinning the card for about 0.5 ms,
so that the host has enqueued the call before the card reaches it.  Each
time stands beside its bytes bound (input, output and the twiddle table
once, at 3.35 TB/s).  It calls only the port's public NTT functions, so
the same file, copied into an older checkout of the port, times that
checkout's kernels.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from .kernels import _build
from .math import ntt
from .profile_gate import card_line
from .tfhe import make_params

HBM_BYTES_PER_S = 3.35e12       # NVIDIA H100 SXM data sheet
FLUSH_WORDS = (256 << 20) // 4
SPIN_CYCLES = 1_000_000         # about 0.5 ms of device time before each timed call


def registers(log: str) -> list[tuple[str, int, int]]:
    """(mangled kernel name, registers, spill-store bytes) from ptxas -v."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


# SASS opcodes by pipe: IMAD on the multiply-add pipe, these on the integer
# ALU pipe (both 16 lanes a clock per SM quarter on compute capability 9.0)
ALU_OPS = ("IADD3", "LOP3", "SHF", "LEA", "VIADDMNMX", "VIMNMX", "VIADD", "IMNMX", "ISETP",
           "SEL", "BREV", "PRMT")


def sass_counts(lib_path) -> dict[str, collections.Counter]:
    """SASS opcodes of each NTT kernel at N = 1024 in the library
    (cuobjdump, next to nvcc)."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "ntt" in name and "Li10E" in name:
            counts[name] = collections.Counter(
                m.group(1).split(".")[0] for m in
                re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body))
    return counts


def time_cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median CUDA-event time of fn() in ms over reps calls, each after
    writing `flush` (larger than the L2) and a device spin; the caller has
    warmed fn up."""
    times = []
    for _ in range(reps):
        flush.fill_(reps)
        torch.cuda._sleep(SPIN_CYCLES)     # the host enqueues fn before the card gets to it
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=51)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_ntt: no CUDA device")
    card = card_line()
    dev = torch.device("cuda", 0)
    lib = _build.library()
    print(f"[build] {lib.path.parent.name}: {len(_build.units())} units in {lib.seconds:.2f} s  "
          f"({card})")
    for name, regs, spill in registers(lib.log):
        print(f"[build] {name}: {regs} registers, {spill} bytes spill stores")
    for name, ops in sass_counts(lib.path).items():
        alu = sum(ops[op] for op in ALU_OPS)
        print(f"[sass] {name}: {sum(ops.values())} instructions a thread, IMAD {ops['IMAD']}, "
              f"integer ALU {alu}, LDG {ops['LDG']}, LDS {ops['LDS']}, STS {ops['STS']}, "
              f"STG {ops['STG']}, BAR {ops['BAR']}")

    p = make_params("STD128")
    plan = ntt.make_plan(p.N, p.Q, dev)
    rng = np.random.default_rng(20261017)
    x_f = torch.from_numpy(rng.integers(0, p.Q, size=(4096, p.N))).to(dev, torch.int32)
    x_i = torch.from_numpy(rng.integers(0, p.Q, size=(8192, p.N))).to(dev, torch.int32)
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)
    cases = [("forward natural", lambda x: ntt.ntt_forward(plan, x), x_f),
             ("forward out_br", lambda x: ntt.ntt_forward(plan, x, out_br=True), x_f),
             ("inverse", lambda x: ntt.ntt_inverse(plan, x), x_i),
             ("forward natural", lambda x: ntt.ntt_forward(plan, x), x_f[:1]),
             ("forward out_br", lambda x: ntt.ntt_forward(plan, x, out_br=True), x_f[:1]),
             ("inverse", lambda x: ntt.ntt_inverse(plan, x), x_i[:2])]
    for what, fn, x in cases:
        fn(x)
        ms = time_cold_ms(lambda: fn(x), args.reps, flush)
        nbytes = 2 * x.numel() * 4 + 2 * plan.fwd_w.numel() * 4     # rows in and out, tables
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[ntt] {what} [{x.shape[0]}, {p.N}], cold L2: {ms:.4f} ms (median of "
              f"{args.reps}), bytes bound {bound_ms:.4f} ms, at {bound_ms / ms:.3f} of it  "
              f"({card})")


if __name__ == "__main__":
    main()
