"""The 2-limb limb-stacked NTT kernels of two checkouts on one card, in
turns (parent, change, change, parent).

    python3 tools/compare_limb_ntt.py --parent DIR

DIR holds an unpacked `git archive` of the older commit (in a directory
that .gitignore lists).  Each turn is a process started in that checkout's
root (this file runs from its own path, so the older checkout needs no
copy of it), which builds its own kernels and times `lattice.rns.ntt_forward` /
`ntt_inverse` on STD192's ring (N = 2048, two limbs) at the [rns] phase's
shapes, [8192, 2, 2048], [4096, 2, 2048] and the single gate's [2, 2,
2048]: the median of 11 CUDA-event windows of 20 calls each.  Without
--parent it times the checkout it is started in, once.
"""
import argparse
import os
import statistics
import subprocess
import sys


def time_here() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from fhe_tpu_torch.lattice import rns

    dev = torch.device("cuda", 0)
    plan = rns.make_rns_plan(2048, (520193, 495617), dev)
    gen = np.random.default_rng(5)
    for rows in (8192, 4096, 2):
        x = torch.stack([torch.from_numpy(gen.integers(0, q, size=(rows, 2048))).to(
            dev, torch.int32) for q in plan.moduli], dim=1)
        for name, fn in (("forward", rns.ntt_forward), ("inverse", rns.ntt_inverse)):
            fn(plan, x)
            torch.cuda.synchronize()
            ts = []
            for _ in range(11):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    fn(plan, x)
                b.record()
                torch.cuda.synchronize()
                ts.append(a.elapsed_time(b) / 20)
            print(f"{name} [{rows}, 2, 2048]: {statistics.median(ts):.4f} ms (median of 11 x 20)",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the older checkout")
    args = ap.parse_args()
    if args.parent is None:
        time_here()
        return
    here = os.getcwd()
    for root in (args.parent, here, here, args.parent):
        print(f"== {root}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=root, check=False)


if __name__ == "__main__":
    main()
