"""Hand-written CUDA kernels (sources in `fhe_tpu_torch/csrc/`).

Nothing is built or loaded at import: `_build.library()` compiles the
sources with nvcc at the first launch on a CUDA tensor.
"""

from . import blind_rotate, ntt


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last `reset_launch_counts`."""
    return {**ntt.LAUNCHES, **blind_rotate.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (ntt.LAUNCHES, blind_rotate.LAUNCHES):
        for name in counts:
            counts[name] = 0
