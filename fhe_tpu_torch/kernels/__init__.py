"""Hand-written CUDA kernels (sources in `fhe_tpu_torch/csrc/`).

Nothing is built or loaded at import: `_build.library()` compiles the
sources with nvcc at the first launch on a CUDA tensor.
"""

from . import blind_rotate, blind_rotate_br, ntt

_COUNTERS = (ntt.LAUNCHES, blind_rotate.LAUNCHES, blind_rotate_br.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last `reset_launch_counts`."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
