"""The NTT wrappers' shape check on the CPU, without a kernel: the
instantiated N (csrc/ntt_shapes.h) against the parameter sets, and the
ValueError for an N outside them.
"""

import pytest

from fhe_tpu_torch.kernels import ntt as kntt
from fhe_tpu_torch.tfhe import make_params
from fhe_tpu_torch.tfhe.params import PARAM_SETS


def test_instantiated_sizes_are_the_parameter_sets():
    """One instantiation for every ring dimension of the parameter sets
    (TOY's 2^9 to TOY_RADIX's 2^13), plus 2^12, which no set uses but which
    the NTT served before its kernels were specialised, 2^14, CKKS bench
    config 3's ring (pke/ckks.py), 2^15, BFV bench config 4's (pke/bfv.py),
    and 2^16, the 128-bit bootstrapping set's (pke/bootstrap.py); no other."""
    want = {make_params(name).N for name in PARAM_SETS} | {4096, 1 << 14, 1 << 15, 1 << 16}
    assert set(kntt.sizes()) == want
    assert len(kntt.sizes()) == len(want)


@pytest.mark.parametrize("N", [1 << 17, 1 << 18, 256])
def test_check_n_rejects_unlisted_n(N):
    with pytest.raises(ValueError, match=rf"no NTT kernel for N = {N}; instantiated: "
                                         rf"\[512, 1024, 2048, 4096, 8192, 16384, 32768, 65536\] "
                                         rf"\(csrc/ntt_shapes.h\)"):
        kntt.check_n(N)
    for n in kntt.sizes():
        kntt.check_n(n)
