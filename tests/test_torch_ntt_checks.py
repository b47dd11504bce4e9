"""The NTT wrappers' shape check on the CPU, without a kernel: the
instantiated N (csrc/ntt_shapes.h, 2^3 to 2^16) against the parameter
sets, and the ValueError for an N outside them (4, 2^17).
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
    and 2^16, the 128-bit bootstrapping set's (pke/bootstrap.py); and the
    small-N kernels from 2^3, the least N fhe_tpu's make_plan takes, to
    2^8 (the trapdoor's and the Bluestein transforms' rings); no other.
    The limb-stacked kernels take the N from 2^9 only."""
    want = {make_params(name).N for name in PARAM_SETS} | {4096, 1 << 14, 1 << 15, 1 << 16}
    assert set(kntt.limb_sizes()) == want
    assert kntt.small_sizes() == (8, 16, 32, 64, 128, 256)
    assert kntt.sizes() == tuple(1 << k for k in range(3, 17))
    assert len(kntt.sizes()) == len(want) + len(kntt.small_sizes())


@pytest.mark.parametrize("N", [1 << 17, 1 << 18, 4])
def test_check_n_rejects_unlisted_n(N):
    with pytest.raises(ValueError, match=rf"no NTT kernel for N = {N}; instantiated: "
                                         rf"\[8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, "
                                         rf"8192, 16384, 32768, 65536\] \(csrc/ntt_shapes.h\)"):
        kntt.check_n(N)
    for n in kntt.sizes():
        kntt.check_n(n)


def test_limb_stacked_kernels_refuse_small_n():
    """The small-N kernels are single-modulus: a limb-stacked plan below
    2^9 is refused before a launch, on the CPU too."""
    from fhe_tpu_torch.lattice import rns
    from fhe_tpu_torch.math import primes
    with pytest.raises(ValueError, match="limb-stacked NTT kernels take N in"):
        kntt.check_limbs(rns.make_rns_plan(256, primes.ntt_primes(2, 256, 1 << 30)))
    kntt.check_limbs(rns.make_rns_plan(512, primes.ntt_primes(2, 512, 1 << 30)))
