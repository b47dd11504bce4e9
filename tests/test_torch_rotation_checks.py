"""The blind-rotation wrappers' checks on the CPU, without a kernel: the
instantiated shapes against the parameter sets, the shape, Q and LWE
modulus validation, the choice of ciphertexts per block, the bit-reversed
key made once per BootstrapKey, and the mask's modulus through every
accumulator.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_tpu_torch.kernels import blind_rotate as kbr
from fhe_tpu_torch.tfhe import acc, boot, make_params, rgsw
from fhe_tpu_torch.tfhe.params import PARAM_SETS

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


def _single_word_sets():
    return [make_params(name) for name in PARAM_SETS if not make_params(name).moduli_rns]


def test_instantiated_shapes_are_the_parameter_sets():
    """Every (N, dG2) of the single-word sets has its kernels: N <= 2048 on
    the step of csrc/cggi_step.cuh, TOY_RADIX's (8192, 10) on the wide
    step (N >= wide_n())."""
    want = {(p.N, p.digits_g2) for p in _single_word_sets()}
    assert set(kbr.shapes()) == want
    assert len(kbr.shapes()) == len(want)
    assert (8192, 10) in want
    assert {N for N, _ in kbr.shapes() if N >= kbr.wide_n()} == {8192}


@pytest.mark.parametrize("name", ["TOY", "STD128", "STD128_3", "STD256", "STD256Q",
                                  "STD256Q_3", "TOY_RADIX"])
def test_check_params_accepts_every_instantiation(name):
    kbr.check_params(make_params(name))


def test_check_params_rejects_unsupported_shape():
    """A shape no instantiation has: TOY_RADIX at N = 16384, and STD128
    with dG2 = 2."""
    with pytest.raises(ValueError, match=r"\(N, dG2\) = \(16384, 10\)"):
        kbr.check_params(dataclasses.replace(make_params("TOY_RADIX"), N=16384))
    p = make_params("STD128")
    with pytest.raises(ValueError, match=r"\(N, dG2\) = \(1024, 2\)"):
        kbr.check_params(dataclasses.replace(p, digits_g=2))


def test_check_params_rejects_modulus_from_2_to_30():
    p = make_params("STD256_LMKCDEY")
    assert p.Q < 1 << 30
    kbr.check_params(p)
    with pytest.raises(ValueError, match="2\\^30"):
        kbr.check_params(dataclasses.replace(p, Q=(1 << 30) + 1))


@pytest.mark.parametrize("q_lwe", [2, 4, 512, 1024, 2048])
def test_check_q_lwe_accepts_powers_of_two_dividing_2n(q_lwe):
    kbr.check_q_lwe(make_params("STD128"), q_lwe)


@pytest.mark.parametrize("q_lwe", [0, 1, 3, 768, 1536, 4096])
def test_check_q_lwe_refuses_the_rest(q_lwe):
    """Not a power of two, below 2, or not dividing 2N = 2048."""
    with pytest.raises(ValueError, match=f"LWE modulus {q_lwe} must be a power of two >= 2 "
                                         f"dividing 2N = 2048"):
        kbr.check_q_lwe(make_params("STD128"), q_lwe)


def test_mask_modulus_reaches_every_accumulator():
    """idx = ((q - a) mod q) 2N/q, so the mask a mod q rotates as 2a mod 2q
    does: every ntt_impl gives the same accumulator both ways (TOY widths,
    a random key of 4 steps, batch 3).  A mask mod another modulus than q
    needs a GINX key."""
    p = make_params("TOY")
    gen = np.random.default_rng(8)
    bsk = torch.from_numpy(gen.integers(0, p.Q, size=(4, 2, p.digits_g2, 2, p.N)))
    key = rgsw.BootstrapKey(bsk=bsk.to(torch.int32), ksk=None)
    tv = torch.from_numpy(gen.integers(0, p.Q, size=(3, p.N))).to(torch.int32)
    a = torch.from_numpy(gen.integers(0, p.q, size=(3, 4))).to(torch.int32)
    want = boot.run_accumulator(p, key, tv, a)
    for impl in (None, "mega", "fused"):
        got = boot.run_accumulator(p, key, tv, 2 * a, impl, a_modulus=2 * p.q)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a GINX BootstrapKey, got DmKey"):
        boot.run_accumulator(p, acc.DmKey(bsk=None, ksk=None), tv, a, a_modulus=2 * p.q)


@pytest.mark.parametrize("batch,sms,c", [(1, 132, 1), (8, 132, 1), (527, 132, 1),
                                         (528, 132, 2), (4096, 132, 2), (4097, 132, 2),
                                         (4096, 2048, 1)])
def test_choose_c(batch, sms, c):
    assert kbr.choose_c(batch, sms) == c


@pytest.mark.parametrize("batch", [1, 527, 528, 4097])
def test_choose_c_is_one_on_the_wide_step(batch):
    """The wide step (N >= wide_n(), TOY_RADIX's 8192) takes one ciphertext
    a block at every batch; the narrower rings keep their choice."""
    assert kbr.choose_c(batch, 132, 8192) == 1
    assert kbr.choose_c(batch, 132, 1024) == kbr.choose_c(batch, 132)


def test_wrappers_reject_cpu_tensors_before_checking_shape():
    p = make_params("TOY_RADIX")
    acc = torch.zeros(1, 2, p.N, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kbr.blind_rotate(p, torch.zeros(1, 2, p.digits_g2, 2, p.N, dtype=torch.int32), acc,
                         torch.zeros(1, 1, dtype=torch.int32),
                         torch.zeros(2 * p.N, dtype=torch.int32))


def test_bit_reversed_key_made_once_per_key(monkeypatch):
    """Two "mega" rotations and one "fused" on one key build the
    bit-reversed key once, and give the bytes of the default accumulator,
    which does not read it on the CPU.  TOY widths, a random key of 8
    steps, batch 2."""
    built = []
    make = rgsw.bsk_to_br
    monkeypatch.setattr(rgsw, "bsk_to_br", lambda bsk: built.append(1) or make(bsk))
    p = make_params("TOY")
    gen = np.random.default_rng(7)
    bsk = torch.from_numpy(gen.integers(0, p.Q, size=(8, 2, p.digits_g2, 2, p.N)))
    key = rgsw.BootstrapKey(bsk=bsk.to(torch.int32), ksk=None)
    tv = torch.from_numpy(gen.integers(0, p.Q, size=(2, p.N))).to(torch.int32)
    a = torch.from_numpy(gen.integers(0, p.q, size=(2, 8))).to(torch.int32)
    want = boot.run_accumulator(p, key, tv, a, None)
    assert not built
    for impl in ("mega", "mega", "fused"):
        torch.testing.assert_close(boot.run_accumulator(p, key, tv, a, impl), want, rtol=0,
                                   atol=0)
    assert len(built) == 1
    assert key.bsk_br is key.bsk_br
