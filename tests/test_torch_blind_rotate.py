"""fhe_tpu_torch blind rotation against fhe_tpu, byte for byte.

The plain PyTorch `blind_rotate` is held against fhe_tpu's
boot.blind_rotate(..., "butterfly") on a random key (tests/test_ntt_lane.py
holds that reference equal to the TPU megakernel this port replaces).
The CUDA kernel looks the monomials up in `psi_powers_mont` where the
plain version squares; the lookup formula is checked here on the CPU and
the kernel itself against the plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.math import ntt as jntt
from fhe_tpu.tfhe import boot as jboot
from fhe_tpu.tfhe import make_params as j_make_params
from fhe_tpu.tfhe import rgsw as jrgsw
from fhe_tpu_torch.kernels import blind_rotate as kbr
from fhe_tpu_torch.math import ntt as tntt
from fhe_tpu_torch.tfhe import boot as tboot
from fhe_tpu_torch.tfhe import make_params as t_make_params
from fhe_tpu_torch.tfhe import rgsw as trgsw

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


def _i32(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(torch.int32)


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _random_rotation(params, rng, B, steps):
    Q = params.Q
    acc = rng.integers(0, Q, size=(B, 2, params.N)).astype(np.uint32)
    bsk = rng.integers(0, Q, size=(steps, 2, params.digits_g2, 2, params.N)).astype(np.uint32)
    a = rng.integers(0, params.q, size=(B, steps)).astype(np.uint32)
    return acc, bsk, a


def test_blind_rotate_matches_fhe_tpu(rng):
    jp, tp = j_make_params("TOY"), t_make_params("TOY")
    acc, bsk, a = _random_rotation(jp, rng, B=16, steps=6)
    plan = jntt.make_plan(jp.N, jp.Q)
    rotate = jax.jit(lambda k, c, m: jboot.blind_rotate(jp, k, c, m, "butterfly", None, plan))
    want = rotate(jnp.asarray(bsk), jnp.asarray(acc), jnp.asarray(a))
    got = tboot.blind_rotate(tp, trgsw.BootstrapKey(bsk=_i32(bsk), ksk=None), _i32(acc), _i32(a))
    assert got.dtype == torch.int32
    _eq(want, got)


def test_digits_and_external_product_match(rng):
    jp, tp = j_make_params("TOY"), t_make_params("TOY")
    c = rng.integers(0, jp.Q, size=(3, 2, jp.N)).astype(np.uint32)
    rows = rng.integers(0, jp.Q, size=(jp.digits_g2, 2, jp.N)).astype(np.uint32)
    jplan, tplan = jntt.make_plan(jp.N, jp.Q), tntt.make_plan(tp.N, tp.Q)

    @jax.jit
    def reference(c, rows):
        d = jrgsw.signed_digit_decompose(jp, c)
        d_eval = jrgsw.ntt_signed_digits(jplan, d, "butterfly")
        return d, d_eval, jrgsw.external_product(jplan, d_eval, rows)

    jd, d_eval, ep = reference(jnp.asarray(c), jnp.asarray(rows))
    td = trgsw.signed_digit_decompose(tp, _i32(c))
    _eq(jd, td)
    _eq(d_eval, trgsw.ntt_signed_digits(tplan, td))
    _eq(ep, trgsw.external_product(tplan, _i32(np.asarray(d_eval)), _i32(rows)))


@pytest.mark.parametrize("name", ["TOY", "STD128"])
def test_monomials_match_and_lookup_formula(name, rng):
    jp, tp = j_make_params(name), t_make_params(name)
    N, Q = jp.N, jp.Q
    idx = rng.integers(0, 2 * N, size=8).astype(np.uint32)
    mp, mn = tboot.monomial_pair_eval(tp, torch.from_numpy(idx.astype(np.int64)))
    jmp, jmn = jboot.monomial_pair_eval(jp, jnp.asarray(idx))
    _eq(jmp, mp)
    _eq(jmn, mn)
    # the kernel's lookup: slot e = (2k+1) idx mod 2N, and 2N - e for X^-idx
    pows = tboot.psi_powers_mont(N, Q)
    np.testing.assert_array_equal(pows, np.asarray(jboot.psi_powers_mont(N, Q)))
    k = np.arange(N)
    e = ((2 * k + 1)[None, :] * idx[:, None].astype(np.int64)) % (2 * N)
    r1 = (1 << 32) % Q
    np.testing.assert_array_equal((pows[e] - r1) % Q, mp.numpy())
    np.testing.assert_array_equal((pows[(2 * N - e) % (2 * N)] - r1) % Q, mn.numpy())


def test_kernel_wrapper_rejects_cpu_tensors(rng):
    tp = t_make_params("TOY")
    acc, bsk, a = _random_rotation(tp, rng, B=2, steps=1)
    with pytest.raises(ValueError):
        kbr.blind_rotate(tp, _i32(bsk), _i32(acc), _i32(a),
                         _i32(tboot.psi_powers_mont(tp.N, tp.Q)))
