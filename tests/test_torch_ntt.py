"""fhe_tpu_torch math core against fhe_tpu: modular arithmetic and the
negacyclic NTT, byte for byte (every value is an integer residue, so the
tolerance is exact).

The fhe_tpu side runs on the CPU: the XLA butterflies, the Pallas NTT kernel
in interpret mode (as tests/test_ntt_pallas.py runs it) and the C++
reference's known-answer vectors (as tests/test_reference_kat.py does).
The CUDA kernel itself is held against the plain version on the card only.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.math import modmath as jmm
from fhe_tpu.math import ntt as jntt
from fhe_tpu.math import ntt_pallas
from fhe_tpu_torch.math import modmath as tmm
from fhe_tpu_torch.math import ntt as tntt
from fhe_tpu_torch.math import primes

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

VEC = os.path.join(os.path.dirname(__file__), "vectors")
SIZES = [(512, 27), (1024, 27), (1024, 28)]
# jitted once per shape: eager XLA compiles every butterfly stage separately
j_forward = jax.jit(jntt.forward_butterfly)
j_inverse = jax.jit(jntt.inverse_butterfly)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64).astype(np.uint32)


def _plans(N, q_bits):
    q = primes.last_prime(q_bits, 2 * N)
    return q, jntt.make_plan(N, q), tntt.make_plan(N, q)


@pytest.mark.parametrize("N,q_bits", SIZES)
def test_plan_tables_match(N, q_bits):
    q, jp, tp = _plans(N, q_bits)
    assert (tp.psi, tp.qinv_neg, tp.r2) == (jp.psi, jp.qinv_neg, jp.r2)
    assert (tp.ninv, tp.ninv_s) == (int(jp.ninv), int(jp.ninv_s))
    for f in ("fwd_w", "fwd_ws", "inv_w", "inv_ws"):
        got = getattr(tp, f).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_array_equal(tp.br.numpy(), np.asarray(jp.br))


@pytest.mark.parametrize("N,q_bits", SIZES)
def test_butterflies_match_fhe_tpu(N, q_bits, rng):
    q, jp, tp = _plans(N, q_bits)
    x = rng.integers(0, q, size=(2, 3, N)).astype(np.uint32)
    want_f = np.asarray(j_forward(jp, jnp.asarray(x)))
    got_f = tntt.ntt_forward(tp, _t(x))
    assert got_f.dtype == torch.int32 and got_f.shape == (2, 3, N)
    np.testing.assert_array_equal(_u32(got_f), want_f)
    want_i = np.asarray(j_inverse(jp, jnp.asarray(want_f)))
    got_i = tntt.ntt_inverse(tp, got_f)
    np.testing.assert_array_equal(_u32(got_i), want_i)
    np.testing.assert_array_equal(_u32(got_i), x)


@pytest.mark.parametrize("N", [512, 1024])
def test_matches_pallas_kernel_interpret(N, rng):
    """The TPU kernels this port replaces, run in interpret mode."""
    q, jp, tp = _plans(N, 27)
    x = rng.integers(0, q, size=(6, N)).astype(np.uint32)
    want_f = np.asarray(ntt_pallas.forward_pallas(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(_u32(tntt.ntt_forward(tp, _t(x))), want_f)
    want_i = np.asarray(ntt_pallas.inverse_pallas(jp, jnp.asarray(want_f)))
    np.testing.assert_array_equal(_u32(tntt.ntt_inverse(tp, _t(want_f))), want_i)


def _kat(tag="n1024_q27"):
    with open(os.path.join(VEC, "manifest.json")) as f:
        m = json.load(f)[f"ntt_{tag}"]
    load = lambda s: np.load(os.path.join(VEC, f"ntt_{tag}_{s}.npy"))
    return m, load


def test_negacyclic_product_cpp_vectors():
    m, load = _kat()
    plan = tntt.make_plan(m["N"], m["q"])
    got = tntt.negacyclic_mul(plan, _t(load("in")), _t(load("in2")))
    np.testing.assert_array_equal(_u32(got), load("prod"))


def test_forward_same_evaluation_set_cpp_vectors():
    """The reference's bit-reversed forward output is our natural-order
    output under the relabeling of the two root conventions."""
    m, load = _kat()
    N, q, psi_ref = m["N"], m["q"], m["psi"]
    plan = tntt.make_plan(N, q)
    ours = _u32(tntt.ntt_forward(plan, _t(load("in"))))
    t = next(e for e in range(2 * N) if pow(plan.psi, e, q) == psi_ref)
    br = tntt.bit_reverse_perm(N).astype(np.int64)
    k = ((t * (2 * br + 1)) % (2 * N) - 1) // 2
    np.testing.assert_array_equal(load("fwd"), ours[:, k])


@pytest.mark.parametrize("num,den", [(1 << 14, 134215681), (1024, 1 << 14),
                                     (512, 134215681)])
def test_round_scale_mod_matches_fhe_tpu(num, den, rng):
    """The gate path's switches, within fhe_tpu's exactness range
    (quotient below 2^25)."""
    v = rng.integers(0, den, size=4096).astype(np.uint32)
    want = np.asarray(jmm.round_scale_mod(jnp.asarray(v), num, den, num))
    got = tmm.round_scale_mod(torch.from_numpy(v.astype(np.int64)), num, den, num)
    np.testing.assert_array_equal(got.numpy(), want)


def test_round_scale_mod_identity_is_exact(rng):
    """Q -> Q (TOY's first switch in switch_ct_to_qn, q_ks == Q) is the
    identity; fhe_tpu's float-estimate divmod is off by a few units here
    (quotient above its 2^25 bound, ROADMAP.md queue 3)."""
    Q = 134215681
    v = torch.from_numpy(rng.integers(0, Q, size=4096))
    np.testing.assert_array_equal(tmm.round_scale_mod(v, Q, Q, Q).numpy(), v.numpy())


def test_mont_and_shoup_match_fhe_tpu(rng):
    q = 134215681
    qinv_neg, r1, r2 = jmm.mont_constants(q)
    assert tmm.mont_constants(q) == (int(qinv_neg), int(r1), int(r2))
    a = rng.integers(0, q, size=4096).astype(np.uint32)
    b = rng.integers(0, q, size=4096).astype(np.uint32)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    want = np.asarray(jmm.mont_mul(jnp.asarray(a), jnp.asarray(b), q, jnp.uint32(qinv_neg)))
    np.testing.assert_array_equal(tmm.mont_mul(ta, tb, q).numpy(), want)
    np.testing.assert_array_equal(
        tmm.to_mont(ta, q).numpy(),
        np.asarray(jmm.to_mont(jnp.asarray(a), q, jnp.uint32(qinv_neg), r2)))
    w = int(b[0])
    ws = jmm.shoup_precompute(w, q)
    assert tmm.shoup_precompute(w, q) == ws
    want = np.asarray(jmm.shoup_mul(jnp.asarray(a), jnp.uint32(w), jnp.uint32(ws), q))
    np.testing.assert_array_equal(tmm.shoup_mul(ta, w, q).numpy(), want)


def test_ntt_rejects_unsupported_device():
    plan = tntt.make_plan(512, 134215681)
    x = torch.empty(2, 512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tntt.ntt_forward(plan, x)
