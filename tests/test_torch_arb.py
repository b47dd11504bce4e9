"""fhe_tpu_torch's Bluestein / arbitrary-cyclotomic transforms
(math/ntt_arb.py) against fhe_tpu on the CPU, byte for byte, at fhe_tpu's
test lengths m = 7, 12, 15, 24 (padded convolutions of L = 32 to 128:
the small-N kernels' sizes on the card); and the C++ reference's BFV
ciphertext (tests/vectors/) decrypted through the port's exact
convolution, a second oracle (as tests/test_reference_kat.py does with
fhe_tpu's).

fhe_tpu's `_exact_linconv` runs its eager NTT, which XLA compiles op by
op (~10 s a length): here through the same `negacyclic_mul`, jitted once
per plan.
"""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.math import ntt as j_ntt
from fhe_tpu.math import ntt_arb as j_arb
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import ntt_arb, primes

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

VEC = os.path.join(os.path.dirname(__file__), "vectors")
MS = [7, 12, 15, 24]


@functools.lru_cache(maxsize=None)
def _jit_mul(N: int, q: int):
    plan = j_ntt.make_plan(N, q)
    return jax.jit(lambda a, b: j_ntt.negacyclic_mul(plan, a, b))


@pytest.fixture(autouse=True)
def jit_arb(monkeypatch):
    """fhe_tpu's ntt_arb with its products jitted (the same function)."""
    shim = types.SimpleNamespace(make_plan=lambda N, q: (N, q),
                                 negacyclic_mul=lambda plan, a, b: _jit_mul(*plan)(a, b))
    monkeypatch.setattr(j_arb, "nttmod", shim)


def _q_for(m: int) -> int:
    return primes.first_prime(28, 2 * m)


def _same(got, want) -> None:
    assert got.dtype == np.asarray(want).dtype
    assert [int(x) for x in got] == [int(x) for x in want]


def test_cyclotomic_polys_and_totients():
    for m in MS + [1, 8, 1733]:
        assert ntt_arb.cyclotomic_poly(m) == j_arb.cyclotomic_poly(m)
        np.testing.assert_array_equal(ntt_arb.totient_indices(m), j_arb.totient_indices(m))
    assert ntt_arb.cyclotomic_poly(12) == (1, 0, -1, 0, 1)


@pytest.mark.parametrize("la,lb,bits", [(7, 13, 28), (24, 47, 32), (300, 300, 26)])
def test_exact_linconv_matches_fhe_tpu(la, lb, bits):
    """L = 32, 128 (the small-N kernels) and 1024 (limb-stacked on the
    card); entries up to 2^32, fhe_tpu's stated range."""
    rng = np.random.default_rng(la)
    a = rng.integers(0, 1 << bits, size=la, dtype=np.int64).astype(np.uint64)
    b = rng.integers(0, 1 << bits, size=lb, dtype=np.int64).astype(np.uint64)
    got = ntt_arb._exact_linconv(a, b, device="cpu")
    _same(got, j_arb._exact_linconv(a, b))
    assert [int(x) for x in got] == [int(x) for x in np.convolve(a.astype(object),
                                                                 b.astype(object))]


@pytest.mark.parametrize("m", MS)
def test_bluestein_matches_fhe_tpu_and_naive(m):
    q = _q_for(m)
    rng = np.random.default_rng(m)
    x = rng.integers(0, q, size=m)
    got = ntt_arb.bluestein_dft(x, m, q, device="cpu")
    _same(got, j_arb.bluestein_dft(x, m, q))
    w = pow(ntt_arb.bluestein_plan(m, q).psi, 2, q)
    assert [int(v) for v in got] == [sum(int(x[k]) * pow(w, j * k, q) for k in range(m)) % q
                                     for j in range(m)]
    back = ntt_arb.bluestein_dft(got, m, q, inverse=True, device="cpu")
    _same(back, j_arb.bluestein_dft(got, m, q, inverse=True))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("m", MS)
def test_arb_transforms_and_product_match_fhe_tpu(m):
    """forward_arb / inverse_arb round trip and multiply_arb, byte-equal
    to fhe_tpu, the product also against a schoolbook product mod
    (Phi_m, q)."""
    q = _q_for(m)
    phi = len(ntt_arb.cyclotomic_poly(m)) - 1
    rng = np.random.default_rng(m + 7)
    a = rng.integers(0, q, size=phi)
    b = rng.integers(0, q, size=phi)
    vals = ntt_arb.forward_arb(a, m, q, device="cpu")
    _same(vals, j_arb.forward_arb(a, m, q))
    back = ntt_arb.inverse_arb(vals, m, q, device="cpu")
    _same(back, j_arb.inverse_arb(vals, m, q))
    np.testing.assert_array_equal(back, a)
    prod = ntt_arb.multiply_arb(a, b, m, q, device="cpu")
    _same(prod, j_arb.multiply_arb(a, b, m, q))
    full = np.convolve(a.astype(object), b.astype(object))
    _same(prod, ntt_arb._poly_mod_cyclo(full, m, q))
    _same(ntt_arb._poly_mod_cyclo(full, m, q), j_arb._poly_mod_cyclo(full, m, q))


def test_bluestein_refuses_a_modulus_without_the_root():
    with pytest.raises(ValueError, match="primitive 2m-th root"):
        ntt_arb.bluestein_plan(7, 65537)


def test_small_and_limb_paths_agree():
    """rns.negacyclic_product's two paths (one NTT a prime below N = 512,
    limb-stacked from it) give the same integers: a product at N = 256
    padded into N = 512 is the same convolution."""
    rng = np.random.default_rng(11)
    mods = tuple(primes.generate_ntt_primes(31, 1024, 3))
    a = np.zeros(512, dtype=object)
    b = np.zeros(512, dtype=object)
    a[:128] = [int(v) for v in rng.integers(0, 1 << 30, size=128)]
    b[:128] = [int(v) for v in rng.integers(0, 1 << 30, size=128)]
    small = rns.negacyclic_product(a[:256], b[:256], mods, "cpu")
    limb = rns.negacyclic_product(a, b, mods, "cpu")
    assert [int(x) for x in small] == [int(x) for x in limb[:256]]
    assert not any(limb[256:])


def _load(name):
    return np.load(os.path.join(VEC, name + ".npy"), allow_pickle=False)


def _negacyclic_exact(a, b, q: int) -> np.ndarray:
    """Exact negacyclic product mod q of words up to ~2^52 through the
    port's _exact_linconv, as tests/test_reference_kat.py composes
    fhe_tpu's: 26-bit halves, four exact convolutions."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    S = 1 << 26
    a0, a1 = a % S, a // S
    b0, b1 = b % S, b // S
    full = (ntt_arb._exact_linconv(a0, b0, "cpu")
            + (ntt_arb._exact_linconv(a0, b1, "cpu") + ntt_arb._exact_linconv(a1, b0, "cpu")) * S
            + ntt_arb._exact_linconv(a1, b1, "cpu") * (S * S))
    N = len(a)
    red = full[:N].copy()
    red[:len(full) - N] -= full[N:]
    return np.array([int(v) % q for v in red], dtype=object)


def test_reference_bfv_ciphertext_decrypts_through_the_port():
    """The C++ reference's BFV ciphertext (N = 4096, 3 limbs) decrypted with
    the port's exact convolution, CRT and HPS rounding: its message."""
    if not os.path.exists(os.path.join(VEC, "manifest_pke.json")):
        pytest.skip("PKE reference vectors not generated (tools/ref_pke_kat_dump.cpp)")
    with open(os.path.join(VEC, "manifest_pke.json")) as f:
        t = json.load(f)["bfv"]["t"]
    mods = [int(q) for q in _load("bfv_moduli")]
    sk, c0, c1 = _load("bfv_sk"), _load("bfv_ct_c0"), _load("bfv_ct_c1")
    L = c0.shape[0]
    limbs = [(_negacyclic_exact(c1[l], sk[l], mods[l]) + c0[l].astype(object)) % mods[l]
             for l in range(L)]
    Q = rns.modulus_product(mods[:L])       # 60-bit limbs: the CRT in Python ints
    coefs = sum(limbs[l] * (Q // mods[l]) * pow(Q // mods[l] % mods[l], -1, mods[l])
                for l in range(L)) % Q
    got = np.array([((int(x) * t + Q // 2) // Q) % t for x in coefs], dtype=np.uint64)
    np.testing.assert_array_equal(got, _load("bfv_msg"))
