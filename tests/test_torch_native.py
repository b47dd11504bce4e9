"""fhe_tpu_torch/native: the CRT codec (crt_codec.cpp) against the port's
exact CRT (lattice/rns.py `to_bigint` / `from_bigint`), and the C client
(client.cpp) against the port's LWE code, on the CPU.

The libraries are the port's own copies of fhe_tpu's C++ sources, built
with g++ into fhe_tpu_torch/_build/native/; the tests skip only where g++
is missing.  A failed build raises with the compiler's output.
"""

import hashlib
import shutil

import numpy as np
import pytest
import torch

import fhe_tpu_torch.native as native
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import primes
from fhe_tpu_torch.native import client
from fhe_tpu_torch.tfhe import BinFheContext, lwe

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 64
MODS = tuple(primes.generate_ntt_primes(28, 2 * N, 4))


@pytest.fixture(scope="module", autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.fixture(scope="module")
def toy():
    return BinFheContext.generate("TOY", device=CPU)


def _poly(rng) -> tuple[rns.RnsPoly, list, int]:
    """Random squares mod Q as an RnsPoly on the CPU, their ints and Q."""
    Q = rns.modulus_product(MODS)
    vals = [int(v) ** 2 % Q for v in rng.integers(0, 1 << 63, size=N, dtype=np.uint64)]
    return rns.from_bigint(vals, MODS, N, device=CPU), vals, Q


def test_crt_center_mod(rng):
    p, vals, Q = _poly(rng)
    assert list(rns.to_bigint(p)) == vals
    t = 65537
    want = [((v - Q) % t if v > Q // 2 else v % t) for v in vals]
    np.testing.assert_array_equal(native.crt_center_mod(p.data, MODS, t), want)


def test_crt_center_double(rng):
    p, vals, Q = _poly(rng)
    want = np.array([float(v - Q) if v > Q // 2 else float(v) for v in vals])
    np.testing.assert_allclose(native.crt_center_double(p.data, MODS), want, rtol=1e-15)


def test_crt_scale_round_mod(rng):
    p, vals, Q = _poly(rng)
    t = 65537
    want = [((2 * t * v + Q) // (2 * Q)) % t for v in vals]
    np.testing.assert_array_equal(native.crt_scale_round_mod(p.data, MODS, t), want)


def test_signed_to_residues(rng):
    coeffs = rng.integers(-(1 << 40), 1 << 40, size=N)
    got = native.signed_to_residues(coeffs, MODS)
    want = rns.from_bigint([int(c) for c in coeffs], MODS, N, device=CPU).data.numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    with pytest.raises(ValueError, match="do not match"):
        native.crt_center_mod(got, MODS[:2], 17)


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build .*broken.cpp"):
        native.build(str(bad))
    assert not list(native.BUILD_DIR.glob("libbroken-*"))


def test_blake2b_rfc_vectors():
    assert client.blake2b(b"abc", 64).hex() == hashlib.blake2b(b"abc", digest_size=64).hexdigest()
    assert client.blake2b(b"", 32).hex() == hashlib.blake2b(b"", digest_size=32).hexdigest()
    data = bytes(range(256)) * 3
    assert client.blake2b(data, 64).hex() == hashlib.blake2b(data, digest_size=64).hexdigest()


def test_prng_deterministic_and_uniform():
    seed = bytes(range(32))
    a = client.prng_uniform(seed, 0, 1 << 30, 4096)
    np.testing.assert_array_equal(a, client.prng_uniform(seed, 0, 1 << 30, 4096))
    assert not np.array_equal(a, client.prng_uniform(seed, 1, 1 << 30, 4096))
    assert a.max() < (1 << 30) and abs(a.mean() / (1 << 29) - 1.0) < 0.05
    g = client.prng_gaussian(seed, 0, 3.19, 8192)
    assert abs(g.std() - 3.19) < 0.2 and abs(g.mean()) < 0.2
    with pytest.raises(ValueError, match="32 bytes"):
        client.lwe_keygen(b"short", 8)


def test_c_encrypt_port_decrypt(rng, toy):
    q, n, p = toy.params.q, toy.params.n, 4
    seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    sk_np = client.lwe_keygen(seed, n)
    assert set(np.unique(sk_np)) <= {-1, 0, 1}
    m = rng.integers(0, p, size=32).astype(np.int32)
    ct = client.as_ciphertext(*client.lwe_encrypt(sk_np, q, p, m, seed), q, p, device=CPU)
    sk = lwe.LweSecretKey(s=torch.from_numpy(sk_np))
    np.testing.assert_array_equal(lwe.decrypt(toy.params, sk, ct, p).numpy(), m)


def test_port_encrypt_c_decrypt(rng, toy):
    sk = toy.key_gen(rng)
    m = rng.integers(0, 4, size=32)
    ct = toy.encrypt(sk, m, rng, p=4)
    a, b = client.ciphertext_words(ct)
    np.testing.assert_array_equal(client.lwe_decrypt(sk.s.numpy(), toy.params.q, 4, a, b), m)


def test_c_client_to_port_gate(rng, toy):
    """The native client encrypts, the port evaluates a bootstrapped AND
    on its own key for the client's secret, the native client decrypts
    (fhe_tpu's test_c_client_to_tpu_gate on the port)."""
    q, n = toy.params.q, toy.params.n
    seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    sk_np = client.lwe_keygen(seed, n)
    key = toy.bt_key_gen(lwe.LweSecretKey(s=torch.from_numpy(sk_np)), rng)
    m1 = np.array([0, 0, 1, 1], dtype=np.int32)
    m2 = np.array([0, 1, 0, 1], dtype=np.int32)
    ct1 = client.as_ciphertext(*client.lwe_encrypt(sk_np, q, 4, m1, seed), q, device=CPU)
    ct2 = client.as_ciphertext(*client.lwe_encrypt(sk_np, q, 4, m2, bytes(32)), q, device=CPU)
    out = toy.eval_bin_gate(key, "AND", ct1, ct2)
    np.testing.assert_array_equal(client.lwe_decrypt(sk_np, q, 4, *client.ciphertext_words(out)),
                                  m1 & m2)
