"""fhe_tpu_torch's trapdoor layer (math/samplers.py, math/dft.py,
lattice/field2n.py, math/matrix.py, lattice/trapdoor.py) against fhe_tpu
on the CPU, byte for byte (every output is an integer, a hash or the same
numpy float64 path: no tolerance).

fhe_tpu's trapdoor multiplies one row at a time through its eager NTT,
which XLA compiles op by op (~10 s a sampler call): its `_ring_mul` runs
here through the same `negacyclic_mul`, jitted once per plan.
"""

import functools
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import field2n as j_field2n
from fhe_tpu.lattice import trapdoor as j_td
from fhe_tpu.math import dft as j_dft
from fhe_tpu.math import matrix as j_matrix
from fhe_tpu.math import ntt as j_ntt
from fhe_tpu.math import samplers as j_samplers
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import field2n, trapdoor
from fhe_tpu_torch.math import dft, matrix, primes, samplers

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _jit_mul(N: int, q: int):
    plan = j_ntt.make_plan(N, q)
    return jax.jit(lambda a, b: j_ntt.negacyclic_mul(plan, a, b, impl="butterfly"))


def _j_ring_mul(params, a, b):
    """fhe_tpu's trapdoor._ring_mul, its NTT product jitted."""
    prod = _jit_mul(params.N, params.q)(
        jnp.asarray(np.atleast_2d(a % params.q).astype(np.uint32)),
        jnp.asarray(np.atleast_2d(b % params.q).astype(np.uint32)))
    return np.asarray(prod).astype(np.int64).reshape(a.shape)


@pytest.fixture
def jit_td(monkeypatch):
    monkeypatch.setattr(j_td, "_ring_mul", _j_ring_mul)
    return j_td


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# host numpy modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draw", [
    lambda s, r: s.discrete_gaussian_cdt(r, 3.19, 500),
    lambda s, r: s.discrete_gaussian_rounded(r, 3.19, (4, 50)),
    lambda s, r: s.discrete_gaussian_peikert(r, 20.0, 500),
    lambda s, r: s.discrete_gaussian_peikert(r, 5.0, 100),
    lambda s, r: s.ternary_uniform(r, 300),
    lambda s, r: s.ternary_uniform(r, 300, h=64),
    lambda s, r: s.discrete_uniform(r, 134215681, (3, 7)),
    lambda s, r: s.binary_uniform(r, 200),
], ids=["cdt", "rounded", "peikert", "peikert-cdt", "ternary", "ternary-h", "uniform",
        "binary"])
def test_samplers_match_fhe_tpu(draw):
    """Each sampler from one seed: the same draws, in the same order."""
    got = draw(samplers, np.random.default_rng(31))
    want = draw(j_samplers, np.random.default_rng(31))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_dft_special_round_trip():
    rng = np.random.default_rng(7)
    c = rng.normal(size=64)
    v = dft.forward_special(c)
    np.testing.assert_array_equal(v, j_dft.forward_special(c))
    back = dft.inverse_special(v)
    np.testing.assert_array_equal(back, j_dft.inverse_special(v))
    np.testing.assert_allclose(back.real, c, atol=1e-12)
    x = rng.normal(size=16) + 1j * rng.normal(size=16)
    np.testing.assert_array_equal(dft.forward_transform(x), j_dft.forward_transform(x))
    np.testing.assert_array_equal(dft.inverse_transform(x), j_dft.inverse_transform(x))


def test_field2n_ops_match_fhe_tpu():
    """Sum, difference, product, inverse, transpose, automorphism, norm:
    the same numpy float64 path, bit for bit."""
    rng = np.random.default_rng(8)
    ca, cb = rng.normal(size=32), rng.normal(size=32)
    a, b = field2n.Field2n.from_coeffs(ca), field2n.Field2n.from_coeffs(cb)
    ja, jb = j_field2n.Field2n.from_coeffs(ca), j_field2n.Field2n.from_coeffs(cb)
    pairs = [(a + b, ja + jb), (a - b, ja - jb), (a * b, ja * jb),
             (a.inverse(), ja.inverse()), (a.transpose(), ja.transpose()),
             (a.automorphism(5), ja.automorphism(5)), (a.scalar_mul(2.5), ja.scalar_mul(2.5)),
             ((a * b).to_coeff(), (ja * jb).to_coeff())]
    for got, want in pairs:
        assert got.fmt == want.fmt
        np.testing.assert_array_equal(got.data, want.data)
    assert a.norm() == ja.norm()
    np.testing.assert_array_equal((a * b).real_coeffs(), (ja * jb).real_coeffs())
    with pytest.raises(ValueError, match="even"):
        a.automorphism(4)


@pytest.mark.parametrize("n,q", [(13, 65537), (70, 134215681)], ids=["schoolbook", "strassen"])
def test_matrix_products_match_fhe_tpu(n, q):
    """Schoolbook, and Strassen one size above its 64 cutoff (padded to
    128: one level of recursion): exact and equal to fhe_tpu's."""
    rng = np.random.default_rng(n)
    A = rng.integers(0, q, size=(n, n + 3), dtype=np.int64).astype(np.uint64)
    B = rng.integers(0, q, size=(n + 3, n - 2), dtype=np.int64).astype(np.uint64)
    want = j_matrix.mat_mul_mod(A, B, q)
    got = matrix.mat_mul_mod(A, B, q)
    np.testing.assert_array_equal(got, want)
    exact = (A.astype(object) @ B.astype(object)) % q
    np.testing.assert_array_equal(got.astype(object), exact)
    np.testing.assert_array_equal(matrix.strassen_mul_mod(A, B, q),
                                  j_matrix.strassen_mul_mod(A, B, q))
    np.testing.assert_array_equal(matrix.strassen_mul_mod(A, B, q), got)


# ---------------------------------------------------------------------------
# the trapdoor
# ---------------------------------------------------------------------------

def _pair(bits: int, seed: int, jit_td, sampler: str):
    """trapdoor_gen and one preimage of a random syndrome in both packages,
    from one seed each."""
    q = primes.last_prime(bits, 128)
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    jtd = jit_td.trapdoor_gen(jit_td.TrapdoorParams(N=64, q=q, base=2), jrng)
    ttd = trapdoor.trapdoor_gen(trapdoor.TrapdoorParams(N=64, q=q, base=2), trng, device=CPU)
    u = jrng.integers(0, q, size=64)
    np.testing.assert_array_equal(trng.integers(0, q, size=64), u)
    jx = getattr(jit_td, sampler)(jtd, u, jrng)
    tx = getattr(trapdoor, sampler)(ttd, u, trng)
    return jtd, ttd, u, jx, tx


@pytest.mark.parametrize("bits,sampler", [(12, "gauss_samp"), (27, "gauss_samp_corrected")])
def test_trapdoor_and_preimage_match_fhe_tpu(bits, sampler, jit_td):
    """fhe_tpu's test params (N = 64, q = last_prime(12 or 27, 128)): the
    public row, r, e and the preimage byte-equal; the preimage verifies in
    both packages and fails once changed."""
    jtd, ttd, u, jx, tx = _pair(bits, 40 + bits, jit_td, sampler)
    _eq(ttd.a_row, jtd.a_row)
    _eq(ttd.pair.r, jtd.pair.r)
    _eq(ttd.pair.e, jtd.pair.e)
    _eq(tx, jx)
    assert trapdoor.verify_preimage(ttd, tx, u) and jit_td.verify_preimage(jtd, jx, u)
    assert trapdoor.verify_preimage(ttd, jx, u)
    bad = tx.clone()
    bad[3, 5] = (bad[3, 5] + 1) % ttd.params.q
    assert not trapdoor.verify_preimage(ttd, bad, u)
    q = ttd.params.q
    xc = np.where(jx > q // 2, jx - q, jx).astype(np.float64)
    if sampler == "gauss_samp":
        assert np.abs(xc).max() < q // 4
    else:
        # fhe_tpu's bounds (tests/test_mathcore.py:119-122)
        p = ttd.params
        alpha = p.sigma * (p.base + 1)
        s = alpha * p.sigma * 1.2 * (math.sqrt(2 * p.N) + math.sqrt(p.k * p.N) + 4.7)
        assert np.abs(xc).max() < 10 * s and 0.2 * s < xc.std() < 3.0 * s


def test_trapdoor_helpers_match_fhe_tpu():
    """The G-lattice preimage, the gadget kernel basis, the Klein sampler
    and the embedding: fhe_tpu's values."""
    tp = trapdoor.TrapdoorParams(N=64, q=primes.last_prime(27, 128))
    jp = j_td.TrapdoorParams(N=64, q=tp.q)
    rng = np.random.default_rng(3)
    v = rng.integers(0, tp.q, size=64)
    z = trapdoor._g_preimage(tp, torch.from_numpy(v))
    _eq(z, j_td._g_preimage(jp, v))
    assert (sum(int(tp.base) ** i * z[i].numpy().astype(object) for i in range(tp.k))
            % tp.q == v).all()
    S = trapdoor._gadget_kernel_basis(tp)
    np.testing.assert_array_equal(S, j_td._gadget_kernel_basis(jp))
    center = rng.normal(size=(tp.k, 64))
    np.testing.assert_array_equal(
        trapdoor._klein_sample(S, center, 9.57, np.random.default_rng(4)),
        j_td._klein_sample(S, center, 9.57, np.random.default_rng(4)))
    np.testing.assert_array_equal(
        trapdoor._g_preimage_sampled(tp, v, 9.57, np.random.default_rng(5)),
        j_td._g_preimage_sampled(jp, v, 9.57, np.random.default_rng(5)))
    x = rng.normal(size=(2, 64))
    np.testing.assert_array_equal(trapdoor._embed(x), j_td._embed(x))
    np.testing.assert_array_equal(trapdoor._unembed(trapdoor._embed(x)),
                                  j_td._unembed(j_td._embed(x)))


def test_ring_products_are_one_launch_each_way():
    """The stacked products equal the row-by-row ones (the plain NTT on the
    CPU), and a sum of k + 2 products is one forward and one inverse call."""
    p = trapdoor.TrapdoorParams(N=64, q=primes.last_prime(27, 128))
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-5, p.q, size=(5, 64)))
    b = torch.from_numpy(rng.integers(-5, p.q, size=(5, 64)))
    rows = trapdoor._ring_mul(p, a, b)
    for i in range(5):
        _eq(rows[i], _j_ring_mul(j_td.TrapdoorParams(N=64, q=p.q), a[i].numpy(), b[i].numpy()))
    _eq(trapdoor._ring_dots(p, a, b), rows.sum(0) % p.q)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_eval", "_coeff"):
            mp.setattr(trapdoor, name, (lambda f, n: lambda *x: calls.append(n) or f(*x))(
                getattr(trapdoor, name), name))
        trapdoor._ring_dots(p, torch.stack([a, a]), b)
    assert calls == ["_eval", "_coeff"]


def test_convert_trapdoor_carries_fhe_tpu_s(jit_td):
    """An fhe_tpu trapdoor carried into the port samples the same preimage
    from the same generator state, and a preimage of it verifies."""
    q = primes.last_prime(12, 128)
    jtd = jit_td.trapdoor_gen(jit_td.TrapdoorParams(N=64, q=q), np.random.default_rng(9))
    ttd = convert.trapdoor(jtd.a_row, jtd.pair.r, jtd.pair.e, 64, q, device=CPU)
    assert ttd.params == trapdoor.TrapdoorParams(N=64, q=q)
    u = np.arange(64) * 17 % q
    tx = trapdoor.gauss_samp(ttd, u, np.random.default_rng(10))
    _eq(tx, jit_td.gauss_samp(jtd, u, np.random.default_rng(10)))
    assert trapdoor.verify_preimage(ttd, tx, u)
    with pytest.raises(ValueError, match="a_row"):
        convert.trapdoor(jtd.a_row[:-1], jtd.pair.r, jtd.pair.e, 64, q, device=CPU)


def test_port_runs_the_slice_without_jax():
    """The slice's modules import neither jax nor fhe_tpu: with jax blocked
    from import, a trapdoor preimage at N = 64, a multiply_arb at m = 15, a
    TOY threshold decrypt with proofs, a TOY witness and a packed round
    trip on the CPU."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from fhe_tpu_torch import BinFheContext
        from fhe_tpu_torch.lattice import trapdoor
        from fhe_tpu_torch.math import ntt_arb, primes
        from fhe_tpu_torch.tfhe import packed, threshold, zkp
        rng = np.random.default_rng(1)
        p = trapdoor.TrapdoorParams(N=64, q=primes.last_prime(27, 128))
        td = trapdoor.trapdoor_gen(p, rng, device="cpu")
        u = rng.integers(0, p.q, size=64)
        assert trapdoor.verify_preimage(td, trapdoor.gauss_samp_corrected(td, u, rng), u)
        q = primes.first_prime(28, 30)
        a, b = rng.integers(0, q, size=8), rng.integers(0, q, size=8)
        full = np.convolve(a.astype(object), b.astype(object))
        assert list(ntt_arb.multiply_arb(a, b, 15, q, device="cpu")) == \\
            list(ntt_arb._poly_mod_cyclo(full, 15, q))
        ctx = BinFheContext.generate("TOY", device="cpu")
        sk = ctx.key_gen(2)
        key = ctx.bt_key_gen(sk, 3)
        m = np.array([0, 1, 1, 0])
        ct = ctx.encrypt(sk, m, 4)
        cfg = threshold.ThresholdConfig(threshold=3, total_parties=3)
        shares, vks = threshold.generate_key_shares(sk.s, ct.modulus, cfg)
        assert threshold.threshold_decrypt(cfg, ct, shares, vks, p=4).tolist() == m.tolist()
        wb = zkp.WitnessBuilder("c")
        i = wb.register_input(ct)
        out = ctx.eval_bin_gate(key, "AND", ct, ct)
        wb.mark_output(wb.record_gate(zkp.GateType.AND, [i, i], out))
        assert zkp.WitnessVerifier().verify(wb.build())
        back = packed.unpack_lwe_batch(packed.pack_lwe_batch(out), device="cpu")
        assert ctx.decrypt(sk, back).tolist() == m.tolist()
        assert not [m for m in sys.modules if m == "fhe_tpu" or m.startswith("fhe_tpu.")]
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
