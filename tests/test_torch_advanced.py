"""fhe_tpu_torch's advanced SHE (pke/advanced.py) and function
approximation (math/approx.py) against fhe_tpu on the CPU, at the sizes of
fhe_tpu's tests/test_advanced.py (N = 256, 6 levels) and
test_advanced_ext.py (N = 256, 8 levels): their 16 tests on the port, each
decoded within fhe_tpu's own tolerance there (named in each test), and
each function's ciphertexts byte for byte against fhe_tpu's advanced.py.

advanced.py is host composition over the context's ops and three ring ops
(rns.mul_scalar, neg, level_reduce).  fhe_tpu's functions jitted take
25-270 s each to trace and compile on the CPU (its NTT graphs are large:
eval_poly of degree 3 is 12 s of tracing and 12 s of compiling), and
eagerly they compile op by op, so tier-1 runs fhe_tpu's advanced.py over
the port: its control flow (which ops, rotations, alignments, scalar
multiples and plaintexts, in which order) with each CkksContext op
(`_Bridge`) and each of the three ring ops (`_PortRing`) the port's on
the carried data.  Every one of those ops is held to fhe_tpu's own byte
for byte in test_torch_ckks*.py and test_torch_rns_ring.py, so equal
bytes here mean the port issues fhe_tpu's composition exactly.  The
`slow` test runs fhe_tpu's own context, jitted, on the port's keys and
ciphertext (time in its docstring).

The keys (the secret and EvalSum's rotations) are held to fhe_tpu's
from one seed.  The port runs with device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.math import approx as j_approx
from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import approx
from fhe_tpu_torch.pke import advanced as adv
from fhe_tpu_torch.pke import bfv, bgv, ckks

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SLOTS = N // 2


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jct(ct):
    return j_ckks.Ciphertext(_jpoly(ct.c0), _jpoly(ct.c1), ct.scale)


def _pct(jct):
    return ckks.Ciphertext(_ppoly(jct.c0), _ppoly(jct.c1), jct.scale)


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _ppoly(p):
    return rns.RnsPoly(torch.from_numpy(np.asarray(p.data).astype(np.int32)), p.moduli, p.fmt)


class _PortRing:
    """The ring ops fhe_tpu's advanced.py calls, over the port's."""
    RnsPoly = j_rns.RnsPoly

    @staticmethod
    def mul_scalar(p, c):
        return _jpoly(rns.mul_scalar(_ppoly(p), c))

    @staticmethod
    def neg(p):
        return _jpoly(rns.neg(_ppoly(p)))

    @staticmethod
    def level_reduce(p, drop):
        return _jpoly(rns.level_reduce(_ppoly(p), drop))


@pytest.fixture(scope="module", autouse=True)
def _fhe_tpu_advanced_over_the_port_ring():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_adv, "rns", _PortRing)
        yield


def _jsk(sk):
    return j_rlwe.SecretKey(s_signed=jnp.asarray(sk.s_signed.numpy()),
                            s_eval_full=_j(sk.s_eval_full), moduli_full=sk.moduli_full)


class _Bridge:
    """fhe_tpu's CkksContext surface over the port's context: fhe_tpu
    ciphertexts in and out, each op the port's on the carried data."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.params = ctx.params
        self.cd = ctx.cd

    def __getattr__(self, name):
        fn = getattr(self._ctx, name)

        def call(*args):
            out = fn(*[_pct(a) if isinstance(a, j_ckks.Ciphertext) else a for a in args])
            return _jct(out) if isinstance(out, ckks.Ciphertext) else out
        return call


def _carry(x):
    if isinstance(x, ckks.Ciphertext):
        return _jct(x)
    if isinstance(x, list):
        return [_carry(v) for v in x]
    return x


def _both(ctx, name: str, *args):
    """advanced.<name>(ctx, *args) in the port, and fhe_tpu's over the
    bridge on the same inputs: byte-equal (every ciphertext of a list);
    returns the port's result."""
    got = getattr(adv, name)(ctx, *args)
    want = getattr(j_adv, name)(_Bridge(ctx), *[_carry(a) for a in args])
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert (g.moduli, g.scale) == (w.c0.moduli, w.scale), name
        _eq(w.c0.data, g.c0.data)
        _eq(w.c1.data, g.c1.data)
    return got


@pytest.fixture(scope="module")
def setup():
    """tests/test_advanced.py's: N = 256, 6 levels, scale 2^26, dnum = 2,
    seed 23; relinearization and EvalSum keys."""
    ctx = ckks.CkksContext.create(N=N, num_levels=6, scale_bits=26, dnum=2, device="cpu")
    rng = np.random.default_rng(23)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    rot_keys = adv.sum_key_gen(ctx, sk, rng)
    return ctx, sk, pk, evk, rot_keys, np.random.default_rng(12345)


@pytest.fixture(scope="module")
def ext():
    """tests/test_advanced_ext.py's: N = 256, 8 levels, seed 31."""
    ctx = ckks.CkksContext.create(N=N, num_levels=8, scale_bits=26, dnum=2, device="cpu")
    rng = np.random.default_rng(31)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    return ctx, sk, pk, evk, rng


def test_keys_match_fhe_tpu():
    """keygen and sum_key_gen draw as fhe_tpu's from one seed (its key
    generation jitted, the generator closed over, on the carried secret);
    sum_key_gen at batch 8 (rotations 1, 2, 4: rotation_key_gen at every
    index is held to fhe_tpu's in test_torch_ckks_ops.py), and at the
    full 128 slots the indices 1, 2, ..., 64."""
    kw = dict(N=N, num_levels=6, scale_bits=26, dnum=2)
    ctx, jctx = ckks.CkksContext.create(**kw, device="cpu"), j_ckks.CkksContext.create(**kw)
    rng = np.random.default_rng(23)
    sk, _ = ctx.keygen(rng)
    rot = adv.sum_key_gen(ctx, sk, rng, batch=8)
    jrng = np.random.default_rng(23)
    jsk, _ = jax.jit(lambda: jctx.keygen(jrng))()
    _eq(jsk.s_eval_full, sk.s_eval_full)
    jrot = jax.jit(lambda s: j_adv.sum_key_gen(jctx, s, jrng, batch=8))(_jsk(sk))
    assert sorted(jrot) == sorted(rot) == [1, 2, 4]
    for r in rot:
        _eq(jrot[r].b, rot[r].b)
        _eq(jrot[r].a, rot[r].a)
    assert sorted(adv.sum_key_gen(ctx, sk, rng)) == [1, 2, 4, 8, 16, 32, 64]


@pytest.mark.parametrize("gen, args", [("sum_key_gen", (16,)), ("sum_rows_key_gen", (32,)),
                                       ("sum_cols_key_gen", (8,)), ("merge_key_gen", (4,))])
def test_key_generators_match_fhe_tpu(ext, gen, args):
    """Each key generator asks for fhe_tpu's indices in fhe_tpu's order
    (fhe_tpu's over the bridge, from the same seed): the same keys."""
    ctx, sk = ext[:2]
    got = getattr(adv, gen)(ctx, sk, np.random.default_rng(5), *args)
    want = getattr(j_adv, gen)(_Bridge(ctx), sk, np.random.default_rng(5), *args)
    assert list(got) == list(want)
    for r in got:
        assert torch.equal(got[r].b, want[r].b) and torch.equal(got[r].a, want[r].a)


# -- tests/test_advanced.py -------------------------------------------------

def test_eval_sum(setup):
    """EvalSum over all 128 slots (7 rotations), within fhe_tpu's 1e-2."""
    ctx, sk, pk, _, rot_keys, rng = setup
    z = rng.normal(size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    out = ctx.decrypt(sk, _both(ctx, "eval_sum", ct, SLOTS, rot_keys))
    np.testing.assert_allclose(out.real, np.full(SLOTS, z.sum()), atol=1e-2)


def test_inner_product(setup):
    """EvalInnerProduct within fhe_tpu's 5e-2."""
    ctx, sk, pk, evk, rot_keys, rng = setup
    z1 = rng.normal(size=SLOTS) * 0.3
    z2 = rng.normal(size=SLOTS) * 0.3
    ct1, ct2 = ctx.encrypt(pk, z1, rng), ctx.encrypt(pk, z2, rng)
    out = ctx.decrypt(sk, _both(ctx, "eval_inner_product", ct1, ct2, SLOTS, evk, rot_keys))
    np.testing.assert_allclose(out.real, np.full(SLOTS, z1 @ z2), atol=5e-2)


def test_linear_wsum(setup):
    """EvalLinearWSum of 3 within fhe_tpu's 1e-2."""
    ctx, sk, pk, _, _, rng = setup
    zs = [rng.normal(size=SLOTS) for _ in range(3)]
    ws = [0.5, -1.25, 2.0]
    cts = [ctx.encrypt(pk, z, rng) for z in zs]
    out = ctx.decrypt(sk, _both(ctx, "eval_linear_wsum", cts, ws))
    np.testing.assert_allclose(out.real, sum(w * z for w, z in zip(ws, zs)), atol=1e-2)


def test_eval_poly(setup):
    """0.25 - x + 0.5 x^2 + 0.125 x^3 by the linear chain, within fhe_tpu's
    2e-2; eval_poly_linear is the same call."""
    ctx, sk, pk, evk, _, rng = setup
    z = rng.uniform(-0.8, 0.8, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    coeffs = [0.25, -1.0, 0.5, 0.125]
    got = _both(ctx, "eval_poly", ct, coeffs, evk)
    want = coeffs[0] + coeffs[1] * z + coeffs[2] * z**2 + coeffs[3] * z**3
    np.testing.assert_allclose(ctx.decrypt(sk, got).real, want, atol=2e-2)
    lin = adv.eval_poly_linear(ctx, ct, coeffs, evk)
    assert torch.equal(lin.c0.data, got.c0.data) and torch.equal(lin.c1.data, got.c1.data)


def test_chebyshev_series(setup):
    """exp(x) on [-1, 1] by a degree-4 Chebyshev series (the three-term
    recurrence), within fhe_tpu's 5e-2."""
    ctx, sk, pk, evk, _, rng = setup
    z = rng.uniform(-0.9, 0.9, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    nodes = np.cos(np.pi * (np.arange(200) + 0.5) / 200)
    coeffs = [2.0 / 200 * np.sum(np.exp(nodes) * np.cos(j * np.arccos(nodes)))
              for j in range(5)]
    coeffs[0] /= 2
    out = ctx.decrypt(sk, _both(ctx, "eval_chebyshev_series", ct, coeffs, -1.0, 1.0, evk))
    np.testing.assert_allclose(out.real, np.exp(z), atol=5e-2)


def test_linear_transform(setup):
    """A banded 128 x 128 matrix (diagonals 0, 1, 2: two rotations, the
    other 125 diagonals skipped), within fhe_tpu's 1e-2."""
    ctx, sk, pk, _, rot_keys, rng = setup
    z = rng.normal(size=SLOTS) * 0.5
    M = np.zeros((SLOTS, SLOTS))
    for d, w in [(0, 1.0), (1, 0.5), (2, -0.25)]:
        for i in range(SLOTS):
            M[i, (i + d) % SLOTS] = w
    ct = ctx.encrypt(pk, z, rng)
    out = ctx.decrypt(sk, _both(ctx, "eval_linear_transform", ct, M, rot_keys))
    np.testing.assert_allclose(out.real, M @ z, atol=1e-2)


# -- tests/test_advanced_ext.py ---------------------------------------------

def test_eval_sum_rows(ext):
    """EvalSumRows of a 4 x 32 slot matrix within fhe_tpu's 1e-2."""
    ctx, sk, pk, _, rng = ext
    rows, cols = 4, SLOTS // 4
    M = rng.normal(size=(rows, cols))
    ct = ctx.encrypt(pk, M.reshape(-1), rng)
    keys = adv.sum_rows_key_gen(ctx, sk, rng, cols)
    out = ctx.decrypt(sk, _both(ctx, "eval_sum_rows", ct, cols, keys))
    np.testing.assert_allclose(out.real, np.tile(M.sum(axis=0), rows), atol=1e-2)


def test_eval_sum_cols(ext):
    """EvalSumCols of a 16 x 8 slot matrix within fhe_tpu's 2e-2."""
    ctx, sk, pk, _, rng = ext
    cols = 8
    M = rng.normal(size=(SLOTS // cols, cols))
    ct = ctx.encrypt(pk, M.reshape(-1), rng)
    keys = adv.sum_cols_key_gen(ctx, sk, rng, cols)
    assert sorted(keys) == [-4, -2, -1, 1, 2, 4]
    out = ctx.decrypt(sk, _both(ctx, "eval_sum_cols", ct, cols, keys))
    np.testing.assert_allclose(out.real, np.repeat(M.sum(axis=1), cols), atol=2e-2)


def test_eval_merge(ext):
    """EvalMerge of 4 ciphertexts' slot 0, the rest 0, within fhe_tpu's
    1e-2."""
    ctx, sk, pk, _, rng = ext
    zs = [rng.normal(size=SLOTS) for _ in range(4)]
    cts = [ctx.encrypt(pk, z, rng) for z in zs]
    keys = adv.merge_key_gen(ctx, sk, rng, 4)
    out = ctx.decrypt(sk, _both(ctx, "eval_merge", cts, keys)).real
    np.testing.assert_allclose(out[:4], [z[0] for z in zs], atol=1e-2)
    np.testing.assert_allclose(out[4:], 0.0, atol=1e-2)


def test_add_many_mult_many(ext):
    """EvalAddMany and EvalMultMany of 5 within fhe_tpu's 1e-2 and 2e-2."""
    ctx, sk, pk, evk, rng = ext
    zs = [rng.uniform(0.3, 0.9, size=SLOTS) for _ in range(5)]
    cts = [ctx.encrypt(pk, z, rng) for z in zs]
    out = ctx.decrypt(sk, _both(ctx, "eval_add_many", cts))
    np.testing.assert_allclose(out.real, np.sum(zs, axis=0), atol=1e-2)
    out = ctx.decrypt(sk, _both(ctx, "eval_mult_many", cts, evk))
    np.testing.assert_allclose(out.real, np.prod(zs, axis=0), atol=2e-2)


def test_negate_compress(ext):
    """EvalNegate and Compress to one tower within fhe_tpu's 1e-2."""
    ctx, sk, pk, _, rng = ext
    z = rng.normal(size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    np.testing.assert_allclose(ctx.decrypt(sk, _both(ctx, "eval_negate", ct)).real, -z,
                               atol=1e-2)
    small = _both(ctx, "compress", ct, 1)
    assert len(small.moduli) == ctx.cd
    np.testing.assert_allclose(ctx.decrypt(sk, small).real, z, atol=1e-2)


def test_eval_logistic(ext):
    """EvalLogistic on [-5, 5] at degree 16 (Paterson-Stockmeyer) within
    fhe_tpu's 2e-2."""
    ctx, sk, pk, evk, rng = ext
    z = rng.uniform(-4, 4, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    out = ctx.decrypt(sk, _both(ctx, "eval_logistic", ct, -5, 5, 16, evk))
    np.testing.assert_allclose(out.real, 1 / (1 + np.exp(-z)), atol=2e-2)


def test_eval_sin_cos(ext):
    """EvalSin and EvalCos on [-1.5, 1.5] at degree 12 within fhe_tpu's
    2e-2."""
    ctx, sk, pk, evk, rng = ext
    z = rng.uniform(-1.0, 1.0, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    out = ctx.decrypt(sk, _both(ctx, "eval_sin", ct, -1.5, 1.5, 12, evk))
    np.testing.assert_allclose(out.real, np.sin(z), atol=2e-2)
    out = ctx.decrypt(sk, _both(ctx, "eval_cos", ct, -1.5, 1.5, 12, evk))
    np.testing.assert_allclose(out.real, np.cos(z), atol=2e-2)


def test_eval_divide(ext):
    """EvalDivide, 1/x on [0.8, 3.2] at degree 24, within fhe_tpu's 3e-2."""
    ctx, sk, pk, evk, rng = ext
    z = rng.uniform(1.0, 3.0, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    out = ctx.decrypt(sk, _both(ctx, "eval_divide", ct, 0.8, 3.2, 24, evk))
    np.testing.assert_allclose(out.real, 1.0 / z, atol=3e-2)


def test_eval_poly_ps_and_precomp(ext):
    """EvalPolyPS (poly2cheb onto the PS Chebyshev evaluator) and EvalPowers
    + EvalPolyWithPrecomp of a quartic match the linear chain, each within
    fhe_tpu's 2e-2 (fhe_tpu's own test is `slow`; the port's runs here)."""
    ctx, sk, pk, evk, rng = ext
    z = rng.uniform(-1, 1, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    coeffs = [0.5, -1.0, 0.25, 0.125, -0.0625]
    want = sum(c * z**k for k, c in enumerate(coeffs))
    for got in (_both(ctx, "eval_poly", ct, coeffs, evk),
                _both(ctx, "eval_poly_ps", ct, coeffs, evk)):
        np.testing.assert_allclose(ctx.decrypt(sk, got).real, want, atol=2e-2)
    pws = _both(ctx, "eval_powers", ct, 4, evk)
    got = _both(ctx, "eval_poly_with_precomp", pws, coeffs, evk)
    np.testing.assert_allclose(ctx.decrypt(sk, got).real, want, atol=2e-2)
    with pytest.raises(ValueError, match="constant-only"):
        adv.eval_poly_with_precomp(ctx, pws, [1.0, 0.0], evk)


def test_square_and_raw_automorphism():
    """EvalSquare on the BGV and BFV contexts exact, and a raw CKKS
    EvalAutomorphism (galois element 5 = rotation by 1) within fhe_tpu's
    1e-3 (fhe_tpu's test on the port)."""
    rng = np.random.default_rng(12345)
    bctx = bgv.BgvContext.create(N=N, num_levels=2, plain_mod=65537, mod_bits=28, dnum=2,
                                 device="cpu")
    sk, pk = bctx.keygen(rng)
    evk = bctx.relin_key_gen(sk, rng)
    m = rng.integers(0, 100, size=N)
    np.testing.assert_array_equal(bctx.decrypt(sk, bctx.square(bctx.encrypt(pk, m, rng), evk)),
                                  m * m % 65537)
    fctx = bfv.BfvContext.create(N=N, num_limbs=3, plain_mod=65537, dnum=2, device="cpu")
    fsk, fpk = fctx.keygen(rng)
    fevk = fctx.relin_key_gen(fsk, rng)
    np.testing.assert_array_equal(
        fctx.decrypt(fsk, fctx.square(fctx.encrypt(fpk, m, rng), fevk)), m * m % 65537)
    cctx = ckks.CkksContext.create(N=N, num_levels=3, scale_bits=28, dnum=2, device="cpu")
    csk, cpk = cctx.keygen(rng)
    ak = cctx.automorphism_key_gen(csk, [5], rng)
    z = rng.normal(size=SLOTS)
    rot = cctx.automorphism(cctx.encrypt(cpk, z, rng), 5, ak[5])
    np.testing.assert_allclose(cctx.decrypt(csk, rot).real, np.roll(z, -1), atol=1e-3)


# -- math/approx.py -----------------------------------------------------------

def test_approx_is_fhe_tpu_s():
    """The copied coefficient generators give fhe_tpu's floats exactly."""
    f = lambda x: 1.0 / (1.0 + np.exp(-x))
    assert approx.chebyshev_coefficients(f, -5, 5, 16) == j_approx.chebyshev_coefficients(
        f, -5, 5, 16)
    assert approx.chebyshev_fit(np.sin, -1.5, 1.5, tol=1e-7) == j_approx.chebyshev_fit(
        np.sin, -1.5, 1.5, tol=1e-7)
    samples = np.cos(np.linspace(0, 2 * np.pi, 32, endpoint=False))
    c = approx.hermite_trig_coefficients(samples)
    np.testing.assert_array_equal(c, j_approx.hermite_trig_coefficients(samples))
    theta = np.linspace(0, 1, 5)
    np.testing.assert_array_equal(approx.hermite_trig_eval(c, theta),
                                  j_approx.hermite_trig_eval(c, theta))
    with pytest.raises(ValueError, match="at least 1"):
        approx.chebyshev_coefficients(f, -5, 5, 0)


# -- fhe_tpu's own context, jitted --------------------------------------------

@pytest.mark.slow
def test_eval_sum_and_logistic_are_fhe_tpu_s_own(ext, monkeypatch):
    """fhe_tpu's eval_sum and eval_logistic (degree 16) on its own context,
    jitted, on the port's keys and ciphertext: the port's ciphertexts byte
    for byte (about 30 s and 100 s of tracing and compiling)."""
    ctx, sk, pk, evk, rng = ext
    monkeypatch.setattr(j_adv, "rns", j_rns)
    jctx = j_ckks.CkksContext.create(N=N, num_levels=8, scale_bits=26, dnum=2)
    keys = ctx.rotation_key_gen(sk, [1, 2, 4], rng)
    z = rng.uniform(-4, 4, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    jkey = lambda k: j_rlwe.EvalKey(b=_j(k.b), a=_j(k.a), moduli_qp=k.moduli_qp,
                                    num_per_part=k.num_per_part)
    jsum = jax.jit(lambda c, ks: j_adv.eval_sum(jctx, c, 8, ks))
    jsig = jax.jit(lambda c, k: j_adv.eval_logistic(jctx, c, -5, 5, 16, k))
    for got, want in (
            (adv.eval_sum(ctx, ct, 8, keys), jsum(_jct(ct), {r: jkey(k) for r, k in keys.items()})),
            (adv.eval_logistic(ctx, ct, -5, 5, 16, evk), jsig(_jct(ct), jkey(evk)))):
        assert (got.moduli, got.scale) == (want.c0.moduli, want.scale)
        _eq(want.c0.data, got.c0.data)
        _eq(want.c1.data, got.c1.data)
