"""fhe_tpu_torch's RNS ring (lattice/rns.py) and the exact basis switch's
correction (math/modmath.py fraction_round_v) against fhe_tpu on the CPU,
byte for byte, at tests/test_ckks.py's size: N = 256 over its CKKS chain
(Q: 5 limbs, P: 3).

The fhe_tpu side runs jitted, one compiled function per group of ops,
built once per module; the port runs with device="cpu", where every NTT
is the plain per-limb loop.  Inputs are random residues from numpy.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.math import modmath as j_modmath
from fhe_tpu.pke import params as j_params
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import modmath
from fhe_tpu_torch.pke import params

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
PARAMS = params.make_ckks_params(N=N, num_levels=4, scale_bits=26, first_bits=30, dnum=2)
Q = tuple(PARAMS.moduli)
P = tuple(PARAMS.special_mods)
QP = Q + P
ROWS = 2


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64), np.asarray(jarr).astype(np.int64))


def _res(gen, moduli, rows=ROWS):
    return np.stack([gen.integers(0, q, size=(rows, N)) for q in moduli], axis=-2)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(torch.int32)


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


def test_params_match_fhe_tpu():
    """make_ckks_params is host code: the same chain, P and digits, also at
    bench config 3 (N = 2^14, 7 levels of 26 bits, dnum = 3)."""
    fields = dataclasses.asdict
    assert fields(PARAMS) == fields(j_params.make_ckks_params(N=N, num_levels=4, scale_bits=26,
                                                              first_bits=30, dnum=2))
    big = params.make_ckks_params(N=1 << 14, num_levels=7, scale_bits=26, first_bits=30, dnum=3)
    assert fields(big) == fields(j_params.make_ckks_params(N=1 << 14, num_levels=7,
                                                           scale_bits=26, first_bits=30, dnum=3))
    assert big.moduli == (1073643521, 67239937, 67043329, 67502081, 66813953, 67731457,
                          66551809, 68190209)
    assert big.special_mods == (1073479681, 1073184769, 1073053697)
    with pytest.raises(ValueError, match="HE-standard bound"):
        params.make_ckks_params(N=1024, num_levels=4, security="128_classic")


@pytest.fixture(scope="module")
def ring():
    """Random residues over Q and QP, and fhe_tpu's results of every ring op
    on them from one jitted function."""
    gen = np.random.default_rng(31)
    xq, yq, xqp = _res(gen, Q), _res(gen, Q), _res(gen, QP)
    scal = [int(v) for v in gen.integers(1, 1 << 30, size=len(Q))]

    def j_ops(xq, yq, xqp):
        c = lambda d, m: j_rns.RnsPoly(d, m, j_rns.COEFF)
        e = lambda d, m: j_rns.RnsPoly(d, m, j_rns.EVAL)
        a, b = e(xq, Q), e(yq, Q)
        qp = c(xqp, QP)
        return {
            "ntt": j_rns.ntt_forward(a.plan, xq),
            "intt": j_rns.ntt_inverse(a.plan, xq),
            "add": j_rns.add(a, b).data, "sub": j_rns.sub(a, b).data,
            "neg": j_rns.neg(a).data, "mul": j_rns.mul(a, b).data,
            "mul_scalar": j_rns.mul_scalar(a, jnp.asarray(np.array(scal, np.uint32))).data,
            "mul_scalar_int": j_rns.mul_scalar(a, 123456789).data,
            "automorphism_5": j_rns.automorphism(a, 5).data,
            "automorphism_conj": j_rns.automorphism(a, 2 * N - 1).data,
            "mul_monomial": j_rns.mul_monomial(a, 3).data,
            "mul_monomial_neg": j_rns.mul_monomial(a, 2 * N - 7).data,
            "approx_q_p": j_rns.switch_crt_basis_approx(c(xq, Q), P).data,
            "exact_q_p": j_rns.switch_crt_basis_exact(c(xq, Q), P).data,
            "exact_q_p_centered": j_rns.switch_crt_basis_exact(c(xq, Q), P, centered=True).data,
            "exact_p_q": j_rns.switch_crt_basis_exact(c(xqp[..., 5:, :], P), Q).data,
            "expand": j_rns.expand_crt_basis_approx(c(xq, Q), P).data,
            "approx_mod_down": j_rns.approx_mod_down(qp, Q, P).data,
            "drop_last": j_rns.drop_last_element_and_scale(c(xq, Q)).data,
            "level_reduce": j_rns.level_reduce(c(xq, Q), 2).data,
        }

    want = jax.jit(j_ops)(_j(xq), _j(yq), _j(xqp))
    return xq, yq, xqp, scal, want


def _port_ops(xq, yq, xqp, scal):
    c = lambda d, m: rns.RnsPoly(_t(d), m, rns.COEFF)
    e = lambda d, m: rns.RnsPoly(_t(d), m, rns.EVAL)
    a, b = e(xq, Q), e(yq, Q)
    return {
        "ntt": lambda: rns.to_eval(c(xq, Q)).data,
        "intt": lambda: rns.to_coeff(a).data,
        "add": lambda: rns.add(a, b).data, "sub": lambda: rns.sub(a, b).data,
        "neg": lambda: rns.neg(a).data, "mul": lambda: rns.mul(a, b).data,
        "mul_scalar": lambda: rns.mul_scalar(a, scal).data,
        "mul_scalar_int": lambda: rns.mul_scalar(a, 123456789).data,
        "automorphism_5": lambda: rns.automorphism(a, 5).data,
        "automorphism_conj": lambda: rns.automorphism(a, 2 * N - 1).data,
        "mul_monomial": lambda: rns.mul_monomial(a, 3).data,
        "mul_monomial_neg": lambda: rns.mul_monomial(a, 2 * N - 7).data,
        "approx_q_p": lambda: rns.switch_crt_basis_approx(c(xq, Q), P).data,
        "exact_q_p": lambda: rns.switch_crt_basis_exact(c(xq, Q), P).data,
        "exact_q_p_centered": lambda: rns.switch_crt_basis_exact(c(xq, Q), P,
                                                                 centered=True).data,
        "exact_p_q": lambda: rns.switch_crt_basis_exact(c(xqp[..., 5:, :], P), Q).data,
        "expand": lambda: rns.expand_crt_basis_approx(c(xq, Q), P).data,
        "approx_mod_down": lambda: rns.approx_mod_down(c(xqp, QP), Q, P).data,
        "drop_last": lambda: rns.drop_last_element_and_scale(c(xq, Q)).data,
        "level_reduce": lambda: rns.level_reduce(c(xq, Q), 2).data,
    }


OPS = ["ntt", "intt", "add", "sub", "neg", "mul", "mul_scalar", "mul_scalar_int",
       "automorphism_5", "automorphism_conj", "mul_monomial", "mul_monomial_neg", "approx_q_p",
       "exact_q_p", "exact_q_p_centered", "exact_p_q", "expand", "approx_mod_down", "drop_last",
       "level_reduce"]


@pytest.mark.parametrize("op", OPS)
def test_ring_op_matches_fhe_tpu(ring, op):
    xq, yq, xqp, scal, want = ring
    ops = _port_ops(xq, yq, xqp, scal)
    assert sorted(ops) == sorted(OPS) == sorted(want)
    _eq(want[op], ops[op]())


def test_bigint_round_trip(ring):
    """to_bigint / from_bigint: CRT to exact integers and back, equal to
    fhe_tpu's reconstruction."""
    xq = ring[0][0]
    p = rns.RnsPoly(_t(xq), Q, rns.COEFF)
    big = rns.to_bigint(p)
    assert list(big) == list(j_rns.to_bigint(j_rns.RnsPoly(_j(xq), Q, j_rns.COEFF)))
    back = rns.from_bigint(big, Q, N, device="cpu")
    assert torch.equal(back.data, p.data) and back.fmt == rns.COEFF


def _near_half(gen, mods, count):
    """y [L, count] whose fraction sum_i y_i / q_i lies within count / Q of
    one half: the residues of x = floor(Q/2) + delta, delta in
    [-count/2, count/2), times (Q/q_i)^-1 mod q_i."""
    Qp = 1
    for q in mods:
        Qp *= q
    xs = [Qp // 2 + d for d in range(-count // 2, count - count // 2)]
    gen.shuffle(xs)
    return np.array([[x % q * pow(Qp // q % q, -1, q) % q for x in xs] for q in mods],
                    dtype=np.int64)


def _truncated_v(y, mods, centered):
    """fhe_tpu's v in Python integers: floor((sum y_i floor(2^62/q_i)
    [+ 2^61]) / 2^62)."""
    out = []
    for k in range(y.shape[-1]):
        t = sum(int(y[i, k]) * ((1 << 62) // q) for i, q in enumerate(mods))
        out.append((t + ((1 << 61) if centered else 0)) >> 62)
    return np.array(out)


@functools.lru_cache(maxsize=None)
def _j_fraction_round_v(mods, centered):
    return jax.jit(lambda y: j_modmath.fraction_round_v(y, mods, centered))


@pytest.mark.parametrize("mods", [Q, P, QP], ids=["Q", "P", "QP"])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("inputs", ["random", "near_half"])
def test_fraction_round_v_matches_fhe_tpu(mods, centered, inputs):
    """v of the exact basis switch, on random y and on y whose fractional
    sum lies within L 2^-27 of a half (there 2^-120 of it), where a float
    estimate or the untruncated sum would round otherwise."""
    gen = np.random.default_rng(7)
    y = (np.stack([gen.integers(0, q, size=N) for q in mods]) if inputs == "random"
         else _near_half(gen, mods, N))
    got = modmath.fraction_round_v(_t(y), mods, centered)
    _eq(_j_fraction_round_v(mods, centered)(_j(y)), got)
    np.testing.assert_array_equal(got.numpy(), _truncated_v(y, mods, centered))
