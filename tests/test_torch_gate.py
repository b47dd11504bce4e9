"""fhe_tpu_torch gate pipeline against fhe_tpu at TOY, byte for byte.

Three ways in: keys carried across from an fhe_tpu bt_key_gen by
fhe_tpu_torch.convert; the port's own keygen from the same seed (which
must give byte-identical keys); and the C++ reference's TOY bootstrap key
from tests/vectors/ (the port's version of
test_reference_kat.test_gate_with_reference_bootstrap_key).

At TOY q_ks == Q, so switch_ct_to_qn starts with the identity switch
Q -> Q.  fhe_tpu's round_scale_mod is off by a few units there (its
float-estimate divmod is exact only for quotients below 2^25; ROADMAP.md
queue 3); the port is exact.  So the gate's dimension-N output
(extended=True) is compared with fhe_tpu's directly, and the switched
output with fhe_tpu's key_switch + mod_switch of that extended output.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import PARAM_SETS as J_PARAM_SETS
from fhe_tpu.tfhe import BinFheContext as JContext
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import make_params as j_make_params
from fhe_tpu.tfhe import rgsw as j_rgsw
import fhe_tpu_torch
from fhe_tpu_torch import convert
from fhe_tpu_torch.math import ntt as tntt
from fhe_tpu_torch.tfhe import (PARAM_SETS, BinFheContext, Gate, LmkcdeyKey, Method, lwe,
                                make_params, rgsw)

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

VEC = os.path.join(os.path.dirname(__file__), "vectors")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRUTH = {
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "XOR": lambda a, b: a ^ b,
    "NAND": lambda a, b: 1 - (a & b),
}

j_key_switch = jax.jit(jlwe.key_switch, static_argnums=(0, 3))
j_mod_switch = jax.jit(jlwe.mod_switch, static_argnums=(1,))


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _eq_ct(jct, tct):
    assert (jct.modulus, jct.pt_mod) == (tct.modulus, tct.pt_mod)
    _eq(jct.a, tct.a)
    _eq(jct.b, tct.b)


@pytest.fixture(scope="module")
def toy():
    """fhe_tpu and port TOY contexts with keys from the same seed, and the
    fhe_tpu key carried across by convert."""
    jc, tc = JContext.generate("TOY"), BinFheContext.generate("TOY", device="cpu")
    jsk, tsk = jc.key_gen(21), tc.key_gen(21)
    bsk_device = j_rgsw._bsk_device
    # fhe_tpu's BSK assembly under one jit: the same exact integer ops, one
    # compile instead of hundreds of eager ones (~2 s against ~28 s)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rgsw, "_bsk_device", lambda plan, params, *x: jax.jit(
            functools.partial(bsk_device, plan, params))(*x))
        jkey = jc.bt_key_gen(jsk, 22)
    tkey = tc.bt_key_gen(tsk, 22)
    ckey = convert.bootstrap_key(np.asarray(jkey.bsk), np.asarray(jkey.ksk.a),
                                 np.asarray(jkey.ksk.b), device="cpu")
    return jc, tc, jsk, tsk, jkey, tkey, ckey


def test_same_seed_gives_identical_keys(toy):
    _, _, jsk, tsk, jkey, tkey, _ = toy
    _eq(jsk.s, tsk.s)
    _eq(jkey.bsk, tkey.bsk)
    _eq(jkey.ksk.a, tkey.ksk.a)
    _eq(jkey.ksk.b, tkey.ksk.b)


def test_converted_key_equals_port_key(toy):
    *_, tkey, ckey = toy
    for got, want in [(ckey.bsk, tkey.bsk), (ckey.ksk.a, tkey.ksk.a), (ckey.ksk.b, tkey.ksk.b)]:
        assert got.dtype == torch.int32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("gate", list(TRUTH))
def test_gate_matches_fhe_tpu(toy, gate, rng):
    jc, tc, jsk, _, jkey, _, ckey = toy
    m1 = np.array([0, 0, 1, 1, 0, 1])
    m2 = np.array([0, 1, 0, 1, 1, 1])
    jct1, jct2 = jc.encrypt(jsk, m1, 31), jc.encrypt(jsk, m2, 32)
    tct1, tct2 = (convert.ciphertext(np.asarray(c.a), np.asarray(c.b), c.modulus, device="cpu")
                  for c in (jct1, jct2))
    sk = convert.secret_key(np.asarray(jsk.s), device="cpu")
    want_ext = jc.eval_bin_gate(jkey, gate, jct1, jct2, extended=True)
    got_ext = tc.eval_bin_gate(ckey, gate, tct1, tct2, extended=True)
    _eq_ct(want_ext, got_ext)
    want = j_mod_switch(j_key_switch(jc.params, jkey.ksk, want_ext, "gather"), jc.params.q)
    got = tc.eval_bin_gate(ckey, gate, tct1, tct2)
    _eq_ct(want, got)
    np.testing.assert_array_equal(tc.decrypt(sk, got).numpy(), TRUTH[gate](m1, m2))


def test_multi_input_gates_bootstrap_and_constants(toy, rng):
    _, tc, _, tsk, _, tkey, _ = toy
    m1, m2, m3 = rng.integers(0, 2, size=(3, 8))
    cts = [tc.encrypt(tsk, m, rng) for m in (m1, m2, m3)]
    out = tc.eval_bin_gate_multi(tkey, "MAJORITY", cts)
    np.testing.assert_array_equal(tc.decrypt(tsk, out).numpy(), (m1 + m2 + m3 >= 2).astype(int))
    out = tc.bootstrap(tkey, cts[0])
    np.testing.assert_array_equal(tc.decrypt(tsk, out).numpy() % 2, m1)
    const = tc.eval_constant(np.array([0, 1, 0, 1, 1, 0, 1, 1]))
    out = tc.eval_bin_gate(tkey, Gate.AND, tc.eval_not(cts[1]), const)
    np.testing.assert_array_equal(tc.decrypt(tsk, out).numpy(), (1 - m2) & const.b.numpy() // (tc.params.q // 4))


def _sk_from_ref(vals, mod):
    v = vals.astype(np.int64)
    return convert.secret_key(np.where(v > mod // 2, v - mod, v).astype(np.int32), device="cpu")


def test_gate_with_reference_bootstrap_key():
    """The port's blind rotation, extraction and key switch driven by the
    C++ reference's TOY bootstrap key (imported from COEFFICIENT format
    with the port's own NTT), on reference-encrypted inputs."""
    with open(os.path.join(VEC, "manifest.json")) as f:
        m = json.load(f)["tfhe"]
    load = lambda name: np.load(os.path.join(VEC, name))
    params = make_params(m["paramset"])
    assert params.digits_g == m["digitsG"] and params.base_g == m["baseG"]
    sk = _sk_from_ref(load("tfhe_sk.npy"), m["qKS"])
    sk_n = _sk_from_ref(load("tfhe_skN.npy"), m["Q"])
    plan = tntt.make_plan(params.N, params.Q)
    coef = load("tfhe_bsk_coef.npy")
    ev = tntt.ntt_forward(plan, torch.from_numpy(coef.reshape(-1, params.N).astype(np.int32)))
    bsk = tntt.to_mont(plan, ev).reshape(coef.shape)
    ksk = lwe.key_switch_gen(params, sk, sk_n, np.random.default_rng(7))
    key = rgsw.BootstrapKey(bsk=bsk, ksk=ksk)
    a, b = load("tfhe_cts_a.npy"), load("tfhe_cts_b.npy")
    per = a.shape[0] // 2
    bits1, bits2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    rows1 = bits1 * per + np.array([0, 1, 2, 3])
    rows2 = bits2 * per + np.array([1, 2, 3, 0])
    ct1 = convert.ciphertext(a[rows1], b[rows1], m["q"], device="cpu")
    ct2 = convert.ciphertext(a[rows2], b[rows2], m["q"], device="cpu")
    ctx = BinFheContext(params=params, device=torch.device("cpu"))
    for gate, fn in TRUTH.items():
        out = ctx.eval_bin_gate(key, gate, ct1, ct2)
        got = ctx.decrypt(sk, out, p=4).numpy() % 2
        np.testing.assert_array_equal(got, fn(bits1, bits2), err_msg=gate)


def test_ternary_secret_guard():
    params = make_params("TOY")
    rng = np.random.default_rng(1)
    sk = lwe.LweSecretKey(s=torch.tensor([0, 2, -1] + [0] * (params.n - 3), dtype=torch.int32))
    sk_n = lwe.keygen(params, rng, dim=params.N, device="cpu")
    with pytest.raises(ValueError, match="ternary"):
        rgsw.bsk_gen(params, sk, sk_n, rng)


def test_method_mismatch_raises():
    with pytest.raises(ValueError):
        make_params("STD128_LMKCDEY", Method.GINX)
    with pytest.raises(ValueError):
        make_params("STD128", Method.LMKCDEY)
    ctx = BinFheContext.generate("STD128_LMKCDEY", device="cpu")
    assert ctx.params.method == Method.LMKCDEY
    # the set's own key (Gaussian secret), with n cut to 8 to stay fast
    ctx = dataclasses.replace(ctx, params=dataclasses.replace(ctx.params, n=8))
    key = ctx.bt_key_gen(ctx.key_gen(0))
    assert isinstance(key, LmkcdeyKey)
    assert key.rgsw.shape == (8, 4, 2, 1024) and key.auto.shape == (11, 2, 2, 1024)


def test_context_defaults_to_the_card():
    """Without a device the context, and so its keys and ciphertexts, is on
    the first CUDA card (nothing is allocated here)."""
    ctx = BinFheContext.generate("TOY")
    assert ctx.device.type == "cuda" and ctx.ntt_impl is None
    assert BinFheContext(params=make_params("TOY")).device.type == "cuda"


def test_context_key_switch_methods_match_fhe_tpu():
    """key_gen_n and key_switch_gen give fhe_tpu's keys from the same seeds;
    switch_ct_to_qn takes an (N, Q) ciphertext to a decryptable (n, q) one."""
    jc, tc = JContext.generate("TOY"), BinFheContext.generate("TOY", device="cpu")
    jsk, tsk = jc.key_gen(5), tc.key_gen(5)
    jskn, tskn = jc.key_gen_n(6), tc.key_gen_n(6)
    assert tskn.s.shape == (tc.params.N,)
    _eq(jskn.s, tskn.s)
    jk, tk = jc.key_switch_gen(jsk, jskn, 7), tc.key_switch_gen(tsk, tskn, 7)
    _eq(jk.a, tk.a)
    _eq(jk.b, tk.b)
    m = np.array([0, 1, 1, 0, 1])
    out = tc.switch_ct_to_qn(tk, tc.encrypt(tskn, m, 8, modulus=tc.params.Q))
    assert (out.n, out.modulus) == (tc.params.n, tc.params.q)
    np.testing.assert_array_equal(tc.decrypt(tsk, out).numpy(), m)


def test_params_match_fhe_tpu():
    assert list(PARAM_SETS) == list(J_PARAM_SETS) and len(PARAM_SETS) == 47
    for name in PARAM_SETS:
        got = dataclasses.asdict(make_params(name))
        want = dataclasses.asdict(j_make_params(name))
        assert got.pop("method").value == want.pop("method").value
        assert got.pop("key_dist").value == want.pop("key_dist").value
        assert got == want, name
    assert make_params("STD128") is make_params("STD128")


def test_port_runs_a_gate_without_jax():
    """The port imports neither jax nor fhe_tpu: a TOY gate with jax
    blocked from import."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import fhe_tpu_torch
        from fhe_tpu_torch import BinFheContext
        ctx = BinFheContext.generate("TOY", device="cpu")
        sk = ctx.key_gen(1)
        key = ctx.bt_key_gen(sk, 2)
        m1, m2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        out = ctx.eval_bin_gate(key, "AND", ctx.encrypt(sk, m1, 3), ctx.encrypt(sk, m2, 4))
        assert ctx.decrypt(sk, out).tolist() == [0, 0, 0, 1]
        assert not [m for m in sys.modules if m == "fhe_tpu" or m.startswith("fhe_tpu.")]
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert fhe_tpu_torch.__name__ == "fhe_tpu_torch"


def test_port_runs_multiparty_advanced_and_pre_without_jax():
    """pke.multiparty, pke.advanced and pke.pre import neither jax nor
    fhe_tpu: with jax blocked from import, a 3-party threshold decrypt, an
    eval_logistic and a PRE hop at N = 256 on the CPU."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from fhe_tpu_torch.lattice import rns
        from fhe_tpu_torch.pke import CkksContext, advanced, ckks, multiparty, pre
        ctx = CkksContext.create(N=256, num_levels=6, scale_bits=26, dnum=2, device="cpu")
        rng = np.random.default_rng(1)
        sks, pk = multiparty.multiparty_keygen(ctx.params, 3, rng, device="cpu")
        z = rng.uniform(-4, 4, size=128)
        ct = ctx.encrypt(pk, z, rng)
        ph = multiparty.threshold_decrypt_pipeline(ctx.params, sks, ct.c0, ct.c1, rng)
        m = ckks._center(rns.to_bigint(ph), rns.modulus_product(ct.moduli))
        assert np.abs(ckks.decode(m, 256, ct.scale).real - z).max() < 1.2
        sk, pk1 = ctx.keygen(rng)
        sk2, pk2 = ctx.keygen(rng)
        out = advanced.eval_logistic(ctx, ctx.encrypt(pk1, z, rng), -5, 5, 8,
                                     ctx.relin_key_gen(sk, rng))
        assert np.abs(ctx.decrypt(sk, out).real - 1 / (1 + np.exp(-z))).max() < 5e-2
        ct1 = ctx.encrypt(pk1, z, rng)
        c0, c1 = pre.re_encrypt(ctx.params, pre.re_key_gen(ctx.params, sk, sk2, rng), ct1.c0,
                                ct1.c1, rng, pk2)
        assert np.abs(ctx.decrypt(sk2, ckks.Ciphertext(c0, c1, ct1.scale)).real - z).max() < 1e-2
        assert not [m for m in sys.modules if m == "fhe_tpu" or m.startswith("fhe_tpu.")]
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
