"""fhe_tpu_torch LWE layer against fhe_tpu, byte for byte: keygen, encrypt,
decrypt, mod switch, key-switch keys, key switch and switch_ct_to_qn.

Two parameter sets: TOY (q_ks = Q, an odd prime) and STD128 (q_ks = 2^14).
The STD128 switching-key tests keep STD128's moduli and gadget but use
small key dimensions, so the key is [64, 3, 32, 32] instead of 198 MB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import make_params as j_make_params
from fhe_tpu_torch import convert
from fhe_tpu_torch.tfhe import lwe as tlwe
from fhe_tpu_torch.tfhe import make_params as t_make_params

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


# jitted: eager XLA compiles every op of the reference separately
j_key_switch = jax.jit(jlwe.key_switch, static_argnums=(0, 3))
j_mod_switch = jax.jit(jlwe.mod_switch, static_argnums=(1,))
j_switch_ct_to_qn = jax.jit(jlwe.switch_ct_to_qn, static_argnums=(0,))


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _eq_ct(jct, tct):
    assert (jct.modulus, jct.pt_mod) == (tct.modulus, tct.pt_mod)
    _eq(jct.a, tct.a)
    _eq(jct.b, tct.b)


def _keys(name, seed, n=None, N=None):
    """(params, sk, sk_n) for both packages from one seed."""
    jp, tp = j_make_params(name), t_make_params(name)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jsk = jlwe.keygen(jp, jr, dim=n)
    tsk = tlwe.keygen(tp, tr, dim=n, device="cpu")
    jskn = jlwe.keygen(jp, jr, dim=N or jp.N)
    tskn = tlwe.keygen(tp, tr, dim=N or tp.N, device="cpu")
    return jp, tp, jsk, tsk, jskn, tskn


@pytest.mark.parametrize("name", ["TOY", "STD128"])
def test_keygen_same_seed(name):
    _, _, jsk, tsk, jskn, tskn = _keys(name, 11)
    assert tsk.s.dtype == torch.int32
    _eq(jsk.s, tsk.s)
    _eq(jskn.s, tskn.s)


@pytest.mark.parametrize("name,p", [("TOY", 4), ("STD128", 4), ("TOY", 8)])
def test_encrypt_decrypt_same_seed(name, p):
    jp, tp, jsk, tsk, _, _ = _keys(name, 12)
    m = np.random.default_rng(1).integers(0, p, size=64)
    jct = jlwe.encrypt(jp, jsk, m, np.random.default_rng(5), p=p)
    tct = tlwe.encrypt(tp, tsk, m, np.random.default_rng(5), p=p)
    _eq_ct(jct, tct)
    got = tlwe.decrypt(tp, tsk, tct)
    _eq(jlwe.decrypt(jp, jsk, jct), got)
    np.testing.assert_array_equal(got.numpy(), m)


def test_not_and_add_match(rng):
    jp, tp, jsk, tsk, _, _ = _keys("TOY", 13)
    m1, m2 = rng.integers(0, 2, size=32), rng.integers(0, 2, size=32)
    cts = []
    for m in (m1, m2):
        cts.append((jlwe.encrypt(jp, jsk, m, np.random.default_rng(3)),
                    tlwe.encrypt(tp, tsk, m, np.random.default_rng(3))))
    _eq_ct(jlwe.not_(cts[0][0]), tlwe.not_(cts[0][1]))
    _eq_ct(jlwe.add(cts[0][0], cts[1][0]), tlwe.add(cts[0][1], cts[1][1]))
    np.testing.assert_array_equal(tlwe.decrypt(tp, tsk, tlwe.not_(cts[0][1])).numpy(), 1 - m1)


@pytest.mark.parametrize("name,to", [("TOY", "q"), ("STD128", "q_ks"), ("STD128", "q")])
def test_mod_switch_matches(name, to, rng):
    jp, tp = j_make_params(name), t_make_params(name)
    Q = jp.Q
    a = rng.integers(0, Q, size=(16, jp.N)).astype(np.uint32)
    b = rng.integers(0, Q, size=16).astype(np.uint32)
    q_to = getattr(jp, to)
    jct = j_mod_switch(jlwe.LweCiphertext(a=jnp.asarray(a), b=jnp.asarray(b), modulus=Q), q_to)
    tct = tlwe.mod_switch(convert.ciphertext(a, b, Q, device="cpu"), q_to)
    _eq_ct(jct, tct)


CASES = [("TOY", None, None), ("STD128", 32, 64)]


@pytest.mark.parametrize("name,n,N", CASES)
def test_key_switch_gen_same_seed(name, n, N):
    jp, tp, jsk, tsk, jskn, tskn = _keys(name, 14, n, N)
    jk = jlwe.key_switch_gen(jp, jsk, jskn, np.random.default_rng(8))
    tk = tlwe.key_switch_gen(tp, tsk, tskn, np.random.default_rng(8))
    assert tk.a.shape == (N or jp.N, jp.digits_ks, jp.base_ks, n or jp.n)
    _eq(jk.a, tk.a)
    _eq(jk.b, tk.b)


@pytest.mark.parametrize("name,n,N", CASES)
def test_key_switch_matches_gather(name, n, N, rng, monkeypatch):
    jp, tp, jsk, tsk, jskn, tskn = _keys(name, 15, n, N)
    jk = jlwe.key_switch_gen(jp, jsk, jskn, np.random.default_rng(9))
    tk = tlwe.key_switch_gen(tp, tsk, tskn, np.random.default_rng(9))
    m = rng.integers(0, 4, size=10)
    jct = jlwe.encrypt(jp, jskn, m, np.random.default_rng(4), modulus=jp.q_ks)
    tct = tlwe.encrypt(tp, tskn, m, np.random.default_rng(4), modulus=tp.q_ks)
    want = j_key_switch(jp, jk, jct, "gather")
    _eq_ct(want, tlwe.key_switch(tp, tk, tct))
    # room for 3 int32 rows of gathered keys: the batch of 10 runs in 4
    # chunks (STD128, summed in int32) or 10 (TOY, widened to int64)
    row_bytes = tct.a.shape[-1] * tp.digits_ks * tk.a.shape[-1] * 4
    monkeypatch.setattr(tlwe, "KS_CHUNK_BYTES", 3 * row_bytes)
    got = tlwe.key_switch(tp, tk, tct)
    _eq_ct(want, got)
    np.testing.assert_array_equal(tlwe.decrypt(tp, tsk, got).numpy(), m)


def test_switch_ct_to_qn_std128_matches(rng):
    """STD128: every switch is inside fhe_tpu's exact range, so the whole
    ModSwitch -> KeySwitch -> ModSwitch chain is byte-equal."""
    jp, tp, jsk, tsk, jskn, tskn = _keys("STD128", 16, 32, 64)
    jk = jlwe.key_switch_gen(jp, jsk, jskn, np.random.default_rng(10))
    tk = tlwe.key_switch_gen(tp, tsk, tskn, np.random.default_rng(10))
    m = rng.integers(0, 4, size=10)
    jct = jlwe.encrypt(jp, jskn, m, np.random.default_rng(6), modulus=jp.Q)
    tct = tlwe.encrypt(tp, tskn, m, np.random.default_rng(6), modulus=tp.Q)
    out = tlwe.switch_ct_to_qn(tp, tk, tct)
    _eq_ct(j_switch_ct_to_qn(jp, jk, jct), out)
    assert out.modulus == tp.q and out.n == 32
    np.testing.assert_array_equal(tlwe.decrypt(tp, tsk, out).numpy(), m)


def test_switch_ct_to_qn_toy_is_exact(rng):
    """TOY (q_ks == Q): the first mod switch is the identity, which the port
    computes exactly; the rest of the chain is byte-equal to fhe_tpu's
    key switch + mod switch."""
    jp, tp, jsk, tsk, jskn, tskn = _keys("TOY", 17)
    jk = jlwe.key_switch_gen(jp, jsk, jskn, np.random.default_rng(11))
    tk = tlwe.key_switch_gen(tp, tsk, tskn, np.random.default_rng(11))
    m = rng.integers(0, 4, size=10)
    jct = jlwe.encrypt(jp, jskn, m, np.random.default_rng(7), modulus=jp.Q)
    tct = tlwe.encrypt(tp, tskn, m, np.random.default_rng(7), modulus=tp.Q)
    out = tlwe.switch_ct_to_qn(tp, tk, tct)
    want = j_mod_switch(j_key_switch(jp, jk, jct, "gather"), jp.q)
    _eq_ct(want, out)
    np.testing.assert_array_equal(tlwe.decrypt(tp, tsk, out).numpy(), m)


def test_key_switch_rejects_wrong_modulus():
    tp = t_make_params("TOY")
    ct = tlwe.LweCiphertext(a=torch.zeros(2, tp.N, dtype=torch.int32),
                            b=torch.zeros(2, dtype=torch.int32), modulus=tp.q)
    ksk = tlwe.LweSwitchingKey(a=torch.zeros(1), b=torch.zeros(1))
    with pytest.raises(ValueError):
        tlwe.key_switch(tp, ksk, ct)
