"""fhe_tpu_torch's 2-limb RNS ring (lattice/rns.py, tfhe/rgsw_rns.py)
against fhe_tpu on the CPU, byte for byte, at TOY_RNS width (N = 1024,
L = 2, dG2 = 4), and against Python integers where fhe_tpu is wrong.

fhe_tpu's key is made with n cut to 4 and its RNS NTTs and modular
products jitted (the same exact integer ops, compiled once per shape
instead of op by op);
its rotation, digit split, external product, monomials and extraction run
jitted.  The port runs with device="cpu", where every NTT is the plain
per-limb loop; its gates run at full TOY_RNS width (n = 64) on the port
alone, against truth tables on random bit vectors.

fhe_tpu is wrong on STD128Q_3 and STD128Q_4 (ROADMAP.md queue 3): its
digit split adds the offset sum_t (Bg/2) Bg^t = 2^24 + 2^49 + 2^74 in
64 bits, and its mod switch Q -> q_ks multiplies in uint64 where Q q_ks
has 66 and 67 bits.  There the port is held to Python integers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.tfhe import BinFheContext as JContext
from fhe_tpu.tfhe import lwe as j_lwe
from fhe_tpu.tfhe import rgsw_rns as j_rr
from fhe_tpu.tfhe.params import make_params as j_make_params
from fhe_tpu_torch import convert
from fhe_tpu_torch.kernels import ntt as kntt
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import ntt as t_ntt
from fhe_tpu_torch.math import primes
from fhe_tpu_torch.parallel import BatchFlags, eval_bin_gate_batch
from fhe_tpu_torch.tfhe import BinFheContext, Gate, RnsKey, make_params, rgsw_rns

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

EXACT = ["TOY_RNS", "STD192", "STD192_4", "STD192Q", "STD192Q_3"]
FAULTY = ["STD128Q_3", "STD128Q_4"]
TRUTH = {"NAND": lambda a, b: 1 - (a & b), "XOR": lambda a, b: a ^ b}


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _jit_per_plan(fn, rows=32):
    """fn(plan, x) on x [..., L, N], jitted once per RNS plan: x runs as
    [rows, L, N] blocks (zero rows pad the last), so every shape of a test
    shares one compiled transform."""
    cache = {}

    def call(plan, x, impl=None):
        key = (plan.N, plan.moduli)
        if key not in cache:
            cache[key] = jax.jit(functools.partial(fn, plan))
        flat = jnp.reshape(x, (-1,) + x.shape[-2:])
        pad = jnp.pad(flat, ((0, -flat.shape[0] % rows), (0, 0), (0, 0)))
        out = [cache[key](pad[i:i + rows]) for i in range(0, pad.shape[0], rows)]
        return jnp.concatenate(out)[:flat.shape[0]].reshape(x.shape)
    return call


j_forward = _jit_per_plan(j_rns.ntt_forward)
j_inverse = _jit_per_plan(j_rns.ntt_inverse)


@functools.lru_cache(maxsize=None)
def _jit(fn, params):
    return jax.jit(functools.partial(fn, params))


@pytest.fixture
def jitted(monkeypatch):
    """fhe_tpu's RNS NTTs, key switch and mod switch jitted while a test runs."""
    monkeypatch.setattr(j_rns, "ntt_forward", j_forward)
    monkeypatch.setattr(j_rns, "ntt_inverse", j_inverse)
    monkeypatch.setattr(j_lwe, "key_switch", jax.jit(j_lwe.key_switch, static_argnums=(0,)))
    monkeypatch.setattr(j_lwe, "mod_switch", jax.jit(j_lwe.mod_switch, static_argnums=(1,)))


def _residues(p, rng, lead):
    """Random residues [*lead, L, N] of the set's limbs, numpy int64."""
    return np.stack([rng.integers(0, q, size=lead + (p.N,)) for q in p.moduli_rns], axis=-2)


def _coefficients(p, rng, count):
    """count coefficients in [0, Q): the edges 0, 1, Q/2 - 1, Q/2, Q - 1 and
    random ones, as Python ints and as residues [2, L, count / 2]."""
    Q = p.Q
    v = [0, 1, Q // 2 - 1, Q // 2, Q // 2 + 1, Q - 1]
    v += [int(x) for x in rng.integers(0, Q, size=count - len(v))]
    res = np.array([[x % q for x in v] for q in p.moduli_rns], dtype=np.int64)   # [L, count]
    return v, res.reshape(len(p.moduli_rns), 2, -1).transpose(1, 0, 2)


@pytest.fixture(scope="module")
def keys():
    """fhe_tpu's and the port's TOY_RNS contexts (n cut to 4), secret keys
    and bootstrap keys, each from the same seeds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rns, "ntt_forward", j_forward)
        for name in ("mont_mul", "add_mod"):
            mp.setattr(j_rr, name, jax.jit(getattr(j_rr, name)))
        jc = JContext(params=dataclasses.replace(j_make_params("TOY_RNS"), n=4))
        tc = BinFheContext(params=dataclasses.replace(make_params("TOY_RNS"), n=4),
                           device=torch.device("cpu"))
        jsk, tsk = jc.key_gen(11), tc.key_gen(11)
        return jc, tc, jsk, tsk, jc.bt_key_gen(jsk, 12), tc.bt_key_gen(tsk, 12)


@pytest.fixture(scope="module")
def toy_rns():
    """The port's full TOY_RNS context, secret key and RnsKey."""
    tc = BinFheContext.generate("TOY_RNS", device="cpu")
    sk = tc.key_gen(21)
    return tc, sk, tc.bt_key_gen(sk, 22)


def test_keys_match_fhe_tpu(keys):
    _, tc, jsk, tsk, jkey, tkey = keys
    p = tc.params
    assert isinstance(tkey, RnsKey)
    assert tkey.bsk.shape == (4, 2, p.digits_g2, 2, 2, p.N) == (4, 2, 4, 2, 2, 1024)
    assert tkey.bsk.dtype == torch.int32
    _eq(jsk.s, tsk.s)
    _eq(jkey.bsk, tkey.bsk)
    _eq(jkey.ksk.a, tkey.ksk.a)
    _eq(jkey.ksk.b, tkey.ksk.b)


def test_converted_key_equals_port_key(keys):
    *_, jkey, tkey = keys
    ckey = convert.rns_bootstrap_key(np.asarray(jkey.bsk), np.asarray(jkey.ksk.a),
                                     np.asarray(jkey.ksk.b), device="cpu")
    assert isinstance(ckey, RnsKey)
    for got, want in [(ckey.bsk, tkey.bsk), (ckey.ksk.a, tkey.ksk.a), (ckey.ksk.b, tkey.ksk.b)]:
        assert got.dtype == torch.int32
        _same(got, want)
    with pytest.raises(ValueError, match="L, N"):
        convert.rns_bootstrap_key(np.asarray(jkey.bsk)[..., 0, :], np.asarray(jkey.ksk.a),
                                  np.asarray(jkey.ksk.b), device="cpu")


@pytest.mark.parametrize("name", ["TOY_RNS", "STD128Q_3"])
def test_limb_stacked_ntt_matches_fhe_tpu(name):
    """The plain limb-stacked NTT (the kernels' plain version on the card)
    against rns.ntt_forward / ntt_inverse, and the round trip."""
    p = make_params(name)
    x = _residues(p, np.random.default_rng(1), (3, 2))
    jplan = j_rns.make_rns_plan(p.N, tuple(p.moduli_rns))
    plan = rns.make_rns_plan(p.N, p.moduli_rns)
    assert plan.L == 2 and tuple(plan.fwd_w.shape) == (2, p.N)
    tx = torch.from_numpy(x).to(torch.int32)
    f = rns.ntt_forward(plan, tx)
    assert f.dtype == torch.int32 and f.shape == tx.shape
    _eq(j_forward(jplan, jnp.asarray(x.astype(np.uint32))), f)
    _eq(j_inverse(jplan, jnp.asarray(x.astype(np.uint32))), rns.ntt_inverse(plan, tx))
    _same(rns.ntt_inverse(plan, f), tx)


def test_limb_stacked_ntt_checks():
    """A wrong limb axis raises on every device; more limbs than the
    kernels take raises from their check, without a card."""
    plan = rns.make_rns_plan(1024, make_params("TOY_RNS").moduli_rns)
    with pytest.raises(ValueError, match=r"\[\.\.\., 2, 1024\]"):
        rns.ntt_forward(plan, torch.zeros(3, 1024, dtype=torch.int32))
    moduli = primes.ntt_primes(65, 1024, 1 << 30)
    assert kntt.max_limbs() == 64
    kntt.check_limbs(rns.make_rns_plan(1024, moduli[:64]))
    with pytest.raises(ValueError, match="1 to 64 limbs, got 65"):
        kntt.check_limbs(rns.make_rns_plan(1024, moduli))


@pytest.mark.parametrize("name", EXACT)
def test_digits_match_fhe_tpu(name):
    """The digit split on random coefficients and the centring's edges,
    where fhe_tpu's 64-bit closed form is exact."""
    p = make_params(name)
    _, res = _coefficients(p, np.random.default_rng(2), 2 * p.N)
    want = _jit(j_rr.signed_digit_decompose_rns, j_make_params(name))(
        jnp.asarray(res.astype(np.uint32)))
    got = rgsw_rns.signed_digit_decompose_rns(p, torch.from_numpy(res))
    assert got.shape == (p.digits_g2, p.N)
    _eq(want, got)


def _python_digits(p, v: int) -> list[int]:
    """The closed-form balanced digits 1..dG-1 of v in [0, Q), in Python
    integers: u = centred v + sum_t (Bg/2) Bg^t."""
    bg, dgt = p.base_g, p.digits_g
    g = bg.bit_length() - 1
    d = v - p.Q if v >= p.Q // 2 else v
    u = d + sum((bg >> 1) << (g * t) for t in range(dgt))
    return [((u >> (g * t)) & (bg - 1)) - (bg >> 1) for t in range(1, dgt)]


def _digit_rows(p, digits, count):
    """[dG2, count / 2] digit rows (r = 2 (t - 1) + poly) -> [count, dG - 1]."""
    half = count // 2
    return [[int(digits[2 * (t - 1) + i // half, i % half]) for t in range(1, p.digits_g)]
            for i in range(count)]


@pytest.mark.parametrize("name", FAULTY)
def test_digits_exact_where_fhe_tpu_wraps(name):
    """STD128Q_3/_4 (Bg = 2^25, dG = 3): the port's digits equal Python
    integers' and rebuild each coefficient within Bg/2; fhe_tpu's top digit
    is wrong on every coefficient, the others right (ROADMAP.md queue 3)."""
    p = make_params(name)
    count = 64
    v, res = _coefficients(p, np.random.default_rng(3), count)
    got = _digit_rows(p, rgsw_rns.signed_digit_decompose_rns(p, torch.from_numpy(res)), count)
    want = [_python_digits(p, x) for x in v]
    assert got == want
    bg, g = p.base_g, p.base_g.bit_length() - 1
    for x, digits in zip(v, got):
        d = x - p.Q if x >= p.Q // 2 else x
        assert all(-bg // 2 <= t < bg // 2 for t in digits)
        assert abs(d - sum(t << (g * (k + 1)) for k, t in enumerate(digits))) <= bg // 2
    theirs = _digit_rows(p, np.asarray(_jit(j_rr.signed_digit_decompose_rns, j_make_params(name))(
        jnp.asarray(res.astype(np.int64).astype(np.uint32)))), count)
    assert [t[:-1] for t in theirs] == [w[:-1] for w in want]
    assert all(t[-1] != w[-1] for t, w in zip(theirs, want))


@pytest.mark.parametrize("name", FAULTY + ["STD192"])
def test_mod_switch_is_exact(name):
    """switch_to_qks against Python integers, round(v q_ks / Q) mod q_ks,
    on the edges and 4096 random v in [0, Q)."""
    p = make_params(name)
    rng = np.random.default_rng(4)
    v = [0, 1, p.Q // 2, p.Q - 1] + [int(x) for x in rng.integers(0, p.Q, size=4092)]
    got = rgsw_rns.switch_to_qks(p, torch.tensor(v, dtype=torch.int64))
    assert got.tolist() == [(x * p.q_ks + p.Q // 2) // p.Q % p.q_ks for x in v]


def _python_extract(p, acc: np.ndarray, b_offset: int):
    """Sample extraction and the mod switch to q_ks in Python integers, on
    fhe_tpu's inverse NTT: (a [B, N], b [B])."""
    both = np.stack([acc[:, 0, :, ::-1], acc[:, 1]], axis=1)
    plan = j_rns.make_rns_plan(p.N, tuple(p.moduli_rns))
    coef = np.asarray(j_inverse(plan, jnp.asarray(both.astype(np.uint32)))).astype(object)
    q1, q2 = p.moduli_rns
    v = coef[:, :, 0] + q1 * ((coef[:, :, 1] - coef[:, :, 0]) * pow(q1, -1, q2) % q2)
    ms = lambda x: (x * p.q_ks + p.Q // 2) // p.Q % p.q_ks
    return ms(v[:, 0]), ms((v[:, 1, 0] + b_offset) % p.Q)


@pytest.mark.parametrize("name", FAULTY)
def test_extraction_exact_where_fhe_tpu_wraps(name, jitted, monkeypatch):
    """STD128Q_3/_4: the port's extraction and switch to q_ks equal Python
    integers'; fhe_tpu's (its key switch and last mod switch left out)
    switch most coefficients wrong."""
    p, jp = make_params(name), j_make_params(name)
    acc = _residues(p, np.random.default_rng(5), (2, 2))
    offset = p.Q // 8 + 1
    want_a, want_b = _python_extract(p, acc, offset)
    ct = rgsw_rns.extract_switch_rns(p, torch.from_numpy(acc).to(torch.int32), offset)
    assert ct.modulus == p.q_ks
    assert ct.a.tolist() == want_a.tolist() and ct.b.tolist() == want_b.tolist()
    monkeypatch.setattr(j_lwe, "key_switch", lambda params, ksk, c: c)
    monkeypatch.setattr(j_lwe, "mod_switch", lambda c, q: c)
    theirs = j_rr._extract_and_switch(jp, jnp.asarray(acc.astype(np.uint32)), offset, None, 4)
    assert (np.asarray(theirs.a).astype(np.int64) != want_a.astype(np.int64)).mean() > 0.5


def test_external_product_and_monomials_match_fhe_tpu(keys):
    """external_product_rns on the key's first step (both signs) and
    monomial_pair_rns on every index class, against fhe_tpu's."""
    jc, tc, *_, jkey, tkey = keys
    p, jp = tc.params, jc.params
    rng = np.random.default_rng(6)
    d = _residues(p, rng, (3, p.digits_g2))
    want = [_jit(j_rr.external_product_rns, jp)(jnp.asarray(d.astype(np.uint32)), jkey.bsk[0, s])
            for s in range(2)]
    got = rgsw_rns.external_product_rns(p, torch.from_numpy(d).to(torch.int32)[:, None],
                                        tkey.bsk[0])
    assert got.shape == (3, 2, 2, 2, p.N)
    for s in range(2):
        _eq(want[s], got[:, s])
    idx = np.array([0, 1, 2, p.N - 1, p.N, p.N + 1, 2 * p.N - 1], dtype=np.int64)
    want = _jit(j_rr.monomial_pair_rns, jp)(jnp.asarray(idx.astype(np.uint32)))
    got = rgsw_rns.monomial_pair_rns(p, torch.from_numpy(idx))
    for w, g in zip(want, got):
        assert g.shape == (7, 2, p.N)
        _eq(w, g)


def test_blind_rotation_matches_fhe_tpu(keys):
    """fhe_tpu's jitted 4-step blind_rotate_rns on its key, and the port's on
    the key carried over by convert."""
    jc, tc, *_, jkey, _ = keys
    p = tc.params
    ckey = convert.rns_bootstrap_key(np.asarray(jkey.bsk), np.asarray(jkey.ksk.a),
                                     np.asarray(jkey.ksk.b), device="cpu")
    rng = np.random.default_rng(7)
    acc = _residues(p, rng, (3, 2))
    a = rng.integers(0, p.q, size=(3, p.n))
    a[0, 1] = 0
    want = _jit(j_rr.blind_rotate_rns, jc.params)(jkey.bsk, jnp.asarray(acc.astype(np.uint32)),
                                                   jnp.asarray(a.astype(np.uint32)))
    got = rgsw_rns.blind_rotate_rns(p, ckey.bsk, torch.from_numpy(acc).to(torch.int32),
                                    torch.from_numpy(a).to(torch.int32))
    assert got.dtype == torch.int32
    _eq(want, got)


def test_extraction_matches_fhe_tpu(keys, jitted):
    """_extract_and_switch on a fixed accumulator, with the key's switching
    key: extraction, exact switch to q_ks, key switch, switch to q."""
    jc, tc, *_, jkey, tkey = keys
    p = tc.params
    acc = _residues(p, np.random.default_rng(8), (3, 2))
    offset = p.Q // 8 + 1
    want = j_rr._extract_and_switch(jc.params, jnp.asarray(acc.astype(np.uint32)), offset,
                                    jkey.ksk, 4)
    got = rgsw_rns._extract_and_switch(p, torch.from_numpy(acc).to(torch.int32), offset,
                                       tkey.ksk, 4)
    assert (got.modulus, got.n) == (p.q, p.n) == (want.modulus, want.a.shape[-1])
    _eq(want.a, got.a)
    _eq(want.b, got.b)


def test_gate_test_vector_matches_fhe_tpu():
    p = make_params("TOY_RNS")
    b = np.random.default_rng(9).integers(0, p.q, size=16)
    for gate in (Gate.AND, Gate.XOR):
        want = j_rr._gate_test_vector_rns(j_make_params("TOY_RNS"), b, gate)
        _eq(want, rgsw_rns._gate_test_vector_rns(p, torch.from_numpy(b), gate))


def _counting(monkeypatch):
    """Count the gate's limb-stacked NTTs (kernels 1-2 on the card) and
    refuse the single-modulus NTT entries."""
    counts = {"forward": 0, "inverse": 0}
    for what in counts:
        fn = getattr(rns, f"ntt_{what}")

        def counted(*args, _fn=fn, _what=what):
            counts[_what] += 1
            return _fn(*args)
        monkeypatch.setattr(rns, f"ntt_{what}", counted)

        def refuse(*args, _what=what, **kw):
            raise AssertionError(f"single-modulus ntt_{_what} on the RNS path")
        monkeypatch.setattr(t_ntt, f"ntt_{what}", refuse)
    return counts


def _all_inputs(rng, k):
    """The 2^k input combinations of a k-input gate, in random order: k bit
    vectors of length 2^k."""
    rows = rng.permutation(1 << k)
    return [(rows >> b) & 1 for b in range(k)]


@pytest.mark.parametrize("gate", list(TRUTH))
def test_gate_truth_tables(toy_rns, gate, monkeypatch):
    """Full TOY_RNS (n = 64): each gate on its whole truth table, in random
    order, through the context, with n + 1 limb-stacked forward and n + 1
    inverse NTTs and no single-modulus NTT."""
    tc, sk, key = toy_rns
    rng = np.random.default_rng(10)
    m1, m2 = _all_inputs(rng, 2)
    ct1, ct2 = tc.encrypt(sk, m1, rng), tc.encrypt(sk, m2, rng)
    counts = _counting(monkeypatch)
    out = tc.eval_bin_gate(key, gate, ct1, ct2)
    assert (out.n, out.modulus) == (tc.params.n, tc.params.q)
    np.testing.assert_array_equal(tc.decrypt(sk, out).numpy(), TRUTH[gate](m1, m2))
    n = tc.params.n
    assert counts == {"forward": n + 1, "inverse": n + 1}


def test_cmux_and_batch_api(toy_rns):
    """CMUX (three NANDs) and the batch API's ASYNC AND (the AND's truth
    table), the latter with ntt_impl="fused", which the RNS path ignores,
    as fhe_tpu's does."""
    tc, sk, key = toy_rns
    rng = np.random.default_rng(11)
    m0, m1, sel = _all_inputs(rng, 3)
    ct0, ct1, cs = (tc.encrypt(sk, m, rng) for m in (m0, m1, sel))
    out = tc.eval_cmux(key, ct0, ct1, cs)
    np.testing.assert_array_equal(tc.decrypt(sk, out).numpy(), np.where(sel == 1, m1, m0))
    ctx = dataclasses.replace(tc, ntt_impl="fused")
    fut, res = eval_bin_gate_batch(ctx, key, "AND", ct0, ct1, BatchFlags.ASYNC)
    assert res.success and res.processed == 8
    np.testing.assert_array_equal(tc.decrypt(sk, fut.result()).numpy(), m0 & m1)


def test_what_has_no_rns_path_raises_a_named_error(toy_rns):
    """bootstrap, multi-input gates, extended=True and method AP on an RNS
    set: ValueError naming the set, before any work."""
    tc, sk, key = toy_rns
    ct = tc.encrypt(sk, np.array([0, 1]), 12)
    match = r"^TOY_RNS: .* no path on the 2-limb RNS ring"
    with pytest.raises(ValueError, match=match):
        tc.bootstrap(key, ct)
    with pytest.raises(ValueError, match=match):
        tc.eval_bin_gate_multi(key, Gate.AND3, [ct, ct, ct])
    with pytest.raises(ValueError, match=match):
        tc.eval_bin_gate(key, Gate.AND, ct, ct, extended=True)
    ap = BinFheContext.generate("STD192", method="AP", device="cpu")
    with pytest.raises(ValueError, match=r"^STD192: method AP has no path"):
        ap.bt_key_gen(ap.key_gen(0))
    wide = dataclasses.replace(ct, modulus=tc.params.q_ks)
    with pytest.raises(ValueError, match="mod q = 1024"):
        tc.eval_bin_gate(key, Gate.AND, wide, ct)
