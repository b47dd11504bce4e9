"""fhe_tpu_torch.tfhe.acc, the DM/AP and LMKCDEY accumulators, against
fhe_tpu on the CPU, byte for byte, at full TOY width (TOY with method AP:
N = 512, n = 64, dR = 2, Br - 1 = 22; TOY_LMKCDEY: N = 512, n = 64, w = 9).

fhe_tpu's keys are made with its NTT and Montgomery conversion jitted (the
same exact integer ops, compiled once per shape instead of op by op); its
rotations run through its jitted functions, never its eager LMKCDEY loop.  The port runs with device="cpu", where every NTT is
the plain version; the gates run on the port alone, against truth tables
on random bit vectors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.math import ntt as j_ntt
from fhe_tpu.tfhe import BinFheContext as JContext
from fhe_tpu.tfhe import acc as j_acc
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu_torch import convert
from fhe_tpu_torch.math import ntt as t_ntt
from fhe_tpu_torch.math import primes
from fhe_tpu_torch.parallel import BatchFlags, eval_bin_gate_batch
from fhe_tpu_torch.tfhe import BinFheContext, DmKey, Gate, LmkcdeyKey, acc, make_params, rgsw

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

SETS = {"AP": ("TOY", "AP"), "LMKCDEY": ("TOY_LMKCDEY", None)}
TRUTH = {
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "XOR": lambda a, b: a ^ b,
    "NAND": lambda a, b: 1 - (a & b),
}
j_blind_rotate_dm = jax.jit(j_acc.blind_rotate_dm, static_argnums=(0,))


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _same_ct(got, want):
    torch.testing.assert_close(got.a, want.a, rtol=0, atol=0)
    torch.testing.assert_close(got.b, want.b, rtol=0, atol=0)


def _jit_per_plan(fn):
    """fn(plan, x, ...) jitted once per (N, q) and keyword arguments."""
    cache = {}

    def call(plan, x, *args, **kw):
        key = (plan.N, plan.q, args, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jax.jit(functools.partial(fn, plan, *args, **kw))
        return cache[key](x)
    return call


@pytest.fixture(scope="module")
def keys():
    """Per method: fhe_tpu's and the port's TOY contexts, secret keys and
    bootstrap keys, each from the same seeds."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ntt, "ntt_forward", _jit_per_plan(j_ntt.ntt_forward))
        mp.setattr(j_ntt, "to_mont", _jit_per_plan(j_ntt.to_mont))
        for method, (name, m) in SETS.items():
            jc = JContext.generate(name, method=m)
            tc = BinFheContext.generate(name, method=m, device="cpu")
            jsk, tsk = jc.key_gen(11), tc.key_gen(11)
            out[method] = (jc, tc, jsk, tsk, jc.bt_key_gen(jsk, 12), tc.bt_key_gen(tsk, 12))
    return out


def test_dm_keys_match_fhe_tpu(keys):
    _, tc, jsk, tsk, jkey, tkey = keys["AP"]
    p = tc.params
    assert isinstance(tkey, DmKey)
    assert tkey.bsk.shape == (p.n * p.digits_r, p.base_r - 1, p.digits_g2, 2, p.N) == (
        128, 22, 4, 2, 512)
    assert tkey.bsk.dtype == torch.int32
    _eq(jsk.s, tsk.s)
    _eq(jkey.bsk, tkey.bsk)
    _eq(jkey.ksk.a, tkey.ksk.a)
    _eq(jkey.ksk.b, tkey.ksk.b)


def test_lmkcdey_keys_match_fhe_tpu(keys):
    _, tc, jsk, tsk, jkey, tkey = keys["LMKCDEY"]
    p = tc.params
    assert isinstance(tkey, LmkcdeyKey)
    assert tkey.rgsw.shape == (p.n, p.digits_g2, 2, p.N)
    assert tkey.auto.shape == (p.num_auto_keys + 1, p.digits_g - 1, 2, p.N)
    _eq(jsk.s, tsk.s)
    _eq(jkey.rgsw, tkey.rgsw)
    _eq(jkey.auto, tkey.auto)
    _eq(jkey.ksk.a, tkey.ksk.a)
    _eq(jkey.ksk.b, tkey.ksk.b)


def test_converted_keys_equal_port_keys(keys):
    *_, jkey, tkey = keys["AP"]
    ckey = convert.dm_key(np.asarray(jkey.bsk), np.asarray(jkey.ksk.a), np.asarray(jkey.ksk.b),
                          device="cpu")
    torch.testing.assert_close(ckey.bsk, tkey.bsk, rtol=0, atol=0)
    *_, jkey, tkey = keys["LMKCDEY"]
    ckey = convert.lmkcdey_key(np.asarray(jkey.rgsw), np.asarray(jkey.auto),
                               np.asarray(jkey.ksk.a), np.asarray(jkey.ksk.b), device="cpu")
    for got, want in [(ckey.rgsw, tkey.rgsw), (ckey.auto, tkey.auto), (ckey.ksk.a, tkey.ksk.a)]:
        assert got.dtype == torch.int32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["TOY_LMKCDEY", "STD128_LMKCDEY"])
def test_schedule_matches_fhe_tpu(name):
    """lmk_schedule (host numpy) on 16 random masks, and one all-zero."""
    p = make_params(name)
    a = np.random.default_rng(7).integers(0, p.q, size=(17, p.n))
    a[5] = 0
    got, want = acc.lmk_schedule(p, a), j_acc.lmk_schedule(p, a)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(acc._lmk_perm_table(p), j_acc._lmk_perm_table(p))


@pytest.mark.parametrize("name", ["TOY_LMKCDEY", "STD128_LMKCDEY", "STD256_3_LMKCDEY"])
def test_sdd_single_matches_both_fhe_tpu_forms(name):
    """The one torch decomposition equals fhe_tpu's sequential-borrow
    _sdd_single (numpy) and its closed-form _sdd_single_jnp (int32).  At
    STD256_3_LMKCDEY (Bg = 256, dG = 4) the closed form's offset,
    2,155,905,152, does not fit fhe_tpu's int32 and _sdd_single_jnp raises
    OverflowError (ROADMAP.md queue 3): there only the sequential form is
    the reference."""
    p = make_params(name)
    c = np.random.default_rng(8).integers(0, p.Q, size=(3, p.N))
    c[0, :4] = [0, p.Q - 1, p.Q >> 1, (p.Q >> 1) - 1]
    got = acc.sdd_single(p, torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), np.stack([j_acc._sdd_single(p, r) for r in c]))
    g_bits = p.base_g.bit_length() - 1
    if sum((p.base_g >> 1) << (g_bits * t) for t in range(p.digits_g)) < 2**31:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_acc._sdd_single_jnp(p, jnp.asarray(c.astype(np.uint32)))))


def _rotation_inputs(p):
    """acc [3, 2, N] random residues mod Q, a [3, n] mod q with row 1 all zero."""
    rng = np.random.default_rng(9)
    acc0 = rng.integers(0, p.Q, size=(3, 2, p.N)).astype(np.uint32)
    a = rng.integers(0, p.q, size=(3, p.n)).astype(np.uint32)
    a[1] = 0
    return acc0, a


def _no_plain_digit_ntt(monkeypatch):
    """acc must run its digit NTTs through math.ntt.ntt_forward (kernel 1 on
    the card), never through rgsw.ntt_signed_digits, the plain version."""
    def refuse(*args):
        raise AssertionError("rgsw.ntt_signed_digits called from acc")
    monkeypatch.setattr(rgsw, "ntt_signed_digits", refuse)


def test_blind_rotate_dm_matches_fhe_tpu(keys, monkeypatch):
    jc, tc, *_, jkey, _ = keys["AP"]
    ckey = convert.dm_key(np.asarray(jkey.bsk), np.asarray(jkey.ksk.a), np.asarray(jkey.ksk.b),
                          device="cpu")
    acc0, a = _rotation_inputs(tc.params)
    want = j_blind_rotate_dm(jc.params, jkey.bsk, jnp.asarray(acc0), jnp.asarray(a))
    _no_plain_digit_ntt(monkeypatch)
    got = acc.blind_rotate_dm(tc.params, ckey.bsk, torch.from_numpy(acc0.astype(np.int32)),
                              torch.from_numpy(a.astype(np.int32)))
    assert got.dtype == torch.int32
    _eq(want, got)


def test_blind_rotate_lmkcdey_matches_fhe_tpu(keys, monkeypatch):
    """The port's scan and its per-ciphertext anchor against fhe_tpu's scan."""
    jc, tc, *_, jkey, _ = keys["LMKCDEY"]
    ckey = convert.lmkcdey_key(np.asarray(jkey.rgsw), np.asarray(jkey.auto),
                               np.asarray(jkey.ksk.a), np.asarray(jkey.ksk.b), device="cpu")
    acc0, a = _rotation_inputs(tc.params)
    want = j_acc.blind_rotate_lmkcdey_scan(jc.params, jkey.rgsw, jkey.auto, jnp.asarray(acc0), a)
    _no_plain_digit_ntt(monkeypatch)
    t_acc0 = torch.from_numpy(acc0.astype(np.int32))
    got = acc.blind_rotate_lmkcdey_scan(tc.params, ckey.rgsw, ckey.auto, t_acc0, a)
    assert got.dtype == torch.int32
    _eq(want, got)
    _eq(want, acc.blind_rotate_lmkcdey(tc.params, ckey.rgsw, ckey.auto, t_acc0, a))


@pytest.mark.parametrize("bits", [28, 31])
def test_key_product_is_the_montgomery_external_product(bits):
    """acc's one-reduction product with one key per ciphertext has the
    residue of rgsw.external_product's dG2 Montgomery products, also where
    dG2 (q-1)^2 passes 2^63 (31-bit q) and the products reduce first."""
    rng = np.random.default_rng(16)
    N, dg2 = 512, 4
    plan = t_ntt.make_plan(N, primes.last_prime(bits, 2 * N), "cpu")
    d_eval = torch.from_numpy(rng.integers(0, plan.q, size=(3, dg2, N))).to(torch.int32)
    keys = torch.from_numpy(rng.integers(0, plan.q, size=(3, dg2, 2, N))).to(torch.int32)
    got = acc._key_product(plan, d_eval, keys)
    for b in range(3):
        torch.testing.assert_close(got[b], rgsw.external_product(plan, d_eval[b], keys[b]),
                                   rtol=0, atol=0)


@pytest.mark.slow
def test_std128_lmkcdey_cmux_failure_is_the_reference_s():
    """chip_smoke.py's one wrong STD128_LMKCDEY CMUX output (element 3401
    at its SEED 20261016, keys and inputs drawn as its [acc] phase draws
    them): the port on the CPU gives the same wrong output, fhe_tpu's
    third NAND on the same inputs is byte-equal to the port's, and the
    input sum's phase is inside the q/8 margin but past it once LMKCDEY
    rounds the exponents up to odd (1.070 q/8)."""
    seed, idx = 20261016, 3401
    tc = BinFheContext.generate("STD128_LMKCDEY", device="cpu")
    p = tc.params
    rng = np.random.default_rng(seed)
    sk = tc.key_gen(rng)
    key = tc.bt_key_gen(sk, rng)
    m1, m2, sel = (rng.integers(0, 2, size=4096) for _ in range(3))
    ct1, ct2, cs = (dataclasses.replace(c, a=c.a[idx:idx + 1], b=c.b[idx:idx + 1])
                    for c in (tc.encrypt(sk, m, rng) for m in (m1, m2, sel)))
    nand1 = tc.eval_bin_gate(key, Gate.NAND, ct1, tc.eval_not(cs))
    nand2 = tc.eval_bin_gate(key, Gate.NAND, ct2, cs)
    out = tc.eval_bin_gate(key, Gate.NAND, nand1, nand2)
    want = np.where(sel == 1, m2, m1)[idx]
    assert int(tc.decrypt(sk, out)[0]) != want

    q = p.q
    a = (nand1.a[0].to(torch.int64) + nand2.a[0]) % q
    a_odd = (q - (((q - a) % q) | 1)) % q                   # q = 2N
    b = (nand1.b[0].to(torch.int64) + nand2.b[0]) % q
    nominal = (int(tc.decrypt(sk, nand1)[0]) + int(tc.decrypt(sk, nand2)[0])) * (q // 4)
    s = sk.s.to(torch.int64)
    off = [abs((int((b - (x * s).sum()) % q) - nominal + q // 2) % q - q // 2) / (q / 8)
           for x in (a, a_odd)]
    assert off[0] < 1 <= off[1]
    assert off[1] == pytest.approx(1.070, abs=5e-4)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ntt, "ntt_forward", _jit_per_plan(j_ntt.ntt_forward))
        mp.setattr(j_ntt, "to_mont", _jit_per_plan(j_ntt.to_mont))
        jc = JContext.generate("STD128_LMKCDEY")
        rng = np.random.default_rng(seed)
        jsk = jc.key_gen(rng)
        jkey = jc.bt_key_gen(jsk, rng)
    _eq(jkey.rgsw, key.rgsw)
    _eq(jkey.auto, key.auto)
    jct = [jlwe.LweCiphertext(a=jnp.asarray(c.a.numpy().astype(np.uint32)),
                              b=jnp.asarray(c.b.numpy().astype(np.uint32)), modulus=c.modulus,
                              pt_mod=4) for c in (nand1, nand2)]
    jout = jc.eval_bin_gate(jkey, "NAND", *jct)
    _eq(jout.a, out.a)
    _eq(jout.b, out.b)


@pytest.mark.parametrize("gate", list(TRUTH))
@pytest.mark.parametrize("method", list(SETS))
def test_gate_truth_tables(keys, method, gate):
    _, tc, _, sk, _, key = keys[method]
    rng = np.random.default_rng(13)
    m1, m2 = rng.integers(0, 2, size=(2, 8))
    out = tc.eval_bin_gate(key, gate, tc.encrypt(sk, m1, rng), tc.encrypt(sk, m2, rng))
    assert (out.n, out.modulus) == (tc.params.n, tc.params.q)
    np.testing.assert_array_equal(tc.decrypt(sk, out).numpy(), TRUTH[gate](m1, m2))


@pytest.mark.parametrize("method", list(SETS))
def test_cmux_bootstrap_and_batch_api(keys, method):
    _, tc, _, sk, _, key = keys[method]
    rng = np.random.default_rng(14)
    m0, m1, sel = rng.integers(0, 2, size=(3, 6))
    ct0, ct1, cs = (tc.encrypt(sk, m, rng) for m in (m0, m1, sel))
    out = tc.eval_cmux(key, ct0, ct1, cs)
    np.testing.assert_array_equal(tc.decrypt(sk, out).numpy(), np.where(sel == 1, m1, m0))
    out = tc.bootstrap(key, ct0)
    np.testing.assert_array_equal(tc.decrypt(sk, out).numpy() % 2, m0)
    fut, res = eval_bin_gate_batch(tc, key, "AND", ct0, ct1, BatchFlags.ASYNC)
    assert res.success and res.processed == 6
    np.testing.assert_array_equal(tc.decrypt(sk, fut.result()).numpy(), m0 & m1)


def _counting(monkeypatch):
    """Count the NTTs of the gate pipeline (kernels 1 and 2 on the card)."""
    counts = {"forward": 0, "inverse": 0}
    for what, fn in (("forward", t_ntt.ntt_forward), ("inverse", t_ntt.ntt_inverse)):
        def counted(*args, _fn=fn, _what=what, **kw):
            counts[_what] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(t_ntt, f"ntt_{what}", counted)
    return counts


@pytest.mark.parametrize("method", list(SETS))
def test_every_ntt_impl_gives_the_same_gate(keys, method, monkeypatch):
    """ntt_impl None, "mega" and "fused" give identical ciphertexts (their
    kernels only match a GINX key, in fhe_tpu too); an unknown name raises.
    Each gate runs 1 + (per step or branch) forward and 1 + ... inverse
    NTTs, the counts chip_smoke.py expects of kernels 1 and 2."""
    _, tc, _, sk, _, key = keys[method]
    p = tc.params
    rng = np.random.default_rng(15)
    m1, m2 = rng.integers(0, 2, size=(2, 4))
    ct1, ct2 = tc.encrypt(sk, m1, rng), tc.encrypt(sk, m2, rng)
    if method == "AP":
        per_gate = p.n * p.digits_r
    else:
        kinds, p1, _, _ = acc.lmk_schedule(p, ((ct1.a + ct2.a) % p.q).numpy())
        per_gate = sum(int(b.sum()) for b in acc.lmk_branches(kinds, p1))
    _no_plain_digit_ntt(monkeypatch)
    counts = _counting(monkeypatch)
    outs = []
    for impl in (None, "mega", "fused"):
        ctx = dataclasses.replace(tc, ntt_impl=impl)
        outs.append(ctx.eval_bin_gate(key, Gate.AND, ct1, ct2))
        np.testing.assert_array_equal(ctx.decrypt(sk, outs[-1]).numpy(), m1 & m2)
    for out in outs[1:]:
        _same_ct(out, outs[0])
    assert counts == {"forward": 3 * (1 + per_gate), "inverse": 3 * (per_gate + 1)}
    with pytest.raises(ValueError, match="unknown ntt_impl"):
        dataclasses.replace(tc, ntt_impl="nope").eval_bin_gate(key, Gate.AND, ct1, ct2)


# the LMKCDEY sets fhe_tpu stops on with a bare AssertionError
UNKEYABLE = [("STD192_LMKCDEY", None, "LMKCDEY needs q == 2N"),
             ("STD256_LMKCDEY", None, "LMKCDEY needs q == 2N"),
             ("TOY", "LMKCDEY", "LMKCDEY needs q == 2N"),
             ("MEDIUM", "LMKCDEY", "LMKCDEY needs q == 2N")] + [
    (f"{s}_LMKCDEY", None, "2-limb RNS ring .* fhe_tpu cannot key this set either")
    for s in ("STD128Q_4", "STD192_3", "STD192_4", "STD192Q", "STD192Q_3", "STD192Q_4")]


@pytest.mark.parametrize("name,method,match", UNKEYABLE)
def test_unkeyable_lmkcdey_sets_raise_a_named_error(name, method, match):
    ctx = BinFheContext.generate(name, method=method, device="cpu")
    sk = ctx.key_gen(0)
    with pytest.raises(ValueError, match=match) as err:
        ctx.bt_key_gen(sk)
    assert str(err.value).startswith(f"{ctx.params.name}: ")
    with pytest.raises(ValueError, match=match):
        acc.lmkcdey_key_gen(ctx.params, sk, sk, np.random.default_rng(0))

