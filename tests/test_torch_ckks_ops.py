"""fhe_tpu_torch's CKKS key switch alone, rotation and conjugation keys,
rotate and conjugate (pke/rlwe.py, pke/ckks.py) against fhe_tpu on the CPU,
byte for byte, at tests/test_ckks.py's size (N = 256, num_levels = 4,
scale_bits = 26, dnum = 2); the decrypted values within the tolerances of
fhe_tpu's tests/test_ckks.py; and the carry-over of fhe_tpu's objects
(convert.py).  The fast-rotation pair and the leveled ops are in
test_torch_ckks_hoisted.py.

The port's keys are carried into fhe_tpu as arrays (test_torch_ckks.py
holds them equal to fhe_tpu's own); fhe_tpu runs only jitted, one compiled
function per op (about 3-4 s each on the CPU).  The port runs with
device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.pke import rlwe as j_rlwe
from fhe_tpu_torch import convert
from fhe_tpu_torch.pke import ckks, rlwe

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 256
SLOTS = N // 2
ROTS = (1, SLOTS - 1)
SEED = 23


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _j(t):
    return jnp.asarray(t.cpu().numpy().astype(np.uint32))


def _jpoly(p):
    return j_rns.RnsPoly(_j(p.data), p.moduli, p.fmt)


def _jct(ct):
    return j_ckks.Ciphertext(_jpoly(ct.c0), _jpoly(ct.c1), ct.scale)


def _jevk(k):
    return j_rlwe.EvalKey(b=_j(k.b), a=_j(k.a), moduli_qp=k.moduli_qp,
                          num_per_part=k.num_per_part)


def _same_ct(jct, ct):
    assert jct.c0.moduli == ct.c0.moduli and jct.scale == ct.scale
    _eq(jct.c0.data, ct.c0.data)
    _eq(jct.c1.data, ct.c1.data)


@pytest.fixture(scope="module")
def setup():
    """Both contexts, the port's keys (sk, pk, relinearization, rotations
    by ROTS, conjugation), the ciphertext of z and a plaintext vector w."""
    kw = dict(N=N, num_levels=4, scale_bits=26, dnum=2)
    ctx, jctx = ckks.CkksContext.create(**kw, device="cpu"), j_ckks.CkksContext.create(**kw)
    rng = np.random.default_rng(SEED)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    rot = ctx.rotation_key_gen(sk, ROTS, rng)
    conj = ctx.conj_key_gen(sk, rng)
    z = rng.normal(size=SLOTS) + 1j * rng.normal(size=SLOTS)
    w = rng.normal(size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    return ctx, jctx, (sk, pk, evk, rot, conj), ct, z, w


def _jsk(sk):
    return j_rlwe.SecretKey(s_signed=jnp.asarray(sk.s_signed.numpy()), s_eval_full=_j(
        sk.s_eval_full), moduli_full=sk.moduli_full)


def _fhe_tpu(setup, fn, *args):
    """fn(jctx, *args) jitted, on the port's objects carried into fhe_tpu."""
    jctx = setup[1]
    return jax.jit(lambda *xs: fn(jctx, *xs))(*args)


def test_rotation_keys_match_fhe_tpu(setup):
    """rotation_key_gen and conj_key_gen draw as fhe_tpu's (its key
    generation jitted, the generator closed over, on the carried secret)."""
    ctx, jctx, (sk, pk, evk, rot, conj), _, _, _ = setup
    rng = np.random.default_rng(7)
    keys = ctx.rotation_key_gen(sk, ROTS, rng), ctx.conj_key_gen(sk, rng)
    jrng = np.random.default_rng(7)
    jkeys = jax.jit(lambda s: (jctx.rotation_key_gen(s, ROTS, jrng),
                               jctx.conj_key_gen(s, jrng)))(_jsk(sk))
    for got, exp in [(keys[0][r], jkeys[0][r]) for r in ROTS] + [(keys[1], jkeys[1])]:
        _eq(exp.b, got.b)
        _eq(exp.a, got.a)


def test_key_switch_matches_fhe_tpu(setup):
    """key_switch of c1 with the relinearization key, and the hoisted pair
    key_switch_precompute + key_switch_apply, which equals it."""
    ctx, _, (sk, pk, evk, rot, conj), ct, _, _ = setup
    d0, d1 = rlwe.key_switch(ctx.params, evk, ct.c1)
    j0, j1 = _fhe_tpu(setup, lambda jc, c, k: j_rlwe.key_switch(jc.params, k, c), _jpoly(ct.c1),
                      _jevk(evk))
    _eq(j0.data, d0.data)
    _eq(j1.data, d1.data)
    h0, h1 = rlwe.key_switch_apply(ctx.params, evk, rlwe.key_switch_precompute(ctx.params, ct.c1))
    assert torch.equal(h0.data, d0.data) and torch.equal(h1.data, d1.data)


@pytest.mark.parametrize("r", ROTS)
def test_rotate(setup, r):
    """EvalRotate by r: z rolled left by r within 1e-3; by 1 fhe_tpu's bytes
    (one jitted rotation; SLOTS - 1 differs only in the key and the index
    table, both held to fhe_tpu above and in test_torch_rns_ring.py)."""
    ctx, _, (sk, pk, evk, rot, conj), ct, z, _ = setup
    got = ctx.rotate(ct, r, rot)
    if r == 1:
        _same_ct(_fhe_tpu(setup, lambda jc, c, k: jc.rotate(c, 1, {1: k}), _jct(ct),
                          _jevk(rot[1])), got)
    np.testing.assert_allclose(ctx.decrypt(sk, got), np.roll(z, -r), atol=1e-3)


def test_conjugate_matches_fhe_tpu(setup):
    ctx, _, (sk, pk, evk, rot, conj), ct, z, _ = setup
    got = ctx.conjugate(ct, conj)
    _same_ct(_fhe_tpu(setup, lambda jc, c, k: jc.conjugate(c, k), _jct(ct), _jevk(conj)), got)
    np.testing.assert_allclose(ctx.decrypt(sk, got), np.conj(z), atol=1e-3)


def test_carried_objects_are_the_port_objects(setup):
    """convert: fhe_tpu's keys and a ciphertext, as numpy arrays, give the
    port's objects; a PreparedEvalKey comes out of Montgomery form."""
    ctx, jctx, (sk, pk, evk, rot, conj), ct, _, _ = setup
    a = lambda x: np.asarray(x)
    jsk = _jsk(sk)
    csk = convert.rlwe_secret_key(a(jsk.s_signed), a(jsk.s_eval_full), jsk.moduli_full, "cpu")
    assert torch.equal(csk.s_eval_full, sk.s_eval_full)
    assert torch.equal(csk.s_signed, sk.s_signed)
    cpk = convert.rlwe_public_key(a(_j(pk.b.data)), a(_j(pk.a.data)), pk.b.moduli, "cpu")
    assert torch.equal(cpk.b.data, pk.b.data) and torch.equal(cpk.a.data, pk.a.data)
    jevk = _jevk(evk)
    cevk = convert.eval_key(a(jevk.b), a(jevk.a), jevk.moduli_qp, jevk.num_per_part, "cpu")
    assert torch.equal(cevk.b, evk.b) and torch.equal(cevk.a, evk.a)
    jp = jax.jit(lambda k: j_rlwe.prepare_evk(jctx.params, k))(jevk)
    cp = convert.prepared_eval_key(a(jp.b_mont), a(jp.a_mont), jp.moduli_qp, jp.num_per_part,
                                   "cpu")
    prepared = rlwe.prepare_evk(ctx.params, evk)
    assert torch.equal(cp.b, prepared.b) and torch.equal(cp.a, prepared.a)
    jct = _jct(ct)
    cct = convert.ckks_ciphertext(a(jct.c0.data), a(jct.c1.data), jct.moduli, jct.scale,
                                  device="cpu")
    assert torch.equal(cct.c0.data, ct.c0.data) and torch.equal(cct.c1.data, ct.c1.data)
    assert cct.scale == ct.scale
    with pytest.raises(ValueError, match="below its limb's modulus"):
        convert.ckks_ciphertext(np.full((5, N), 2**30), a(jct.c1.data), ct.moduli, 1.0,
                                device="cpu")


def test_degree3_relinearize():
    """EvalMultNoRelin to degree 3 and relinearization with the s^2, s^3
    keys (fhe_tpu's test_degree3_mult_keys_relinearize on the port alone,
    at its scale_bits = 18 and tolerances)."""
    ctx = ckks.CkksContext.create(N=N, num_levels=4, scale_bits=18, dnum=2, first_bits=30,
                                  device="cpu")
    rng = np.random.default_rng(SEED + 1)
    sk, pk = ctx.keygen(rng)
    evks = ctx.relin_keys_gen(sk, rng, max_degree=3)
    zs = [rng.normal(size=SLOTS) * 0.8 for _ in range(3)]
    cts = [ctx.encrypt(pk, z, rng) for z in zs]
    deg2 = ctx.mul_no_relin(cts[0], cts[1])
    assert deg2.c2 is not None and not deg2.c_rest
    np.testing.assert_allclose(ctx.decrypt(sk, deg2).real, zs[0] * zs[1], atol=5e-2)
    deg3 = ctx.mul_no_relin(deg2, cts[2])
    assert len(deg3.components()) == 4
    want = zs[0] * zs[1] * zs[2]
    np.testing.assert_allclose(ctx.decrypt(sk, deg3).real, want, atol=0.3)
    lin = ctx.relinearize(deg3, evks)
    assert lin.c2 is None and not lin.c_rest
    np.testing.assert_allclose(ctx.decrypt(sk, lin).real, want, atol=0.3)
    fused = ctx.mul_and_relinearize(deg2, cts[2], evks)
    assert torch.equal(fused.c0.data, lin.c0.data) and torch.equal(fused.c1.data, lin.c1.data)
