"""fhe_tpu_torch's lux_fhe_* / ckks_* C API (native/capi.cpp, the port's
copy of fhe_tpu's, over native/capi_impl.py) on the CPU.

The port's libfhecapi is built with g++ and loaded with ctypes into this
process, which it joins; its registries run on the CPU here
(`capi_impl.set_device("cpu")`).  At TOY, from the same seeds and the same
sequence of calls, its marshalled keys and ciphertexts (fresh encryptions,
every gate, NOT, MUX and bootstrap) are byte-identical to those of
fhe_tpu's capi_impl functions, called directly (fhe_tpu's own library is
not built, so nothing is written into fhe_tpu/native/).  fhe_tpu's BSK
assembly runs jitted, as in test_torch_funcboot.py.  At TOY q_ks == Q, and
fhe_tpu's mod switch Q -> Q is off by a few units where the port's is the
identity (its round_scale_mod, ROADMAP.md queue 3; test_torch_gate.py):
here fhe_tpu's lwe.mod_switch is the identity when the moduli agree, so
that the gates' bytes compare.  The threshold ABI's shares, verification
keys and decryptions are fhe_tpu's for the same `secrets` stream (seeded as
in test_torch_threshold.py).  The ckks_* ABI's chain (levels, moduli,
composite degree) is fhe_tpu's, and from a keypair of the same seed (made
by capi_impl.ckks_keygen(h, seed), since the ABI's keygen takes none) its
keys and its ciphertexts (encrypt, add, sub, both mults, a stock and a
lazily keyed rotation; `slow`) are byte-identical to fhe_tpu's capi_impl;
beside that, the CKKS surface is held to its plaintext values.
"""

import ctypes
import dataclasses
import functools
import os
import shutil
import sysconfig

import jax
import numpy as np
import pytest
import torch

from fhe_tpu.native import capi_impl as jci
from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu.utils import serial as jserial
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import rgsw as j_rgsw
from fhe_tpu_torch.native import capi, capi_impl
from fhe_tpu_torch.utils import serial

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

GATES = ("and", "or", "xor", "nand", "nor", "xnor")
TRUTH = {"and": lambda a, b: a & b, "or": lambda a, b: a | b, "xor": lambda a, b: a ^ b,
         "nand": lambda a, b: 1 - (a & b), "nor": lambda a, b: 1 - (a | b),
         "xnor": lambda a, b: 1 - (a ^ b)}


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if not os.path.exists(os.path.join(sysconfig.get_paths()["include"], "Python.h")):
        pytest.skip("this interpreter's Python.h is not installed")
    capi_impl.set_device("cpu")
    yield capi.get_lib()
    capi_impl.set_device("cuda")


def _handle(call, *args):
    out = ctypes.c_void_p()
    rc = call(*args, ctypes.byref(out))
    assert rc == 0, rc
    return out


def _marshal(lib, ct) -> bytes:
    data, n = capi._u8p(), ctypes.c_int64()
    assert lib.lux_fhe_ciphertext_marshal(ct, ctypes.byref(data), ctypes.byref(n)) == 0
    raw = ctypes.string_at(data, n.value)
    lib.lux_fhe_bytes_free(data)
    return raw


def _id(handle) -> int:
    """The registry id that an ABI handle (a struct of one int64) holds."""
    return ctypes.cast(handle, ctypes.POINTER(ctypes.c_int64)).contents.value


class Stream:
    """A seeded byte stream in place of secrets.token_bytes."""

    def __init__(self, seed: int):
        self.seed = seed
        self.reset()

    def reset(self):
        self.rng = np.random.default_rng(self.seed)

    def __call__(self, n: int) -> bytes:
        return self.rng.bytes(n)


def _dec(lib, ctx, sk, ct) -> int:
    out = ctypes.c_int()
    assert lib.lux_fhe_decrypt(ctx, sk, ct, ctypes.byref(out)) == 0
    return out.value


@pytest.fixture(scope="module", autouse=True)
def exact_identity_switch():
    """fhe_tpu's mod switch, the identity when the moduli agree (see above)."""
    mod_switch = jlwe.mod_switch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlwe, "mod_switch",
                   lambda ct, q_to: ct if ct.modulus == q_to else mod_switch(ct, q_to))
        # fhe_tpu's gate pipeline is jitted once a process: trace it anew
        # with the patch, and without it for the tests after this module
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def stacks(lib):
    """(the port's TOY context, secret and bootstrap key through the ABI,
    fhe_tpu's through capi_impl), keyed from seed 42."""
    ctx = _handle(lib.lux_fhe_context_new, b"TOY", b"GINX")
    sk = _handle(lib.lux_fhe_keygen_secret, ctx, 42)
    bsk = _handle(lib.lux_fhe_keygen_bootstrap, ctx, sk)
    bsk_device = j_rgsw._bsk_device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rgsw, "_bsk_device", lambda plan, params, *x: jax.jit(
            functools.partial(bsk_device, plan, params))(*x))
        jctx = jci.context_new("TOY")
        jsk = jci.keygen_secret(jctx, 42)
        jbsk = jci.keygen_bootstrap(jctx, jsk)
    return (ctx, sk, bsk), (jctx, jsk, jbsk)


@pytest.fixture(scope="module")
def inputs(lib, stacks):
    """Encryptions of 0 and 1 in both stacks (same draws), byte-identical."""
    (ctx, sk, _), (jctx, jsk, _) = stacks
    cts = {b: _handle(lib.lux_fhe_encrypt, ctx, sk, b) for b in (0, 1)}
    jcts = {b: jci.encrypt(jctx, jsk, b) for b in (0, 1)}
    for b in (0, 1):
        assert _marshal(lib, cts[b]) == jci.ciphertext_marshal(jcts[b])
        assert _dec(lib, ctx, sk, cts[b]) == b
    return cts, jcts


def test_version_errors_introspection(lib, stacks):
    (ctx, _, _), (jctx, _, _) = stacks
    assert lib.lux_fhe_version() == b"1.4.2"
    assert lib.lux_fhe_strerror(0) == b"ok" and b"gate" in lib.lux_fhe_strerror(8)
    assert lib.lux_fhe_has_gpu() == 0                 # the registries run on the CPU here
    assert lib.lux_fhe_context_n(ctx) == jci.context_n(jctx)
    assert lib.lux_fhe_context_ring_dim(ctx) == jci.context_ring_dim(jctx)
    assert lib.lux_fhe_context_modulus(ctx) == jci.context_modulus(jctx)
    assert lib.lux_fhe_context_new(None, None, None) == 1
    out = ctypes.c_void_p()
    assert lib.lux_fhe_context_new(b"NOT_A_SET", b"GINX", ctypes.byref(out)) == 4


@pytest.mark.parametrize("gate", GATES)
def test_gates_byte_identical_to_fhe_tpu(lib, stacks, inputs, gate):
    (ctx, sk, bsk), (jctx, jsk, jbsk) = stacks
    cts, jcts = inputs
    for a in (0, 1):
        for b in (0, 1):
            out = _handle(getattr(lib, f"lux_fhe_{gate}"), ctx, bsk, cts[a], cts[b])
            jout = jci.eval_gate(jctx, jbsk, gate.upper(), jcts[a], jcts[b])
            assert _marshal(lib, out) == jci.ciphertext_marshal(jout), (gate, a, b)
            assert _dec(lib, ctx, sk, out) == TRUTH[gate](a, b), (gate, a, b)
            lib.lux_fhe_ciphertext_free(out)


def test_not_mux_bootstrap_clone_byte_identical(lib, stacks, inputs):
    (ctx, sk, bsk), (jctx, jsk, jbsk) = stacks
    cts, jcts = inputs
    outs = [(_handle(lib.lux_fhe_not, ctx, cts[0]), jci.eval_not(jctx, jcts[0]), 1)]
    for sel, want in ((1, 0), (0, 1)):                 # mux(sel, a, b) = sel ? a : b
        outs.append((_handle(lib.lux_fhe_mux, ctx, bsk, cts[sel], cts[0], cts[1]),
                     jci.eval_mux(jctx, jbsk, jcts[sel], jcts[0], jcts[1]), want))
    outs.append((_handle(lib.lux_fhe_bootstrap, ctx, bsk, cts[1]),
                 jci.bootstrap(jctx, jbsk, jcts[1]), 1))
    outs.append((_handle(lib.lux_fhe_ciphertext_clone, cts[1]), jcts[1], 1))
    for out, jout, want in outs:
        assert _marshal(lib, out) == jci.ciphertext_marshal(jout)
        assert _dec(lib, ctx, sk, out) == want


def test_marshal_round_trip(lib, stacks, inputs):
    """Ciphertext and secret-key archives: fhe_tpu's bytes, and they load
    back into working handles (a fhe_tpu archive too)."""
    (ctx, sk, _), (jctx, jsk, _) = stacks
    cts, jcts = inputs
    raw = _marshal(lib, cts[1])
    buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)
    back = ctypes.c_void_p()
    assert lib.lux_fhe_ciphertext_unmarshal(ctypes.cast(buf, capi._u8p), len(raw),
                                            ctypes.byref(back)) == 0
    assert _dec(lib, ctx, sk, back) == 1
    data, n = capi._u8p(), ctypes.c_int64()
    assert lib.lux_fhe_secretkey_marshal(sk, ctypes.byref(data), ctypes.byref(n)) == 0
    raw_sk = ctypes.string_at(data, n.value)
    lib.lux_fhe_bytes_free(data)
    assert raw_sk == jci.secretkey_marshal(jsk)
    buf2 = (ctypes.c_uint8 * len(raw_sk)).from_buffer_copy(raw_sk)
    sk2 = ctypes.c_void_p()
    assert lib.lux_fhe_secretkey_unmarshal(ctypes.cast(buf2, capi._u8p), len(raw_sk),
                                           ctypes.byref(sk2)) == 0
    assert _dec(lib, ctx, sk2, cts[1]) == 1
    junk = (ctypes.c_uint8 * 8)(*b"notanarc")
    assert lib.lux_fhe_ciphertext_unmarshal(ctypes.cast(junk, capi._u8p), 8,
                                            ctypes.byref(back)) == 10


def test_public_key_encrypt(lib, stacks):
    ctx, sk, _ = stacks[0]
    pk = _handle(lib.lux_fhe_keygen_public, ctx, sk)
    ct = _handle(lib.lux_fhe_encrypt_pk, ctx, pk, sk, 1)
    assert _dec(lib, ctx, sk, ct) == 1
    lib.lux_fhe_publickey_free(pk)


def test_threshold_abi(lib, stacks, inputs):
    """3-of-3 additive split of the context secret: the quorum decrypts,
    a short quorum errors; Shamir needs a prime modulus and fails."""
    ctx, sk, _ = stacks[0]
    cts, _ = inputs
    sh = ctypes.c_void_p()
    assert lib.lux_fhe_threshold_keygen(ctx, sk, 3, 3, b"additive", ctypes.byref(sh)) == 0
    assert lib.lux_fhe_threshold_parties(sh) == 3
    out = ctypes.c_int()
    for bit in (0, 1):
        ids = (ctypes.c_int32 * 3)(1, 2, 3)
        assert lib.lux_fhe_threshold_decrypt(ctx, sh, cts[bit], ids, 3, ctypes.byref(out)) == 0
        assert out.value == bit
    ids2 = (ctypes.c_int32 * 2)(1, 2)
    assert lib.lux_fhe_threshold_decrypt(ctx, sh, cts[1], ids2, 2, ctypes.byref(out)) != 0
    lib.lux_fhe_threshold_free(sh)
    assert lib.lux_fhe_threshold_keygen(ctx, sk, 2, 3, b"shamir", ctypes.byref(sh)) != 0


def test_threshold_abi_matches_fhe_tpu(lib, stacks, inputs, monkeypatch):
    """From the same `secrets` stream the ABI's 3-of-3 additive shares and
    verification keys are fhe_tpu's capi_impl's, and both decrypt each
    bit, with its proofs, to the same value."""
    (ctx, sk, _), (jctx, jsk, _) = stacks
    cts, jcts = inputs
    stream = Stream(2026)
    monkeypatch.setattr("secrets.token_bytes", stream)
    sh = ctypes.c_void_p()
    assert lib.lux_fhe_threshold_keygen(ctx, sk, 3, 3, b"additive", ctypes.byref(sh)) == 0
    stream.reset()
    jsh = jci.threshold_keygen(jctx, jsk, 3, 3, "additive")
    got, want = capi_impl._threshold[_id(sh)], jci._threshold[jsh]
    assert dataclasses.astuple(got["cfg"]) == dataclasses.astuple(want["cfg"])
    assert [(s.party_id, s.commitment) for s in got["shares"]] == \
        [(s.party_id, s.commitment) for s in want["shares"]]
    for t, j in zip(got["shares"], want["shares"]):
        np.testing.assert_array_equal(t.share.numpy(), np.asarray(j.share).astype(np.int64))
    assert [(v.party_id, v.commitment) for v in got["vks"]] == \
        [(v.party_id, v.commitment) for v in want["vks"]]
    ids = np.array([1, 2, 3], dtype="<i4")
    for bit in (0, 1):
        out = ctypes.c_int()
        stream.reset()
        assert lib.lux_fhe_threshold_decrypt(
            ctx, sh, cts[bit], (ctypes.c_int32 * 3)(*ids), 3, ctypes.byref(out)) == 0
        stream.reset()
        assert out.value == jci.threshold_decrypt(jctx, jsh, jcts[bit], ids.tobytes()) == bit
    lib.lux_fhe_threshold_free(sh)


class TestCkksAbi:
    @pytest.fixture(scope="class")
    def cstack(self, lib):
        ctx = lib.ckks_context_new(8, 104, float(1 << 26))      # N = 256, 3 levels
        assert ctx
        kp = lib.ckks_keygen(ctx)
        assert kp
        return ctx, kp

    @staticmethod
    def _dec(lib, ctx, kp, ct, n):
        out_len = ctypes.c_int()
        p = lib.ckks_decrypt(ctx, kp, ct, ctypes.byref(out_len))
        assert p and out_len.value == 128
        vals = np.array([p[i] for i in range(n)])
        capi.libc_free(p)
        return vals

    @staticmethod
    def _enc(lib, ctx, kp, vals):
        ct = lib.ckks_encrypt(ctx, kp, (ctypes.c_double * len(vals))(*vals), len(vals))
        assert ct
        return ct

    def test_add_sub_mult(self, lib, cstack):
        ctx, kp = cstack
        a, b = np.array([0.5, -1.25, 2.0, 3.0]), np.array([1.0, 0.25, -0.5, 2.0])
        ca, cb = self._enc(lib, ctx, kp, a), self._enc(lib, ctx, kp, b)
        assert np.abs(self._dec(lib, ctx, kp, ca, 4) - a).max() < 1e-3
        for fn, want, tol in ((lib.ckks_add, a + b, 1e-3), (lib.ckks_sub, a - b, 1e-3),
                              (lib.ckks_mult, a * b, 1e-2)):
            c = fn(ctx, ca, cb)
            assert np.abs(self._dec(lib, ctx, kp, c, 4) - want).max() < tol
            lib.ckks_ciphertext_free(c)
        c = lib.ckks_mult_kp(ctx, kp, ca, cb)
        assert np.abs(self._dec(lib, ctx, kp, c, 4) - a * b).max() < 1e-2

    def test_levels_and_rejected_parameters(self, lib, cstack):
        assert lib.ckks_context_levels(cstack[0]) == 3
        assert not lib.ckks_context_new(8, 104, 0.5)
        assert not lib.ckks_context_new(8, 30, float(1 << 26))

    def test_rotate_stock_and_lazy(self, lib, cstack):
        ctx, kp = cstack
        ct = self._enc(lib, ctx, kp, [float(i) for i in range(8)])
        for steps in (1, 3):                  # a stock key; a key made on demand
            r = lib.ckks_rotate(ctx, kp, ct, steps)
            assert abs(self._dec(lib, ctx, kp, r, 1)[0] - steps) < 1e-3
            lib.ckks_ciphertext_free(r)

    def test_serialize_on_the_wire_format(self, lib, cstack):
        """The archive reads in fhe_tpu as its CKKS ciphertext, loads back
        here, and a mismatched context or garbage is refused."""
        ctx, kp = cstack
        ct = self._enc(lib, ctx, kp, [1.5, -2.5])
        n = ctypes.c_int()
        data = lib.ckks_serialize_ciphertext(ct, ctypes.byref(n))
        raw = ctypes.string_at(data, n.value)
        lib.lux_fhe_bytes_free(data)
        jct = jserial.loads(raw)
        assert type(jct).__module__ == "fhe_tpu.pke.ckks" and jct.c0.data.dtype == np.uint32
        buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)
        back = lib.ckks_deserialize_ciphertext(ctx, ctypes.cast(buf, capi._u8p), len(raw))
        assert np.abs(self._dec(lib, ctx, kp, back, 2) - [1.5, -2.5]).max() < 1e-3
        junk = (ctypes.c_uint8 * 8)(*b"notactx!")
        assert not lib.ckks_deserialize_ciphertext(ctx, ctypes.cast(junk, capi._u8p), 8)
        other = lib.ckks_context_new(9, 104, float(1 << 26))
        assert not lib.ckks_deserialize_ciphertext(other, ctypes.cast(buf, capi._u8p), len(raw))
        lib.ckks_context_free(other)

    def test_null_arguments_rejected(self, lib, cstack):
        ctx, kp = cstack
        assert not lib.ckks_keygen(None)
        assert not lib.ckks_add(ctx, None, None)
        assert not lib.ckks_decrypt(ctx, kp, None, ctypes.byref(ctypes.c_int()))


CKKS_SEED = 11


def _whole(fn):
    """fn compiled as one XLA program, its arguments closed over, where
    eager jax would compile fhe_tpu's CKKS op by op (minutes at N = 256)."""
    return lambda *args: jax.jit(lambda: fn(*args))()


@pytest.fixture(scope="module")
def ckks_pair(lib):
    """The port's N = 256, 3-level ckks_* context through the ABI with a
    keypair of CKKS_SEED (capi_impl.ckks_keygen, the function behind the
    ABI's ckks_keygen, which takes no seed), and fhe_tpu's through its
    capi_impl, its keygen, encrypt, rotate and mult each one program."""
    ctx = lib.ckks_context_new(8, 104, float(1 << 26))
    assert ctx
    box = ctypes.c_int64(capi_impl.ckks_keygen(_id(ctx), CKKS_SEED))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("keygen", "relin_key_gen", "rotation_key_gen", "encrypt", "rotate"):
            mp.setattr(j_ckks.CkksContext, name, _whole(getattr(j_ckks.CkksContext, name)))
        mp.setattr(j_adv, "mul_aligned", _whole(j_adv.mul_aligned))
        jh = jci.ckks_context_new(8, 104, float(1 << 26))
        yield ctx, ctypes.c_void_p(ctypes.addressof(box)), jh, jci.ckks_keygen(jh, CKKS_SEED)
    capi_impl.ckks_keypair_free(box.value)
    lib.ckks_context_free(ctx)


def test_ckks_chain_and_keys_match_fhe_tpu(lib, ckks_pair):
    ctx, kp, jh, jkp = ckks_pair
    assert lib.ckks_context_levels(ctx) == jci.ckks_context_levels(jh) == 3
    got, want = capi_impl._ckks_ctx[_id(ctx)].params, jci._ckks_ctx[jh].params
    assert (tuple(got.moduli), tuple(got.special_mods), got.composite_degree, got.N) == \
        (tuple(want.moduli), tuple(want.special_mods), want.composite_degree, want.N)
    keys = {k: capi_impl._ckks_kp[_id(kp)][k] for k in ("sk", "pk", "evk", "rot")}
    jkeys = {k: jci._ckks_kp[jkp][k] for k in ("sk", "pk", "evk", "rot")}
    assert serial.dumps(keys) == jserial.dumps(jkeys)


@pytest.mark.slow      # ~11 s: fhe_tpu compiles each op at N = 256
def test_ckks_ciphertexts_byte_identical_to_fhe_tpu(lib, ckks_pair):
    """encrypt, add, sub, ckks_mult (the context's key, this keypair's),
    ckks_mult_kp and rotations by 1 (a stock key) and 3 (keyed on demand
    from the keypair's rng, in both) through the ABI: fhe_tpu's bytes, and
    the plaintext results."""
    ctx, kp, jh, jkp = ckks_pair
    rng = np.random.default_rng(12)
    a, b = rng.normal(size=(2, 128)) * 0.5

    def ser(ct) -> bytes:
        n = ctypes.c_int()
        data = lib.ckks_serialize_ciphertext(ct, ctypes.byref(n))
        raw = ctypes.string_at(data, n.value)
        lib.lux_fhe_bytes_free(data)
        return raw

    ca, cb = (TestCkksAbi._enc(lib, ctx, kp, v) for v in (a, b))
    ja, jb = (jci.ckks_encrypt(jh, jkp, v.astype("<f8").tobytes()) for v in (a, b))
    outs = [(ca, ja, a, 1e-3), (cb, jb, b, 1e-3),
            (lib.ckks_add(ctx, ca, cb), jci.ckks_add(jh, ja, jb), a + b, 1e-3),
            (lib.ckks_sub(ctx, ca, cb), jci.ckks_sub(jh, ja, jb), a - b, 1e-3),
            (lib.ckks_mult(ctx, ca, cb), jci.ckks_mult_ctx(jh, ja, jb), a * b, 1e-2)]
    # the keypair's mult: the context's key is this keypair's evk
    outs.append((lib.ckks_mult_kp(ctx, kp, ca, cb), outs[-1][1], a * b, 1e-2))
    for steps in (1, 3):
        outs.append((lib.ckks_rotate(ctx, kp, ca, steps), jci.ckks_rotate(jh, jkp, ja, steps),
                     np.roll(a, -steps), 1e-2))
    for i, (ct, jct, want, tol) in enumerate(outs):
        assert ct, i
        assert ser(ct) == jci.ckks_serialize_ciphertext(jct), i
        assert np.abs(TestCkksAbi._dec(lib, ctx, kp, ct, 128) - want).max() < tol, i
