"""fhe_tpu_torch bit-reversed blind rotation (`ntt_impl` "mega" and
"fused") against fhe_tpu's boot_pallas, byte for byte (every value is an
integer residue, so the tolerance is exact).

The fhe_tpu side runs its Pallas kernels in interpret mode, as it does off
a TPU (`boot_pallas._interpret`).  The port's side is the plain PyTorch
version of kernels 4 and 5; the kernels themselves are held against it on
the card (tests/test_torch_cuda.py).  TOY, batch 8: the kernel-level tests
take 4 steps of a random key, the gate tests the whole TOY rotation.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.math import ntt as jntt
from fhe_tpu.math import ntt_pallas
from fhe_tpu.tfhe import BinFheContext as JContext
from fhe_tpu.tfhe import boot_pallas as jbp
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import make_params as j_make_params
from fhe_tpu.tfhe import rgsw as jrgsw
from fhe_tpu_torch.math import ntt as tntt
from fhe_tpu_torch.tfhe import BinFheContext, boot, rgsw
from fhe_tpu_torch.tfhe import boot_pallas as tbp
from fhe_tpu_torch.tfhe import make_params as t_make_params

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ["mega", "fused"]


def _i32(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64).astype(np.uint32)


def _eq(jarr, tens):
    np.testing.assert_array_equal(tens.cpu().numpy().astype(np.int64),
                                  np.asarray(jarr).astype(np.int64))


def _random_rotation(params, rng, B=8, steps=4):
    acc = rng.integers(0, params.Q, size=(B, 2, params.N)).astype(np.uint32)
    bsk = rng.integers(0, params.Q, size=(steps, 2, params.digits_g2, 2, params.N)
                       ).astype(np.uint32)
    a = rng.integers(0, params.q, size=(B, steps)).astype(np.uint32)
    return acc, bsk, a


def test_bsk_to_br_matches_fhe_tpu(rng):
    jp, tp = j_make_params("TOY"), t_make_params("TOY")
    _, bsk, _ = _random_rotation(jp, rng, steps=3)
    got = tbp.bsk_to_br(tp, _i32(bsk))
    _eq(jbp.bsk_to_br(jp, jnp.asarray(bsk)), got)
    torch.testing.assert_close(tbp.bit_reverse(tp, got), _i32(bsk), rtol=0, atol=0)


@pytest.mark.parametrize("N", [512, 1024])
def test_forward_out_br_matches_pallas_interpret(N, rng):
    q = 134215681
    jplan, tplan = jntt.make_plan(N, q), tntt.make_plan(N, q)
    x = rng.integers(0, q, size=(6, N)).astype(np.uint32)
    got = tntt.ntt_forward(tplan, _i32(x), out_br=True)
    want = np.asarray(ntt_pallas.forward_pallas(jplan, jnp.asarray(x), out_br=True))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(got[:, tplan.br]), _u32(tntt.ntt_forward(tplan, _i32(x))))


@pytest.mark.parametrize("impl", IMPLS)
def test_blind_rotate_br_matches_fhe_tpu(impl, rng):
    """blind_rotate_mega / blind_rotate_fused (a loop of rotate_step_br),
    plain versions, against fhe_tpu's Pallas kernels in interpret mode."""
    jp, tp = j_make_params("TOY"), t_make_params("TOY")
    acc, bsk, a = _random_rotation(jp, rng)
    jf, tf = {"mega": (jbp.blind_rotate_mega, tbp.blind_rotate_mega),
              "fused": (jbp.blind_rotate_fused, tbp.blind_rotate_fused)}[impl]
    want = jf(jp, jnp.asarray(bsk), jnp.asarray(acc), jnp.asarray(a))
    got = tf(tp, _i32(bsk), _i32(acc), _i32(a))
    assert got.dtype == torch.int32 and got.shape == acc.shape
    _eq(want, got)


def test_rotate_step_br_is_one_step_of_the_natural_rotation(rng):
    tp = t_make_params("TOY")
    acc, bsk, a = (_i32(x) for x in _random_rotation(tp, rng, steps=1))
    got = tbp.rotate_step_br(tp, tbp.bsk_to_br(tp, bsk)[0], tbp.bit_reverse(tp, acc), a[:, 0])
    want = boot.blind_rotate(tp, rgsw.BootstrapKey(bsk=bsk, ksk=None), acc, a)
    torch.testing.assert_close(tbp.bit_reverse(tp, got), want, rtol=0, atol=0)


def test_rotation_indices():
    """idx_pos = ((q - a) mod q) * 2N/q mod 2N (fhe_tpu boot_pallas.py:312),
    as the plain rotation computes it and the kernels do per step
    (csrc/blind_rotate.cuh `indices`, with idx_neg = 2N - idx_pos mod 2N)."""
    tp = t_make_params("TOY")
    a = torch.tensor([[0, 1, 5, tp.q - 1]], dtype=torch.int32)
    idx_pos, zero_low_bits = boot._rotation_indices(tp, a, tp.q)
    m_by = 2 * tp.N // tp.q
    assert idx_pos.tolist() == [[0, (tp.q - 1) * m_by, (tp.q - 5) * m_by, m_by]]
    assert zero_low_bits == m_by.bit_length() - 1


@pytest.fixture(scope="module")
def toy_keys():
    """The port's TOY keys (seeds 1 and 2) and the same keys as fhe_tpu
    arrays.  fhe_tpu's own keygen gives these bytes from these seeds
    (tests/test_torch_gate.py)."""
    tc = BinFheContext.generate("TOY", device="cpu")
    tsk = tc.key_gen(1)
    tkey = tc.bt_key_gen(tsk, 2)
    u32 = lambda t: jnp.asarray(_u32(t))
    jkey = jrgsw.BootstrapKey(bsk=u32(tkey.bsk),
                              ksk=jlwe.LweSwitchingKey(a=u32(tkey.ksk.a), b=u32(tkey.ksk.b)))
    return tsk, tkey, jkey


def _bits(seed, B=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=B), rng.integers(0, 2, size=B), rng


@pytest.mark.parametrize("impl", IMPLS)
def test_gate_extended_output_matches_fhe_tpu(impl, toy_keys):
    tsk, tkey, jkey = toy_keys
    tc = BinFheContext.generate("TOY", device="cpu", ntt_impl=impl)
    jc = JContext(params=j_make_params("TOY"), ntt_impl=impl)
    m1, m2, rng = _bits(3)
    tct1, tct2 = tc.encrypt(tsk, m1, rng), tc.encrypt(tsk, m2, rng)
    jct1, jct2 = (jlwe.LweCiphertext(a=jnp.asarray(_u32(c.a)), b=jnp.asarray(_u32(c.b)),
                                     modulus=c.modulus) for c in (tct1, tct2))
    want = jc.eval_bin_gate(jkey, "AND", jct1, jct2, extended=True)
    got = tc.eval_bin_gate(tkey, "AND", tct1, tct2, extended=True)
    assert (got.modulus, got.pt_mod) == (want.modulus, want.pt_mod)
    _eq(want.a, got.a)
    _eq(want.b, got.b)
    default = BinFheContext.generate("TOY", device="cpu")
    natural = default.eval_bin_gate(tkey, "AND", tct1, tct2, extended=True)
    torch.testing.assert_close(got.a, natural.a, rtol=0, atol=0)
    torch.testing.assert_close(got.b, natural.b, rtol=0, atol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_gates_bootstrap_and_cmux_decrypt(impl, toy_keys):
    tsk, tkey, _ = toy_keys
    tc = BinFheContext.generate("TOY", device="cpu", ntt_impl=impl)
    m1, m2, rng = _bits(4)
    sel = rng.integers(0, 2, size=m1.shape)
    ct1, ct2, cs = (tc.encrypt(tsk, m, rng) for m in (m1, m2, sel))
    dec = lambda ct: tc.decrypt(tsk, ct).numpy()
    np.testing.assert_array_equal(dec(tc.eval_bin_gate(tkey, "XOR", ct1, ct2)), m1 ^ m2)
    np.testing.assert_array_equal(dec(tc.eval_bin_gate(tkey, "NAND", ct1, ct2)), 1 - (m1 & m2))
    np.testing.assert_array_equal(dec(tc.bootstrap(tkey, ct1)) % 2, m1)
    np.testing.assert_array_equal(dec(tc.eval_cmux(tkey, ct1, ct2, cs)), np.where(sel == 1, m2, m1))


def test_unknown_ntt_impl_raises(toy_keys):
    tsk, tkey, _ = toy_keys
    tc = BinFheContext.generate("TOY", device="cpu", ntt_impl="lanes")
    ct = tc.encrypt(tsk, np.array([0, 1]), 5)
    with pytest.raises(ValueError, match="ntt_impl"):
        tc.eval_bin_gate(tkey, "AND", ct, ct)
    assert boot.accumulator("fourstep") == boot.accumulator(None) == "mega2"


def test_port_gate_leaves_jax_unimported():
    """A TOY gate through each accumulator in a fresh interpreter: neither
    jax nor fhe_tpu is imported."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from fhe_tpu_torch import BinFheContext
        for impl in (None, "mega", "fused"):
            ctx = BinFheContext.generate("TOY", device="cpu", ntt_impl=impl)
            sk = ctx.key_gen(1)
            key = ctx.bt_key_gen(sk, 2)
            m1, m2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
            out = ctx.eval_bin_gate(key, "AND", ctx.encrypt(sk, m1, 3), ctx.encrypt(sk, m2, 4))
            assert ctx.decrypt(sk, out).tolist() == [0, 0, 0, 1], impl
        assert "jax" not in sys.modules
        assert not [m for m in sys.modules if m == "fhe_tpu" or m.startswith("fhe_tpu.")]
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
