"""fhe_tpu_torch CUDA kernels against their plain PyTorch versions, on the
card (byte-equal: every value is an integer residue).

Imports neither jax nor fhe_tpu, so it runs where only the port is
installed.  Every test needs a CUDA device and skips without one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_tpu_torch import BinFheContext
from fhe_tpu_torch.kernels import blind_rotate as kbr
from fhe_tpu_torch.kernels import blind_rotate_br as kbr_br
from fhe_tpu_torch.kernels import launch_counts
from fhe_tpu_torch.kernels import ntt as kntt
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import ntt, primes
from fhe_tpu_torch.tfhe import boot, boot_pallas, make_params, rgsw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(4321)


def _residues(gen, high, shape, dev):
    return torch.from_numpy(gen.integers(0, high, size=shape)).to(dev, torch.int32)


def _same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("N", kntt.sizes())
@pytest.mark.parametrize("q_bits", [27, 31])
def test_ntt_kernels_match_plain(N, q_bits, cuda, gen):
    """Every instantiated N, a prime below 2^30 (lazy butterflies) and one in
    (2^30, 2^31) (canonical), with 1, 3 and P x SMs + 1 rows (the last
    block holds masked rows): both output orders and the round trip."""
    q = primes.last_prime(q_bits, 2 * N)
    assert (q < kntt.LAZY_Q) == (q_bits == 27)
    plan = ntt.make_plan(N, q, cuda)
    for rows in (1, 3, kntt.rows_per_block(N) * _sm_count(cuda) + 1):
        x = _residues(gen, q, (rows, N), cuda)
        f = ntt.ntt_forward(plan, x)
        _same(f, ntt.forward_butterfly(plan, x))
        _same(ntt.ntt_forward(plan, x, out_br=True), ntt.forward_butterfly(plan, x, out_br=True))
        i = ntt.ntt_inverse(plan, f)
        _same(i, ntt.inverse_butterfly(plan, f))
        _same(i, x)


@pytest.mark.parametrize("N", [1 << 17])
def test_ntt_kernels_reject_unlisted_n(N, cuda):
    """An N outside csrc/ntt_shapes.h: ValueError before any launch."""
    plan = ntt.make_plan(N, primes.last_prime(27, 2 * N), cuda)
    x = torch.zeros(2, N, dtype=torch.int32, device=cuda)
    before = launch_counts()
    for fn in (ntt.ntt_forward, ntt.ntt_inverse):
        with pytest.raises(ValueError, match=f"no NTT kernel for N = {N}"):
            fn(plan, x)
    assert launch_counts() == before


def test_ntt_below_eight_is_refused(cuda):
    """N = 4: no plan (fhe_tpu's make_plan refuses it too) and no kernel;
    nothing launched."""
    before = launch_counts()
    with pytest.raises(ValueError, match="power of two >= 8"):
        ntt.make_plan(4, 17, cuda)
    with pytest.raises(ValueError, match="no NTT kernel for N = 4"):
        kntt.check_n(4)
    assert launch_counts() == before


def test_small_n_kernels_count_their_own_launches(cuda, gen):
    """At N = 2^3..2^8 the wrappers launch the small-N kernels, counted as
    ntt_forward_small / ntt_inverse_small."""
    from fhe_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()
    for N in kntt.small_sizes():
        plan = ntt.make_plan(N, primes.last_prime(27, 2 * N), cuda)
        x = _residues(gen, plan.q, (5, N), cuda)
        _same(ntt.ntt_inverse(plan, ntt.ntt_forward(plan, x)), x)
    counts = launch_counts()
    assert counts["ntt_forward_small"] == counts["ntt_inverse_small"] == len(kntt.small_sizes())
    assert counts["ntt_forward"] == counts["ntt_inverse"] == 0


def test_ntt_kernel_rejects_bad_input(cuda):
    plan = ntt.make_plan(1024, 134215681, cuda)
    with pytest.raises(TypeError):
        ntt.ntt_forward(plan, torch.zeros(2, 1024, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ntt.ntt_forward(ntt.make_plan(1024, 134215681),
                        torch.zeros(2, 1024, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("name,steps", [("TOY", 64), ("STD128", 16)])
def test_blind_rotate_kernel_matches_plain(name, steps, cuda, gen):
    p = make_params(name)
    acc = _residues(gen, p.Q, (8, 2, p.N), cuda)
    bsk = _residues(gen, p.Q, (steps, 2, p.digits_g2, 2, p.N), cuda)
    a = _residues(gen, p.q, (8, steps), cuda)
    _same(boot.blind_rotate(p, rgsw.BootstrapKey(bsk=bsk, ksk=None), acc, a),
          boot.blind_rotate_plain(p, bsk, acc, a))


@pytest.mark.parametrize("name,steps", [("TOY", 64), ("STD128", 16)])
def test_blind_rotate_br_kernels_match_plain(name, steps, cuda, gen):
    """Kernel 4 (whole scan), kernel 5 (one step) and kernel 5's n-launch
    loop, bit-reversed order, against their plain versions."""
    p = make_params(name)
    acc = _residues(gen, p.Q, (8, 2, p.N), cuda)
    bsk = _residues(gen, p.Q, (steps, 2, p.digits_g2, 2, p.N), cuda)
    a = _residues(gen, p.q, (8, steps), cuda)
    want = boot_pallas.blind_rotate_mega_plain(p, bsk, acc, a)
    _same(boot_pallas.blind_rotate_mega(p, bsk, acc, a), want)
    _same(boot_pallas.blind_rotate_fused(p, bsk, acc, a), want)
    _same(boot_pallas.rotate_step_br(p, bsk[0], acc, a[:, 0]),
          boot_pallas.rotate_step_br_plain(p, bsk[0], acc, a[:, 0]))


# one GINX parameter set of each instantiated (N, dG2) (csrc/cggi_shapes.h)
SHAPE_PARAMS = {(512, 4): "TOY", (1024, 4): "STD128", (1024, 6): "STD128_3",
                (2048, 4): "STD256", (2048, 6): "STD256Q", (2048, 8): "STD256Q_3",
                (8192, 10): "TOY_RADIX"}


def _rotation_inputs(gen, p, B, steps, dev):
    return (_residues(gen, p.Q, (B, 2, p.N), dev),
            _residues(gen, p.Q, (steps, 2, p.digits_g2, 2, p.N), dev),
            _residues(gen, p.q, (B, steps), dev))


def _check_all_orders(p, acc, bsk, a, q_lwe=None):
    """The scan in both orders and kernel 5's n launches, byte-equal to
    their plain versions, with the mask a mod q_lwe (default q)."""
    pows = boot._psi_powers_mont_words(p.N, p.Q, acc.device)
    bsk_br = boot_pallas.bsk_to_br(p, bsk)
    _same(kbr.blind_rotate(p, bsk_br, acc, a, pows, q_lwe),
          boot.blind_rotate_plain(p, bsk, acc, a, q_lwe))
    want = boot_pallas.blind_rotate_mega_plain(p, bsk_br, acc, a, q_lwe)
    _same(kbr_br.blind_rotate_mega(p, bsk_br, acc, a, pows, q_lwe), want)
    _same(kbr_br.blind_rotate_fused(p, bsk_br, acc, a, pows, q_lwe), want)
    _same(kbr_br.rotate_step_br(p, bsk_br[0], acc, a[:, 0], pows, q_lwe),
          boot_pallas.rotate_step_br_plain(p, bsk_br[0], acc, a[:, 0], q_lwe))


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("shape", sorted(SHAPE_PARAMS))
@pytest.mark.parametrize("B", [1, 3, 8, "4 SMs + 1"])
def test_rotation_kernels_every_shape(shape, B, cuda, gen):
    """Every instantiation, at B = 1, 3 and 8 (one ciphertext per block)
    and at 4 x SMs + 1, the least batch the wrappers run two to a block
    (one masked lane in the last block; the wide step of TOY_RADIX's
    (8192, 10) stays at one); random keys, 4 steps."""
    p = make_params(SHAPE_PARAMS[shape])
    wide = p.N >= kbr.wide_n()
    if B == "4 SMs + 1":
        B = 4 * _sm_count(cuda) + 1
        assert kbr.choose_c(B, _sm_count(cuda), p.N) == (1 if wide else 2)
    else:
        assert kbr.choose_c(B, _sm_count(cuda), p.N) == 1
    before = launch_counts()
    _check_all_orders(p, *_rotation_inputs(gen, p, B, 4, cuda))
    after = launch_counts()
    for name in ("blind_rotate", "blind_rotate_mega", "rotate_step_br"):
        counted, other = (name + "_wide", name) if wide else (name, name + "_wide")
        assert after[counted] > before[counted] and after[other] == before[other]


@pytest.mark.parametrize("name", ["TOY", "STD128"])
def test_rotation_kernels_odd_batch(name, cuda, gen):
    """4097 ciphertexts: the wrappers choose two per block, so the last
    block has one masked lane."""
    p = make_params(name)
    acc, bsk, a = _rotation_inputs(gen, p, 4097, 4, cuda)
    assert kbr.choose_c(4097, _sm_count(cuda)) == 2
    _check_all_orders(p, acc, bsk, a)


def test_rotation_kernels_reject_unsupported_shape(cuda, gen):
    """No instantiation for TOY_RADIX's ring doubled (N = 16384):
    ValueError before any launch, on every wrapper."""
    p = dataclasses.replace(make_params("TOY_RADIX"), N=16384)
    acc, bsk, a = _rotation_inputs(gen, p, 1, 1, cuda)
    pows = boot._psi_powers_mont_words(p.N, p.Q, cuda)
    before = launch_counts()
    for fn in (kbr.blind_rotate, kbr_br.blind_rotate_mega, kbr_br.blind_rotate_fused):
        with pytest.raises(ValueError, match="no blind-rotation kernel"):
            fn(p, bsk, acc, a, pows)
    assert launch_counts() == before


@pytest.mark.parametrize("q_lwe", ["2N", "N"])
@pytest.mark.parametrize("B", [1, 3])
def test_wide_rotation_kernels_match_plain(q_lwe, B, cuda, gen):
    """Kernels 3, 4 and 5 on the wide step at TOY_RADIX's (8192, 10), the
    mask mod q = N (a gate, a periodic LUT) or 2q = 2N (an arbitrary LUT),
    byte-equal to their plain versions; random keys, 4 steps."""
    p = make_params("TOY_RADIX")
    q_lwe = {"2N": 2 * p.N, "N": p.N}[q_lwe]
    acc, bsk, _ = _rotation_inputs(gen, p, B, 4, cuda)
    _check_all_orders(p, acc, bsk, _residues(gen, q_lwe, (B, 4), cuda), q_lwe)


@pytest.mark.parametrize("q_lwe", ["2N", "N", "N/2", "N/4"])
@pytest.mark.parametrize("B", [1, 8, "4 SMs + 1"])
def test_rotation_kernels_at_each_lwe_modulus(q_lwe, B, cuda, gen):
    """Kernels 3, 4 and 5 at STD128's shape with the mask mod q_lwe (the
    functional bootstrap's ct_mod: 2N/q_lwe = 1, 2, 4, 8), byte-equal to
    their plain versions; random keys, 4 steps."""
    p = make_params("STD128")
    q_lwe = {"2N": 2 * p.N, "N": p.N, "N/2": p.N // 2, "N/4": p.N // 4}[q_lwe]
    B = 4 * _sm_count(cuda) + 1 if B == "4 SMs + 1" else B
    acc, bsk, _ = _rotation_inputs(gen, p, B, 4, cuda)
    _check_all_orders(p, acc, bsk, _residues(gen, q_lwe, (B, 4), cuda), q_lwe)


@pytest.mark.parametrize("q_lwe", [3 * 256, 4096, 1])
def test_rotation_kernels_refuse_lwe_modulus(q_lwe, cuda, gen):
    """An LWE modulus that is not a power of two >= 2 dividing 2N:
    ValueError before any launch, on every wrapper."""
    p = make_params("STD128")
    acc, bsk, a = _rotation_inputs(gen, p, 2, 1, cuda)
    pows = boot._psi_powers_mont_words(p.N, p.Q, cuda)
    before = launch_counts()
    for fn in (kbr.blind_rotate, kbr_br.blind_rotate_mega, kbr_br.blind_rotate_fused):
        with pytest.raises(ValueError, match=f"LWE modulus {q_lwe} must be a power of two"):
            fn(p, bsk, acc, a, pows, q_lwe)
    assert launch_counts() == before


KERNEL_OF = {None: "blind_rotate", "mega": "blind_rotate_mega", "fused": "rotate_step_br"}


@pytest.mark.parametrize("impl", [None, "mega", "fused"])
def test_medium_funcboot_on_card_matches_cpu(impl, cuda):
    """MEDIUM with n cut to 8: eval_func (arbitrary LUT, ct_mod 2q = 2N),
    eval_floor and eval_sign at 2q (its last bootstrap at q/2) and
    eval_floor at 8q on the card equal the plain CPU pipeline byte for
    byte (at 8q some floors are wrong on both: the bootstrap noise there is
    a good part of beta); each bootstrap launches the accumulator's kernel
    (once, or n times for "fused") and kernels 1 and 2 once."""
    outs = []
    m = np.random.default_rng(6).integers(0, 8, size=16)
    for dev in ("cpu", cuda):
        ctx = BinFheContext(params=dataclasses.replace(make_params("MEDIUM"), n=8),
                            device=torch.device(dev), ntt_impl=impl)
        q, n = ctx.params.q, ctx.params.n
        sk = ctx.key_gen(1)
        key = ctx.bt_key_gen(sk, 2)
        lut = ctx.generate_lut(lambda x, p: (x + 1) % p, 4)
        ct = ctx.encrypt(sk, m % 4, 3)
        wide = ctx.encrypt(sk, m, 4, p=8, modulus=2 * q)
        before = launch_counts()
        out = [ctx.eval_func(key, ct, lut), ctx.eval_floor(key, wide), ctx.eval_sign(key, wide),
               ctx.eval_floor(key, ctx.encrypt(sk, m, 5, p=8, modulus=8 * q))]
        after = launch_counts()
        np.testing.assert_array_equal(ctx.decrypt(sk, out[0]).cpu().numpy(), (m + 1) % 4)
        np.testing.assert_array_equal(ctx.decrypt(sk, out[1], 2).cpu().numpy(), m >= 4)
        np.testing.assert_array_equal(ctx.decrypt(sk, out[2], 2).cpu().numpy(), m >= 4)
        boots = 2 + 2 + 3 + 2
        per_boot = {KERNEL_OF[impl]: n if impl == "fused" else 1, "ntt_forward": 1,
                    "ntt_inverse": 1}
        for kernel in after:
            want = 0 if dev == "cpu" else boots * per_boot.get(kernel, 0)
            assert after[kernel] - before[kernel] == want, kernel
        outs.append([o.to("cpu") for o in out])
    for got, want in zip(outs[1], outs[0]):
        _same(got.a, want.a)
        _same(got.b, want.b)


@pytest.mark.parametrize("impl", [None, "mega", "fused"])
def test_toy_gate_on_card_matches_cpu(impl, cuda):
    """The whole TOY gate on the card, through each accumulator, equals the
    plain CPU pipeline."""
    outs = []
    for dev in ("cpu", cuda):
        ctx = BinFheContext.generate("TOY", device=dev, ntt_impl=impl)
        sk = ctx.key_gen(1)
        key = ctx.bt_key_gen(sk, 2)
        m1, m2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        before = launch_counts()[KERNEL_OF[impl]]
        out = ctx.eval_bin_gate(key, "XOR", ctx.encrypt(sk, m1, 3), ctx.encrypt(sk, m2, 4))
        assert ctx.decrypt(sk, out).tolist() == [0, 1, 1, 0]
        assert (launch_counts()[KERNEL_OF[impl]] > before) == (dev != "cpu")
        outs.append(out.to("cpu"))
    _same(outs[1].a, outs[0].a)
    _same(outs[1].b, outs[0].b)


@pytest.mark.parametrize("name,method", [("TOY", "AP"), ("TOY_LMKCDEY", None)])
def test_toy_dm_lmkcdey_gate_on_card_matches_cpu(name, method, cuda):
    """TOY with method AP and TOY_LMKCDEY: keys and the whole AND gate on
    the card (PyTorch ops around kernels 1 and 2) equal the plain CPU
    pipeline byte for byte; the rotation kernels 3-5 launch 0 times."""
    outs, keys = [], []
    rng = np.random.default_rng(3)
    m1, m2 = rng.integers(0, 2, size=(2, 64))
    for dev in ("cpu", cuda):
        ctx = BinFheContext.generate(name, method=method, device=dev)
        sk = ctx.key_gen(1)
        keys.append(ctx.bt_key_gen(sk, 2).to("cpu"))
        key = keys[-1].to(dev)
        ct1, ct2 = ctx.encrypt(sk, m1, 3), ctx.encrypt(sk, m2, 4)
        before = launch_counts()
        out = ctx.eval_bin_gate(key, "AND", ct1, ct2)
        after = launch_counts()
        np.testing.assert_array_equal(ctx.decrypt(sk, out).cpu().numpy(), m1 & m2)
        for kernel in KERNEL_OF.values():
            assert after[kernel] == before[kernel]
        for kernel in ("ntt_forward", "ntt_inverse"):
            assert (after[kernel] > before[kernel]) == (dev != "cpu")
        outs.append(out.to("cpu"))
    for got, want in zip(vars(keys[1]).values(), vars(keys[0]).values()):
        if isinstance(want, torch.Tensor):
            _same(got, want)
    _same(keys[1].ksk.a, keys[0].ksk.a)
    _same(outs[1].a, outs[0].a)
    _same(outs[1].b, outs[0].b)


# the limbs of STD192 and STD128Q_3 (a 26-bit limb), each NTT primes for
# N <= 2048, and a third limb above 2^30 (canonical arithmetic)
LIMBS = {"STD192": (520193, 495617), "STD128Q_3": (33550337, 67104769)}


@pytest.mark.parametrize("N", [1024, 2048])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(LIMBS))
def test_limb_stacked_ntt_kernels_match_plain(name, L, N, cuda, gen):
    """The limb-stacked kernels against their plain per-limb loop, byte for
    byte, with 1, 3 and P x SMs + 1 rows of L limbs (L = 3 adds a limb above
    2^30, so the launch takes the canonical arithmetic), and the round trip."""
    moduli = (LIMBS[name] + (primes.last_prime(31, 4096),))[:L]
    plan = rns.make_rns_plan(N, moduli, cuda)
    before = launch_counts()
    for rows in (1, 3, kntt.rows_per_block(N) * _sm_count(cuda) + 1):
        x = torch.stack([_residues(gen, q, (rows, N), cuda) for q in moduli], dim=1)
        f = rns.ntt_forward(plan, x)
        _same(f, rns.forward_plain(plan, x))
        i = rns.ntt_inverse(plan, f)
        _same(i, rns.inverse_plain(plan, f))
        _same(i, x)
    after = launch_counts()
    assert after["ntt_forward_limbs"] - before["ntt_forward_limbs"] == 3
    assert after["ntt_inverse_limbs"] - before["ntt_inverse_limbs"] == 3
    assert after["ntt_forward"] == before["ntt_forward"]


@pytest.mark.parametrize("L", [1, 3, 11, 16])
def test_limb_stacked_ntt_kernels_at_ckks_width(L, cuda, gen):
    """N = 2^14 (CKKS bench config 3) with 1, 3, 11 (its Q u P) and 16
    limbs (kMaxLimbs), 1, 3 and SMs + 1 rows: byte-equal to the per-limb
    loop, and the round trip."""
    N = 1 << 14
    moduli = primes.ntt_primes(L, N, 1 << 30)
    plan = rns.make_rns_plan(N, moduli, cuda)
    for rows in (1, 3, kntt.rows_per_block(N) * _sm_count(cuda) + 1):
        x = torch.stack([_residues(gen, q, (rows, N), cuda) for q in moduli], dim=1)
        f = rns.ntt_forward(plan, x)
        _same(f, rns.forward_plain(plan, x))
        i = rns.ntt_inverse(plan, f)
        _same(i, rns.inverse_plain(plan, f))
        _same(i, x)


@pytest.mark.parametrize("L", [1, 3, 8, 16])
def test_limb_stacked_ntt_kernels_at_bfv_width(L, cuda, gen):
    """N = 2^15 (BFV bench config 4) with 1, 3 (its Q), 8 (its Q u R) and
    16 limbs, 1, 3 and SMs + 1 rows (one row a block): byte-equal to the
    per-limb loop, and the round trip."""
    N = 1 << 15
    moduli = primes.ntt_primes(L, N, 1 << 30)
    plan = rns.make_rns_plan(N, moduli, cuda)
    for rows in (1, 3, kntt.rows_per_block(N) * _sm_count(cuda) + 1):
        x = torch.stack([_residues(gen, q, (rows, N), cuda) for q in moduli], dim=1)
        f = rns.ntt_forward(plan, x)
        _same(f, rns.forward_plain(plan, x))
        i = rns.ntt_inverse(plan, f)
        _same(i, rns.inverse_plain(plan, f))
        _same(i, x)


def test_bfv_bgv_on_card_match_cpu(cuda):
    """BFV (HPS and BEHZ products, relinearized) and BGV (product, two
    mod_reduce, a rotation) at N = 2^15, keyed on the CPU and on the card
    from one seed: the same ciphertexts, and the NTT kernels launched for
    the card's only."""
    from fhe_tpu_torch.pke import bfv, bgv
    m = np.random.default_rng(5).integers(0, 100, size=1 << 15)
    outs = []
    for dev in ("cpu", cuda):
        ctx = bfv.BfvContext.create(N=1 << 15, num_limbs=3, dnum=3, device=dev)
        rng = np.random.default_rng(6)
        sk, pk = ctx.keygen(rng)
        evk = ctx.relin_key_gen(sk, rng)
        ct = ctx.encrypt(pk, m, rng)
        before = launch_counts()
        prods = [ctx.mul(ct, ct, evk, technique=t) for t in ("hps", "behz")]
        after = launch_counts()
        assert (after["ntt_forward_limbs"] > before["ntt_forward_limbs"]) == (dev != "cpu")
        for p in prods:
            np.testing.assert_array_equal(ctx.decrypt(sk, p), m * m % ctx.t)
        g = bgv.BgvContext.create(N=1 << 15, num_levels=3, dnum=3, device=dev)
        sk, pk = g.keygen(rng)
        gct = g.encrypt(pk, m, rng)
        red = g.mod_reduce(g.mod_reduce(g.mul(gct, gct, g.relin_key_gen(sk, rng))))
        rot = g.rotate(gct, 1, g.rotation_key_gen(sk, [1], rng))
        np.testing.assert_array_equal(g.decrypt(sk, red), m * m % g.t)
        outs.append([c.to("cpu") for p in prods + [red, rot] for c in (p.c0.data, p.c1.data)])
    for got, want in zip(outs[1], outs[0]):
        _same(got, want)


def test_limb_stacked_ntt_kernels_reject_too_many_limbs(cuda):
    """More limbs than csrc/ntt_launch.h's kMaxLimbs: ValueError before any
    launch; so is a wrong limb axis."""
    L = kntt.max_limbs() + 1
    moduli = primes.ntt_primes(L, 1024, 1 << 30)
    plan = rns.make_rns_plan(1024, moduli, cuda)
    before = launch_counts()
    for fn in (rns.ntt_forward, rns.ntt_inverse):
        with pytest.raises(ValueError, match=f"1 to {L - 1} limbs, got {L}"):
            fn(plan, torch.zeros(2, L, 1024, dtype=torch.int32, device=cuda))
        with pytest.raises(ValueError, match="limbs|L, N|1024"):
            fn(rns.make_rns_plan(1024, moduli[:2], cuda),
               torch.zeros(2, 3, 1024, dtype=torch.int32, device=cuda))
    assert launch_counts() == before


def test_toy_rns_gate_on_card_matches_cpu(cuda):
    """TOY_RNS: keys and the whole AND and XOR gates on the card (PyTorch ops
    around the limb-stacked kernels) equal the plain CPU pipeline byte for
    byte; n + 1 launches of each limb-stacked kernel a gate, none of the
    others."""
    outs, keys = [], []
    rng = np.random.default_rng(5)
    m1, m2 = rng.integers(0, 2, size=(2, 64))
    for dev in ("cpu", cuda):
        ctx = BinFheContext.generate("TOY_RNS", device=dev)
        sk = ctx.key_gen(1)
        keys.append(ctx.bt_key_gen(sk, 2).to("cpu"))
        key = keys[-1].to(dev)
        ct1, ct2 = ctx.encrypt(sk, m1, 3), ctx.encrypt(sk, m2, 4)
        before = launch_counts()
        out = [ctx.eval_bin_gate(key, gate, ct1, ct2) for gate in ("AND", "XOR")]
        after = launch_counts()
        np.testing.assert_array_equal(ctx.decrypt(sk, out[0]).cpu().numpy(), m1 & m2)
        np.testing.assert_array_equal(ctx.decrypt(sk, out[1]).cpu().numpy(), m1 ^ m2)
        n = ctx.params.n
        for kernel in after:
            want = 2 * (n + 1) if kernel.endswith("_limbs") and dev != "cpu" else 0
            assert after[kernel] - before[kernel] == want, kernel
        outs.append([o.to("cpu") for o in out])
    _same(keys[1].bsk, keys[0].bsk)
    _same(keys[1].ksk.a, keys[0].ksk.a)
    for got, want in zip(outs[1], outs[0]):
        _same(got.a, want.a)
        _same(got.b, want.b)


def test_euint8_add_on_card_matches_cpu(cuda):
    """An euint8 add on the card equals the CPU's byte for byte: TOY_RADIX
    with n cut to 4, the keys made on the CPU and moved to the card; five
    lazy adds, the last of which propagates the carries first (a ripple of
    4 limbs: 7 LUTs, 14 bootstraps, each one launch of the wide kernel 3
    on the card)."""
    from fhe_tpu_torch.tfhe.fhevm import FheContext, FheType
    p = dataclasses.replace(make_params("TOY_RADIX"), n=4)
    cpu = FheContext.keyed(BinFheContext(params=p, device=torch.device("cpu")), 5)
    card = FheContext(ctx=BinFheContext(params=p, device=cuda), key=cpu.key.to(cuda),
                      sk=cpu.sk.to(cuda), sk_n=cpu.sk_n.to(cuda))
    a, b = np.random.default_rng(6).integers(0, 256, size=(2, 3))
    outs = []
    for fc in (cpu, card):
        s, xb = fc.encrypt(a, FheType.EUINT8, 7), fc.encrypt(b, FheType.EUINT8, 8)
        before = launch_counts()
        for _ in range(5):
            s = fc.add(s, xb)
        after = launch_counts()
        assert [int(v) for v in fc.decrypt(s)] == list((a + 5 * b) % 256)
        assert after["blind_rotate_wide"] - before["blind_rotate_wide"] == (
            0 if fc is cpu else 14)
        outs.append(s.value.ct.to("cpu"))
    _same(outs[1].a, outs[0].a)
    _same(outs[1].b, outs[0].b)


# bench config 5 (bench.py:330): the threshold decrypt's ring
MP_CONFIG = dict(N=1 << 12, num_levels=3, scale_bits=29, dnum=2)


@pytest.mark.parametrize("basis", ["Q", "Q u P"])
def test_limb_stacked_ntt_kernels_at_threshold_width(basis, cuda, gen):
    """N = 2^12 over bench config 5's own moduli, Q (4 limbs: the shares and
    the fusion) and Q u P (6: the keys), at 1 row and 5 (one a party, the
    pipeline's floods): byte-equal to the per-limb loop, and the round
    trip."""
    from fhe_tpu_torch.pke import ckks
    p = ckks.CkksContext.create(**MP_CONFIG, device="cpu").params
    moduli = tuple(p.moduli) + (tuple(p.special_mods) if basis == "Q u P" else ())
    plan = rns.make_rns_plan(p.N, moduli, cuda)
    for rows in (1, 5):
        x = torch.stack([_residues(gen, q, (rows, p.N), cuda) for q in moduli], dim=1)
        f = rns.ntt_forward(plan, x)
        _same(f, rns.forward_plain(plan, x))
        i = rns.ntt_inverse(plan, f)
        _same(i, rns.inverse_plain(plan, f))
        _same(i, x)


def test_flood_zero_shares_on_card_match_cpu(cuda):
    """Bench config 5's 5-party keys and ciphertext made from one seed on
    the CPU and on the card: each party's share with the flood at 0, and
    the pipeline's fusion at flood 0, byte-equal; the card's flooded
    pipeline decodes within bench.py's 5 sigma_slot, through the
    limb-stacked kernels."""
    from fhe_tpu_torch.pke import ckks, multiparty
    outs = []
    for dev in ("cpu", cuda):
        ctx = ckks.CkksContext.create(**MP_CONFIG, device=dev)
        p = ctx.params
        rng = np.random.default_rng(3)
        sks, pk = multiparty.multiparty_keygen(p, 5, rng, device=dev)
        z = rng.normal(size=p.N // 2)
        ct = ctx.encrypt(pk, z, rng)
        mods = tuple(ct.moduli)
        s_stack = torch.stack([sk.eval_poly(mods).data for sk in sks])
        zero = torch.zeros(5, p.N, dtype=torch.int64, device=dev)
        outs.append([multiparty._share(mods, 1, i == 0, s_stack[i], ct.c1.data, ct.c0.data,
                                       zero[i]).cpu() for i in range(5)] +
                    [multiparty._pipeline(mods, 1, s_stack, ct.c0.data, ct.c1.data, zero).cpu()])
    for got, want in zip(outs[1], outs[0]):
        _same(got, want)
    before = launch_counts()
    ph = multiparty.threshold_decrypt_pipeline(p, sks, ct.c0, ct.c1, np.random.default_rng(5))
    after = launch_counts()
    assert after["ntt_forward_limbs"] - before["ntt_forward_limbs"] == 1
    assert after["ntt_inverse_limbs"] - before["ntt_inverse_limbs"] == 1
    m = ckks._center(rns.to_bigint(ph), rns.modulus_product(ph.moduli))
    got = ckks.decode(m, p.N, ct.scale).real
    assert np.abs(got - z).max() < 5 * multiparty.MP_SD * np.sqrt(5 * p.N) / ct.scale


@pytest.mark.parametrize("N,L", [(1 << 15, 58), (1 << 15, 64), (1 << 16, 1), (1 << 16, 3),
                                 (1 << 16, 58), (1 << 16, 64)])
def test_limb_stacked_ntt_kernels_at_bootstrap_width(N, L, cuda, gen):
    """The bootstrapping set's Q u P (58 limbs) and kMaxLimbs (64) at N =
    2^15 and at N = 2^16 (the split kernels), 1, 3 and SMs + 1 rows:
    byte-equal to the plain versions, and the round trip."""
    moduli = primes.ntt_primes(L, N, 1 << 30)
    plan = rns.make_rns_plan(N, moduli, cuda)
    tgen = torch.Generator(device=cuda).manual_seed(int(gen.integers(1 << 62)))
    for rows in (1, 3, kntt.rows_per_block(N) * _sm_count(cuda) + 1):
        x = (torch.randint(0, 1 << 62, (rows, L, N), generator=tgen, device=cuda) %
             plan.q).to(torch.int32)
        f = rns.ntt_forward(plan, x)
        _same(f, rns.forward_plain(plan, x))
        i = rns.ntt_inverse(plan, f)
        _same(i, rns.inverse_plain(plan, f))
        _same(i, x)


def test_bootstrap_on_card_matches_cpu(cuda):
    """The bootstrapping chain's shape (composite degree 2, 22 levels, dnum
    = 4: 46 + 12 limbs, level scales tracked) at N = 2^11, keyed from one
    seed on the CPU and on the card: the SPARSE_ENCAPSULATED level-budget
    (3, 3) bootstrap gives the same ciphertext, decrypted within fhe_tpu's
    1e-3, through the limb-stacked kernels only."""
    from fhe_tpu_torch.pke import bootstrap, ckks, params
    p = params.make_ckks_params(N=1 << 11, num_levels=22, scale_bits=52, composite_degree=2,
                                first_bits=60, dnum=4, track_scale=True)
    outs = []
    for dev in ("cpu", cuda):
        ctx = ckks.CkksContext(p, torch.device(dev))
        rng = np.random.default_rng(9)
        sk, pk = ctx.keygen(rng)
        pre = bootstrap.setup(ctx, h=64, level_budget=(3, 3))
        keys = bootstrap.keygen(ctx, sk, pre, rng, encapsulate_h=64)
        z = rng.uniform(-0.4, 0.4, size=p.N // 2)
        ct = ctx.encrypt(pk, z, rng)
        drop = len(ct.moduli) - ctx.cd
        ct = ckks.Ciphertext(rns.level_reduce(ct.c0, drop), rns.level_reduce(ct.c1, drop),
                             ct.scale)
        before = launch_counts()
        out = bootstrap.eval_bootstrap(ctx, ct, pre, keys)
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert set(launched) == (set() if dev == "cpu" else
                                 {"ntt_forward_limbs", "ntt_inverse_limbs"})
        assert np.abs(ctx.decrypt(sk, out).real - z).max() < 1e-3
        outs.append((out.scale, out.moduli, out.c0.data.cpu(), out.c1.data.cpu()))
    assert outs[0][:2] == outs[1][:2]
    _same(outs[1][2], outs[0][2])
    _same(outs[1][3], outs[0][3])


def test_schemelet_product_on_card_matches_cpu(cuda):
    """The FBT schemelet's exact negacyclic product (pke/fbt.py
    _negacyclic_mul: NTTs over three 31-bit primes, a centred CRT) at
    N = 2^11, a below 2^63 against a ternary secret: the card's integers
    are the CPU's, through the limb-stacked kernels."""
    from fhe_tpu_torch.pke import fbt
    rng = np.random.default_rng(15)
    a = np.array([int(x) << 1 | int(y) for x, y in zip(rng.integers(0, 1 << 62, size=2048),
                                                       rng.integers(0, 2, size=2048))],
                 dtype=object)
    s = np.array([int(x) for x in rng.integers(-1, 2, size=2048)], dtype=object)
    before = launch_counts()
    got = fbt._negacyclic_mul(a, s, cuda)
    after = launch_counts()
    assert {k for k in after if after[k] != before[k]} == {"ntt_forward_limbs",
                                                           "ntt_inverse_limbs"}
    assert [int(x) for x in got] == [int(x) for x in fbt._negacyclic_mul(a, s, "cpu")]


def test_extract_lwe_all_on_card_matches_cpu(cuda, gen):
    """schemeswitch.extract_lwe_all's rows (one gather of the first num
    rows) at N = 2^11, all of them and the first 1024, card against CPU."""
    from fhe_tpu_torch.pke import schemeswitch as ss
    q = 1073479681
    c0 = _residues(gen, q, (2048,), "cpu")
    c1 = _residues(gen, q, (2048,), "cpu")
    for num in (None, 1024):
        want = ss.extract_lwe_all(c0, c1, q, 4, num=num)
        got = ss.extract_lwe_all(c0.to(cuda), c1.to(cuda), q, 4, num=num)
        _same(got.a.cpu(), want.a)
        _same(got.b.cpu(), want.b)


FBT_SMALL = dict(N=1 << 11, num_levels=18, scale_bits=26, dnum=3, first_bits=30)


@pytest.mark.parametrize("slots", [None, 256], ids=["dense", "sparse"])
def test_fbt_on_card_matches_cpu(slots, cuda):
    """pke/fbt.py eval_fbt at N = 2^11 on fhe_tpu's FBT chain (18 levels of
    26 bits, dnum = 3, a weight-4 secret, r = 2), keyed from one seed on
    the CPU and on the card: fully packed (2048 digits) and sparse (256
    slots, 512 digits, d = 4); the same ciphertext, (3x + 2) mod 4 exact."""
    from fhe_tpu_torch.pke import ckks, fbt
    outs = []
    for dev in ("cpu", cuda):
        ctx = ckks.CkksContext.create(device=dev, **FBT_SMALL)
        N = ctx.params.N
        rng = np.random.default_rng(12)
        sk, _ = ctx.keygen(rng, h=4)
        pre = fbt.setup(ctx, h=4, r=2, slots=slots)
        keys = fbt.keygen(ctx, sk, pre, rng)
        stride = 1 if slots is None else N // (2 * slots)
        vals = rng.integers(0, 4, size=N // stride)
        msg = np.zeros(N, dtype=np.int64)
        msg[::stride] = vals
        ct = fbt.convert_rlwe_to_ckks(ctx, fbt.encrypt_coeff(ctx, sk, msg, 1 << 33, 4, rng),
                                      num_values=None if slots is None else N // stride)
        coeffs = fbt.get_hermite_trig_coefficients(lambda x: (3 * x + 2) % 4, 4, 2)
        out = fbt.eval_fbt(ctx, ct, coeffs, pre, keys)
        got = fbt.decrypt_coeff(ctx, sk, fbt.convert_ckks_to_rlwe(ctx, out, 1 << 33,
                                                                  target_delta=(1 << 33) / 4), 4)
        np.testing.assert_array_equal(got[::stride], (3 * vals + 2) % 4)
        outs.append((out.scale, out.moduli, out.c0.data.cpu(), out.c1.data.cpu()))
    assert outs[0][:2] == outs[1][:2]
    _same(outs[1][2], outs[0][2])
    _same(outs[1][3], outs[0][3])


def test_ckks_to_fhew_on_card_matches_cpu(cuda):
    """schemeswitch.eval_ckks_to_fhew at N = 2^11 (15 levels, 26 bits, dnum
    = 2) to TOY's (n, q), setup and keys from one seed on the CPU and on
    the card: the same LWE ciphertexts, all 1024 integers in [0, 4) exact."""
    from fhe_tpu_torch.pke import ckks
    from fhe_tpu_torch.pke import schemeswitch as ss
    outs = []
    for dev in ("cpu", cuda):
        ctx = ckks.CkksContext.create(N=1 << 11, num_levels=15, scale_bits=26, dnum=2,
                                      device=dev)
        tctx = BinFheContext.generate("TOY", device=dev)
        rng = np.random.default_rng(13)
        sk, pk = ctx.keygen(rng)
        tsk = tctx.key_gen(rng)
        key = ss.ckks_to_fhew_setup(ctx, sk, tctx.params, tsk, rng)
        z = rng.integers(0, 4, size=1024)
        cts = ss.eval_ckks_to_fhew(ctx, key, ctx.encrypt(pk, z.astype(np.float64), rng), p=4,
                                   fhew_params=tctx.params)
        np.testing.assert_array_equal(tctx.decrypt(tsk, cts, p=4).cpu().numpy(), z)
        outs.append((cts.a.cpu(), cts.b.cpu()))
    _same(outs[1][0], outs[0][0])
    _same(outs[1][1], outs[0][1])


def test_trapdoor_and_arb_on_card_match_cpu(cuda):
    """lattice/trapdoor.py at N = 64 (the small-N kernels) and N = 1024, and
    math/ntt_arb.py's multiply_arb at m = 15 (L = 64) and m = 1733 (L =
    8192), on the card against the CPU from one seed; every preimage
    verifies."""
    from fhe_tpu_torch.lattice import trapdoor
    from fhe_tpu_torch.math import ntt_arb
    for N, bits in ((64, 27), (1024, 27)):
        xs = []
        for dev in ("cpu", cuda):
            rng = np.random.default_rng(N)
            p = trapdoor.TrapdoorParams(N=N, q=primes.last_prime(bits, 2 * N))
            td = trapdoor.trapdoor_gen(p, rng, device=dev)
            u = rng.integers(0, p.q, size=N)
            x = trapdoor.gauss_samp_corrected(td, u, rng)
            assert trapdoor.verify_preimage(td, x, u)
            xs.append((td.a_row.cpu(), x.cpu(), trapdoor.gauss_samp(td, u, rng).cpu()))
        for got, want in zip(xs[1], xs[0]):
            _same(got, want)
    for m in (15, 1733):
        q = primes.first_prime(28, 2 * m)
        phi = len(ntt_arb.cyclotomic_poly(m)) - 1
        rng = np.random.default_rng(m)
        a, b = rng.integers(0, q, size=phi), rng.integers(0, q, size=phi)
        got = ntt_arb.multiply_arb(a, b, m, q, device=cuda)
        assert [int(v) for v in got] == [int(v) for v in ntt_arb.multiply_arb(a, b, m, q,
                                                                                device="cpu")]


def test_threshold_on_card_matches_cpu(cuda, monkeypatch):
    """tfhe/threshold.py's additive 3-of-3 with proofs on a TOY batch on the
    card against the same on the CPU, one secrets stream each."""
    from fhe_tpu_torch.tfhe import threshold as th
    outs = []
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(7)
        monkeypatch.setattr("secrets.token_bytes", lambda n: rng.bytes(n))
        ctx = BinFheContext.generate("TOY", device=dev)
        sk = ctx.key_gen(1)
        m = np.arange(64) % 2
        ct = ctx.encrypt(sk, m, 2)
        cfg = th.ThresholdConfig(threshold=3, total_parties=3)
        shares, vks = th.generate_key_shares(sk.s, ct.modulus, cfg)
        pd, proof = th.batch_partial_decrypt(cfg, ct, shares[0])
        assert th.batch_verify_proofs(cfg, ct, pd, proof, vks[0])
        got = th.threshold_decrypt(cfg, ct, shares, vks, p=4)
        np.testing.assert_array_equal(got.cpu().numpy() % 2, m)
        outs.append((pd.values.cpu(), proof.response.cpu(), proof.merkle_root, got.cpu()))
    _same(outs[1][0], outs[0][0])
    _same(outs[1][1], outs[0][1])
    assert outs[1][2] == outs[0][2]
    _same(outs[1][3], outs[0][3])


def test_server_on_card_matches_direct_calls(cuda):
    """The port's server on the card, over HTTP on an ephemeral port: STD128
    keygen, encrypt of 64 bit pairs, AND and NOT; every archive equals the
    port's BinFheContext called directly from the same seeds (the
    encryptions also the CPU port's), and the outputs decrypt right."""
    import base64
    import json
    import threading
    import urllib.request
    from fhe_tpu_torch import server
    from fhe_tpu_torch.utils import serial

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode())
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    httpd = server.make_server(0, device=cuda)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health") as r:
            assert json.loads(r.read())["backend"] == "cuda"
        cid = post("/context", {"param_set": "STD128"})["context_id"]
        kid = post("/keygen", {"context_id": cid, "seed": 5})["key_id"]
        rng = np.random.default_rng(6)
        m1, m2 = rng.integers(0, 2, size=(2, 64))
        cts = [post("/encrypt", {"context_id": cid, "key_id": kid, "bits": m.tolist(),
                                 "seed": s})["ciphertext"] for m, s in ((m1, 7), (m2, 8))]
        and_ct = post("/v1/eval/and", {"context_id": cid, "key_id": kid, "ct1": cts[0],
                                       "ct2": cts[1]})["ciphertext"]
        not_ct = post("/not", {"context_id": cid, "ciphertext": and_ct})["ciphertext"]
        bits = [post("/decrypt", {"context_id": cid, "key_id": kid, "ciphertext": c})["bits"]
                for c in (and_ct, not_ct)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    b64 = lambda ct: base64.b64encode(serial.dumps(ct)).decode()
    ctx = BinFheContext.generate("STD128", device=cuda)
    krng = np.random.default_rng(5)
    sk = ctx.key_gen(krng)
    key = ctx.bt_key_gen(sk, krng)
    direct = [ctx.encrypt(sk, m, np.random.default_rng(s)) for m, s in ((m1, 7), (m2, 8))]
    assert cts == [b64(c) for c in direct]
    cpu = BinFheContext.generate("STD128", device="cpu")
    cpu_sk = cpu.key_gen(np.random.default_rng(5))
    assert cts[0] == b64(cpu.encrypt(cpu_sk, m1, np.random.default_rng(7)))
    out = ctx.eval_bin_gate(key, "AND", *direct)
    assert and_ct == b64(out) and not_ct == b64(ctx.eval_not(out))
    assert bits == [(m1 & m2).tolist(), (1 - (m1 & m2)).tolist()]


def test_capi_on_card_matches_direct_calls(cuda):
    """libfhecapi with its registries on the card: lux_fhe_has_gpu is 1;
    STD128 gates through the ABI on every input pair decrypt right and
    marshal to the bytes of capi_impl's functions called directly on the
    card from the same seed."""
    import ctypes
    import os
    import shutil
    import sysconfig
    from fhe_tpu_torch.native import capi, capi_impl
    if shutil.which("g++") is None or not os.path.exists(
            os.path.join(sysconfig.get_paths()["include"], "Python.h")):
        pytest.skip("needs g++ and this interpreter's Python.h")
    capi_impl.set_device(cuda)
    lib = capi.get_lib()
    assert lib.lux_fhe_has_gpu() == 1

    def handle(call, *args):
        out = ctypes.c_void_p()
        assert call(*args, ctypes.byref(out)) == 0
        return out

    def marshal(ct):
        data, n = capi._u8p(), ctypes.c_int64()
        assert lib.lux_fhe_ciphertext_marshal(ct, ctypes.byref(data), ctypes.byref(n)) == 0
        raw = ctypes.string_at(data, n.value)
        lib.lux_fhe_bytes_free(data)
        return raw

    ctx = handle(lib.lux_fhe_context_new, b"STD128", b"GINX")
    sk = handle(lib.lux_fhe_keygen_secret, ctx, 9)
    bsk = handle(lib.lux_fhe_keygen_bootstrap, ctx, sk)
    cts = {b: handle(lib.lux_fhe_encrypt, ctx, sk, b) for b in (0, 1)}
    h = capi_impl.context_new("STD128")
    psk = capi_impl.keygen_secret(h, 9)
    pbk = capi_impl.keygen_bootstrap(h, psk)
    pcts = {b: capi_impl.encrypt(h, psk, b) for b in (0, 1)}
    for a in (0, 1):
        for b in (0, 1):
            out = handle(lib.lux_fhe_xor, ctx, bsk, cts[a], cts[b])
            res = ctypes.c_int()
            assert lib.lux_fhe_decrypt(ctx, sk, out, ctypes.byref(res)) == 0
            assert res.value == a ^ b
            assert marshal(out) == capi_impl.ciphertext_marshal(
                capi_impl.eval_gate(h, pbk, "XOR", pcts[a], pcts[b]))
