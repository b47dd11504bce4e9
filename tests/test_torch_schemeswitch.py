"""fhe_tpu_torch's CKKS <-> FHEW scheme switching (pke/schemeswitch.py) on
the CPU: the extraction rows and both setups' keys byte-equal to fhe_tpu's
(the ring-to-FHEW switching key to fhe_tpu's own key_switch_gen), and
CKKS -> FHEW (ring extraction and the full switch) and FHEW -> CKKS
(binary and p-ary) byte-equal to fhe_tpu's schemeswitch.py run over the
port's ops, decrypted within fhe_tpu's tests/test_schemeswitch.py bounds.

fhe_tpu's schemeswitch.py runs here with its CKKS context the port's
(test_torch_bootstrap.py's `Bridge`), its ring modules the port's
(`PortModule`), its LWE module the port's tfhe/lwe.py and its jnp.asarray
making the port's int32 tensors (`fhe_tpu_schemeswitch_over_the_port`).
Sizes and seeds are fhe_tpu's test's: N = 128, 15 levels of 26 bits,
dnum = 2, seed 21, the TOY FHEW set.  Compare and min/max are in
test_torch_schemeswitch_minmax.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import schemeswitch as j_ss
from fhe_tpu.tfhe import lwe as j_lwe
from fhe_tpu.tfhe import params as j_params
from fhe_tpu_torch import convert
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.pke import ckks, rlwe
from fhe_tpu_torch.pke import schemeswitch as ss
from fhe_tpu_torch.tfhe import BinFheContext
from fhe_tpu_torch.tfhe import lwe as tlwe
from test_torch_bootstrap import Bridge, PortModule, same_ct, to_j

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 128
SLOTS = N // 2


class PortJnp:
    """jnp.asarray as fhe_tpu's schemeswitch.py calls it, giving the port's
    int32 tensors (residues below 2^31, small signed secrets)."""

    @staticmethod
    def asarray(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64).astype(np.int32))


@pytest.fixture(scope="module")
def fhe_tpu_schemeswitch_over_the_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ss, "rns", PortModule(rns))
        mp.setattr(j_ss, "tlwe", tlwe)
        mp.setattr(j_ss, "jnp", PortJnp)
        mp.setattr(j_boot, "rns", PortModule(rns))
        mp.setattr(j_boot, "rlwe", PortModule(rlwe))
        mp.setattr(j_adv, "rns", PortModule(rns))
        yield


def same_lwe(got, want, what=""):
    """Two LWE ciphertexts (the port's, or fhe_tpu's jax arrays) equal."""
    assert (got.modulus, got.pt_mod) == (want.modulus, want.pt_mod), what
    for g, w in ((got.a, want.a), (got.b, want.b)):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64), err_msg=what)


def same_keys(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for r in got:
        assert torch.equal(got[r].b, want[r].b) and torch.equal(got[r].a, want[r].a)


@pytest.fixture(scope="module")
def setup():
    """tests/test_schemeswitch.py's setup: a 15-level N = 128 context, seed
    21, the TOY FHEW context and key."""
    ctx = ckks.CkksContext.create(N=N, num_levels=15, scale_bits=26, dnum=2, device="cpu")
    rng = np.random.default_rng(21)
    sk, pk = ctx.keygen(rng)
    evk = ctx.relin_key_gen(sk, rng)
    tctx = BinFheContext.generate("TOY", device="cpu")
    tsk = tctx.key_gen(rng)
    return ctx, sk, pk, evk, tctx, tsk, rng


def ring_key(sk):
    return tlwe.LweSecretKey(s=sk.s_signed.to(torch.int32))


# ---------------------------------------------------------------------------
# extraction and keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, num", [(128, None), (128, 40), (2048, 1024)],
                         ids=["128-all", "128-40", "2048-1024"])
def test_extract_lwe_all_rows_match_fhe_tpu(n, num):
    """The rows the port builds (all, or the first num) equal fhe_tpu's
    [N, N] index-table gather, with b its c0."""
    q = 1073479681
    rng = np.random.default_rng(n)
    c0, c1 = rng.integers(0, q, size=(2, n))
    got = ss.extract_lwe_all(torch.from_numpy(c0).to(torch.int32),
                             torch.from_numpy(c1).to(torch.int32), q, 8, num=num)
    want = j_ss.extract_lwe_all(c0, c1, q, 8)
    k = n if num is None else num
    assert tuple(got.a.shape) == (k, n)
    np.testing.assert_array_equal(got.a.numpy().astype(np.int64),
                                  np.asarray(want.a)[:k].astype(np.int64))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b)[:k].astype(np.int64))
    assert (got.modulus, got.pt_mod) == (q, 8)


def test_ckks_to_fhew_setup_keys_match_fhe_tpu(setup, fhe_tpu_schemeswitch_over_the_port):
    """From one seed: the StC rotation keys equal fhe_tpu's setup's (run over
    the port), and the ring-to-TOY switching key equals fhe_tpu's own
    key_switch_gen drawn after the same rotation keys; carried over by
    convert.ckks_to_fhew_key it is the same key."""
    ctx, sk, _, _, tctx, tsk, _ = setup
    got = ss.ckks_to_fhew_setup(ctx, sk, tctx.params, tsk, np.random.default_rng(3))
    want = j_ss.ckks_to_fhew_setup(Bridge(ctx), sk, tctx.params, tsk, np.random.default_rng(3))
    assert (got.bsgs_g, got.slots, got.scale_cf) == (want.bsgs_g, want.slots, want.scale_cf)
    same_keys(got.rot_keys, want.rot_keys)
    rng = np.random.default_rng(3)
    ctx.rotation_key_gen(sk, sorted(got.rot_keys), rng)
    own = j_lwe.key_switch_gen(j_params.make_params("TOY"),
                               j_lwe.LweSecretKey(s=jnp.asarray(tsk.s.numpy())),
                               j_lwe.LweSecretKey(s=jnp.asarray(sk.s_signed.numpy())), rng)
    for g, w in ((got.ksk.a, own.a), (got.ksk.b, own.b)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    carried = convert.ckks_to_fhew_key(got.rot_keys, np.asarray(own.a), np.asarray(own.b),
                                       got.bsgs_g, got.slots, device="cpu")
    assert torch.equal(carried.ksk.a, got.ksk.a) and torch.equal(carried.ksk.b, got.ksk.b)
    assert ss.ckks_to_fhew_setup(ctx, sk, None, None, np.random.default_rng(3)).ksk is None


def test_fhew_to_ckks_setup_matches_fhe_tpu(setup, fhe_tpu_schemeswitch_over_the_port):
    """The CKKS encryption of the FHEW secret and the A-transform's rotation
    keys equal fhe_tpu's setup's from one seed; convert.fhew_to_ckks_key
    carries them."""
    ctx, sk, pk, _, _, tsk, _ = setup
    got = ss.fhew_to_ckks_setup(ctx, sk, tsk, pk, np.random.default_rng(4))
    want = j_ss.fhew_to_ckks_setup(Bridge(ctx), sk, tsk, pk, np.random.default_rng(4))
    assert got.bsgs_g == want.bsgs_g
    same_ct(got.enc_sk, want.enc_sk, "enc_sk")
    same_keys(got.rot_keys, want.rot_keys)
    e = to_j(got.enc_sk)
    carried = convert.fhew_to_ckks_key(np.asarray(e.c0.data), np.asarray(e.c1.data),
                                       e.c0.moduli, e.scale, got.rot_keys, got.bsgs_g,
                                       device="cpu")
    same_ct(carried.enc_sk, e, "carried enc_sk")


# ---------------------------------------------------------------------------
# the conversions, against fhe_tpu's schemeswitch.py over the port's ops
# ---------------------------------------------------------------------------

def test_ckks_to_fhew_ring_extraction(setup, fhe_tpu_schemeswitch_over_the_port):
    """test_ckks_to_fhew_ring_extraction: all 64 slots of integers in [0, 4)
    to LWE under the ring secret, exact; num_values = 40 keeps 40 of them;
    byte-equal to fhe_tpu's."""
    ctx, sk, pk, _, tctx, _, rng = setup
    key = ss.ckks_to_fhew_setup(ctx, sk, None, None, rng)
    z = rng.integers(0, 4, size=SLOTS).astype(np.float64)
    ct = ctx.encrypt(pk, z, rng)
    for num in (None, 40):
        cts = ss.eval_ckks_to_fhew(ctx, key, ct, p=4, num_values=num)
        same_lwe(cts, j_ss.eval_ckks_to_fhew(Bridge(ctx), key, to_j(ct), p=4, num_values=num),
                 "eval_ckks_to_fhew")
        got = tlwe.decrypt(tctx.params, ring_key(sk), cts, p=4).numpy()
        np.testing.assert_array_equal(got, z[:len(got)].astype(int))


@pytest.mark.parametrize("keep_large", [False, True], ids=["to_qn", "keep_qks"])
def test_ckks_to_fhew_full(setup, keep_large, fhe_tpu_schemeswitch_over_the_port):
    """test_ckks_to_fhew_full: to (n, q) under the TOY key (ModSwitch,
    KeySwitch, ModSwitch), or kept at q_ks (the sign pipeline's branch);
    byte-equal to fhe_tpu's, exact."""
    ctx, sk, pk, _, tctx, tsk, rng = setup
    key = ss.ckks_to_fhew_setup(ctx, sk, tctx.params, tsk, rng)
    z = rng.integers(0, 4, size=SLOTS).astype(np.float64)
    ct = ctx.encrypt(pk, z, rng)
    cts = ss.eval_ckks_to_fhew(ctx, key, ct, p=4, fhew_params=tctx.params,
                               keep_large_modulus=keep_large)
    same_lwe(cts, j_ss.eval_ckks_to_fhew(Bridge(ctx), key, to_j(ct), p=4,
                                         fhew_params=tctx.params, keep_large_modulus=keep_large),
             "eval_ckks_to_fhew")
    assert cts.modulus == (tctx.params.q_ks if keep_large else tctx.params.q)
    np.testing.assert_array_equal(tctx.decrypt(tsk, cts, p=4).numpy(), z.astype(int))


@pytest.mark.parametrize("p", [4, 8], ids=["bits", "pary"])
def test_fhew_to_ckks(setup, p, fhe_tpu_schemeswitch_over_the_port):
    """test_fhew_to_ckks_bits / _pary: 32 TOY ciphertexts of bits to CKKS
    slots; byte-equal to fhe_tpu's; p = 4 within 0.3 of the bits and
    rounding to them, p = 8 within 0.2 of (p / 2 pi) sin(2 pi m / p)."""
    ctx, sk, pk, evk, tctx, tsk, rng = setup
    k2 = ss.fhew_to_ckks_setup(ctx, sk, tsk, pk, rng)
    m = rng.integers(0, 2, size=32)
    cts = tctx.encrypt(tsk, m, rng, p=p)
    out = ss.eval_fhew_to_ckks(ctx, k2, cts, evk, p=p)
    same_ct(out, j_ss.eval_fhew_to_ckks(Bridge(ctx), k2, cts, evk, p=p), "eval_fhew_to_ckks")
    got = ctx.decrypt(sk, out).real[:32]
    if p == 4:
        assert np.abs(got - m).max() < 0.3
        np.testing.assert_array_equal(np.rint(got).astype(int), m)
    else:
        assert np.abs(got - (p / (2 * np.pi)) * np.sin(2 * np.pi * m / p)).max() < 0.2


def test_small_helpers_match_fhe_tpu():
    """The rotation-index helpers and EvalCompareSwitchPrecompute."""
    for n in (1, 2, 4, 8, 16):
        assert ss.min_max_rotation_indices(n) == j_ss.min_max_rotation_indices(n)
        assert ss.min_max_rotation_indices_alt(n) == j_ss.min_max_rotation_indices_alt(n)
    base = ss.CkksToFhewKey(rot_keys={}, ksk=None, bsgs_g=1, slots=4)
    scaled = ss.eval_compare_switch_precompute(base, scale_sign=0.25)
    assert scaled.scale_cf == 0.25 and base.scale_cf == 1.0


def test_rescale_floor_bias_sits_on_the_lowest_slots():
    """Why FHEW -> CKKS at N = 2^14 needs more than bench config 3's 2^26
    scale (ROADMAP queue 3): the rescale (DropLastElementAndScale, the
    port's and fhe_tpu's, byte-equal in test_torch_ckks.py) divides by the
    last prime with a floor, so each coefficient of c0 and c1 loses a
    remainder in [0, 1), of mean 1/2.  The mean part, -(J + J s) / 2 with
    J = 1 + X + ... + X^(N-1), is largest where J is: at the slots whose
    root is nearest 1, |J| ~ 2N / pi.  At N = 2^11 and scale 2^26, slot 0's
    error after one rescale is that bias, over 10x the slots' spread."""
    N, slots = 1 << 11, 1 << 10
    ctx = ckks.CkksContext.create(N=N, num_levels=4, scale_bits=26, dnum=2, device="cpu")
    rng = np.random.default_rng(5)
    sk, pk = ctx.keygen(rng)
    z = np.zeros(slots)
    z[:503] = rng.integers(-1, 2, size=503)
    ct = ctx.encrypt(pk, z, rng)
    out = ctx.rescale(ctx.mul_plain(ct, np.ones(slots)))
    err = np.abs(ctx.decrypt(sk, out) - ctx.decrypt(sk, ct))
    t, _, _ = ckks._embedding_tables(N)
    zeta = np.exp(1j * np.pi * (2 * t[0] + 1) / N)
    s_zeta = np.sum(sk.s_signed.numpy() * zeta ** np.arange(N))
    bias = abs(0.5 * (2 / (1 - zeta)) * (1 + s_zeta)) / out.scale
    assert np.argmax(err) == 0 and err[0] > 10 * err.std()
    assert abs(err[0] - bias) < 0.3 * bias, (err[0], bias)
