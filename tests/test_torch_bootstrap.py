"""fhe_tpu_torch's CKKS bootstrapping (pke/bootstrap.py): its host
precomputation against fhe_tpu's, its pieces against fhe_tpu's
bootstrap.py run over the port's ops, the modulus raise against fhe_tpu's
own, and the plain model of the N = 2^16 split NTT (kernels/ntt.py)
against the plain 2^16 transform, on the CPU.

fhe_tpu's jitted CKKS circuits take minutes to compile on the CPU, so the
pieces run fhe_tpu's bootstrap.py over the port (as test_torch_advanced.py
runs advanced.py): its control flow with each CkksContext op (`Bridge`)
and each ring and RLWE op it calls (`PortModule` over lattice/rns.py and
pke/rlwe.py) the port's on the carried data.  Those ops are held to
fhe_tpu's own byte for byte in test_torch_ckks*.py, test_torch_rns_ring.py
and test_torch_bootstrap_keys.py, so equal bytes here mean the port issues
fhe_tpu's composition exactly.  The raise's exact centered switch is held
to fhe_tpu's own, jitted.  The five eval_bootstrap variants are in
test_torch_bootstrap_eval.py and test_torch_bootstrap_sparse.py, which
import the helpers below.

Sizes are fhe_tpu's tests/test_bootstrap.py's: N = 128, composite degree
2 (scale 2^52, two limbs a level), dnum = 2, a weight-16 secret.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as j_rns
from fhe_tpu.pke import advanced as j_adv
from fhe_tpu.pke import bootstrap as j_boot
from fhe_tpu.pke import ckks as j_ckks
from fhe_tpu_torch.kernels import ntt as kntt
from fhe_tpu_torch.lattice import rns
from fhe_tpu_torch.math import ntt, primes
from fhe_tpu_torch.pke import bootstrap, ckks, rlwe

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

N = 128
SLOTS = N // 2
H = 16
CTX = dict(N=N, scale_bits=52, dnum=2, composite_degree=2)


# ---------------------------------------------------------------------------
# carrying data between the packages, and fhe_tpu's bootstrap.py over the port
# ---------------------------------------------------------------------------

def to_j(x):
    """Port ring elements and ciphertexts (in tuples and lists) -> fhe_tpu's."""
    if isinstance(x, rns.RnsPoly):
        return j_rns.RnsPoly(jnp.asarray(x.data.numpy().astype(np.uint32)), x.moduli, x.fmt)
    if isinstance(x, ckks.Ciphertext):
        return j_ckks.Ciphertext(to_j(x.c0), to_j(x.c1), x.scale)
    if isinstance(x, (tuple, list)):
        return type(x)(to_j(v) for v in x)
    return x


def to_port(x):
    """fhe_tpu ring elements and ciphertexts -> the port's (CPU)."""
    if isinstance(x, j_rns.RnsPoly):
        return rns.RnsPoly(torch.from_numpy(np.asarray(x.data).astype(np.int32)), x.moduli,
                           x.fmt)
    if isinstance(x, j_ckks.Ciphertext):
        return ckks.Ciphertext(to_port(x.c0), to_port(x.c1), x.scale)
    if isinstance(x, (tuple, list)):
        return type(x)(to_port(v) for v in x)
    return x


def _bridged(fn, **defaults):
    def call(*args, **kw):
        kw = {**defaults, **{k: to_port(v) for k, v in kw.items()}}
        return to_j(fn(*[to_port(a) for a in args], **kw))
    return call


class PortModule:
    """A module's functions as fhe_tpu code calls them, run by the port's
    module of the same name on the carried data (on the CPU: device="cpu"
    where a function takes a device)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        attr = getattr(self._module, name)
        if not callable(attr) or isinstance(attr, type):
            return attr
        takes_device = "device" in inspect.signature(attr).parameters
        return _bridged(attr, **({"device": "cpu"} if takes_device else {}))


class Bridge:
    """fhe_tpu's CkksContext surface over the port's context: fhe_tpu
    ciphertexts in and out, each op the port's; attributes as they are."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.params = ctx.params
        self.cd = ctx.cd
        self.scale = ctx.scale

    def __getattr__(self, name):
        return _bridged(getattr(self._ctx, name))


@pytest.fixture(scope="module")
def fhe_tpu_bootstrap_over_the_port():
    """fhe_tpu's bootstrap.py and advanced.py with their ring and RLWE
    modules the port's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_boot, "rns", PortModule(rns))
        mp.setattr(j_boot, "rlwe", PortModule(rlwe))
        mp.setattr(j_adv, "rns", PortModule(rns))
        yield


def same_ct(got, want, what=""):
    """A port ciphertext byte-equal to a carried fhe_tpu one."""
    assert (got.moduli, got.scale) == (want.c0.moduli, want.scale), what
    for g, w in ((got.c0, want.c0), (got.c1, want.c1)):
        np.testing.assert_array_equal(g.data.numpy().astype(np.int64),
                                      np.asarray(w.data).astype(np.int64), err_msg=what)


def lowest(ctx, ct):
    """ct dropped to its base block (one level: cd limbs), as fhe_tpu's
    tests feed the bootstrap."""
    drop = len(ct.moduli) - ctx.cd
    return ckks.Ciphertext(rns.level_reduce(ct.c0, drop), rns.level_reduce(ct.c1, drop), ct.scale)


def boot_case(seed: int, num_levels: int = 13, dense: bool = False, encapsulate: bool = False,
              **setup_kw):
    """tests/test_bootstrap.py's set-up on the port: the context, keys from
    seed (a weight-H secret, or a dense one), setup, bootstrap keys."""
    ctx = ckks.CkksContext.create(num_levels=num_levels, device="cpu", **CTX)
    rng = np.random.default_rng(seed)
    sk, pk = ctx.keygen(rng, h=None if dense else H)
    pre = bootstrap.setup(ctx, h=H, **setup_kw)
    keys = bootstrap.keygen(ctx, sk, pre, rng, encapsulate_h=H if encapsulate else None)
    return ctx, sk, pk, pre, keys, rng


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def _same_levels(got, want):
    assert (got is None) == (want is None)
    for (d_got, g_got), (d_want, g_want) in zip(got or [], want or []):
        assert g_got == g_want and sorted(d_got) == sorted(d_want)
        for o in d_got:
            np.testing.assert_array_equal(d_got[o], d_want[o])


@pytest.mark.parametrize("kw", [{}, dict(slots=8), dict(level_budget=(2, 2)),
                                dict(level_budget=(3, 3))],
                         ids=["dense", "sparse8", "budget22", "budget33"])
def test_setup_matches_fhe_tpu(kw):
    """Every field of BootstrapPrecom equals fhe_tpu's, but E_lo on the
    level-budget path (None in the port: nothing there reads it)."""
    ctx = ckks.CkksContext.create(num_levels=15, device="cpu", **CTX)
    jctx = j_ckks.CkksContext.create(num_levels=15, **CTX)
    assert ctx.params.moduli == jctx.params.moduli
    got, want = bootstrap.setup(ctx, h=H, **kw), j_boot.setup(jctx, h=H, **kw)
    assert (got.slots, got.K, got.r, got.bsgs_g, got.rot_indices) == \
        (want.slots, want.K, want.r, want.bsgs_g, want.rot_indices)
    assert got.cheb_coeffs == want.cheb_coeffs
    if "level_budget" in kw:
        assert got.E_lo is None and want.E_lo is not None
    else:
        np.testing.assert_array_equal(got.E_lo, want.E_lo)
    _same_levels(got.cts_levels, want.cts_levels)
    _same_levels(got.stc_levels, want.stc_levels)


def test_budget33_diagonals_at_n_2_15():
    """The card's set (N = 2^16, all 2^15 slots, level budget (3, 3), K =
    36): the collapsed special-FFT levels equal fhe_tpu's, 32 / 63 / 63
    CoeffsToSlots and 63 / 63 / 32 SlotsToCoeffs diagonals, 106 rotation
    keys."""
    n = 1 << 15
    scalar = 1.0 / (2 * n * 36)
    got = bootstrap._budget_transforms(n, 3, 3, scalar)
    want = j_boot._budget_transforms(n, 3, 3, scalar)
    rots = set()
    for lvls_got, lvls_want in zip(got, want):
        for d_got, d_want in zip(lvls_got, lvls_want):
            g, rr = bootstrap._diag_bsgs(d_got, n)
            assert (g, rr) == j_boot._diag_bsgs(d_want, n)
            rots.update(rr)
            assert sorted(d_got) == sorted(d_want)
            for o in d_got:
                np.testing.assert_array_equal(d_got[o], d_want[o])
    assert [len(d) for d in got[0]] == [32, 63, 63]
    assert [len(d) for d in got[1]] == [63, 63, 32]
    assert len(rots) == 106


def test_sine_and_bsgs_helpers_match_fhe_tpu():
    for K, r in ((12, 3), (36, 3), (27, 2)):
        assert bootstrap._sine_cheb_coeffs(K, r) == j_boot._sine_cheb_coeffs(K, r)
    for n in (8, 64, 1 << 10):
        assert bootstrap._bsgs_rotations(n) == j_boot._bsgs_rotations(n)
    np.testing.assert_array_equal(bootstrap._E_lo(N), j_boot._E_lo(N))


# ---------------------------------------------------------------------------
# the pieces, against fhe_tpu's over the port's ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pieces():
    """Dense-secret keys with the encapsulation keys and a level-0 and a
    top-level ciphertext of z."""
    ctx, sk, pk, pre, keys, rng = boot_case(11, dense=True, encapsulate=True)
    z = rng.uniform(-0.4, 0.4, size=SLOTS)
    ct = ctx.encrypt(pk, z, rng)
    return ctx, sk, pre, keys, ct, lowest(ctx, ct)


def test_raise_to_full_matches_fhe_tpu_jitted(pieces):
    """The centered exact switch of the 2-limb (~60-bit) base block onto
    the whole chain, against fhe_tpu's own _raise_to_full (jitted)."""
    ctx, _, _, _, _, low = pieces
    jctx = j_ckks.CkksContext.create(num_levels=13, **CTX)
    want = jax.jit(lambda c: j_boot._raise_to_full(jctx, c))(to_j(low))
    got = bootstrap._raise_to_full(ctx, low)
    assert len(got.moduli) == len(ctx.params.moduli)
    same_ct(got, want, "_raise_to_full")


def test_pieces_match_fhe_tpu_over_the_port(pieces, fhe_tpu_bootstrap_over_the_port):
    """_raise (the encapsulated detour), _conjugate_split, _double_angle,
    the three BSGS transforms and _mul_plain_raw issue fhe_tpu's ops."""
    ctx, _, pre, keys, ct, low = pieces
    b = Bridge(ctx)
    same_ct(bootstrap._raise(ctx, low, keys), j_boot._raise(b, to_j(low), keys), "_raise")
    for got, want in zip(bootstrap._conjugate_split(ctx, ct, keys),
                         j_boot._conjugate_split(b, to_j(ct), keys)):
        same_ct(got, want, "_conjugate_split")
    same_ct(bootstrap._double_angle(ctx, ct, keys["evk"], 2),
            j_boot._double_angle(b, to_j(ct), keys["evk"], 2), "_double_angle")
    M = np.random.default_rng(3).normal(size=(SLOTS, SLOTS)) * 0.01
    same_ct(bootstrap.bsgs_linear_transform(ctx, ct, M, keys["rot"], pre.bsgs_g),
            j_boot.bsgs_linear_transform(b, to_j(ct), M, keys["rot"], pre.bsgs_g),
            "bsgs_linear_transform")
    diags = {o: np.full(SLOTS, 0.01 * (o + 1)) for o in (0, 1, 9, 17)}
    same_ct(bootstrap.bsgs_diagonal_transform(ctx, ct, diags, keys["rot"], 8),
            j_boot.bsgs_diagonal_transform(b, to_j(ct), diags, keys["rot"], 8),
            "bsgs_diagonal_transform")
    A = np.random.default_rng(4).normal(size=(16, 8)) * 0.01
    same_ct(bootstrap.bsgs_rect_transform(ctx, ct, A, keys["rot"], 2),
            j_boot.bsgs_rect_transform(b, to_j(ct), A, keys["rot"], 2),
            "bsgs_rect_transform")
    scale = bootstrap._mul_plain_scale(ctx, ct)
    assert scale == j_boot._mul_plain_scale(b, to_j(ct))
    ext = ct.moduli + tuple(ctx.params.special_mods)
    ext_ct = ctx.key_switch_ext(ct)
    same_ct(bootstrap._mul_plain_raw(ctx, ext_ct, M[0], ext, scale),
            j_boot._mul_plain_raw(b, to_j(ext_ct), M[0], ext, scale), "_mul_plain_raw")
    assert bootstrap._q0(ctx) == j_boot._q0(b)


# ---------------------------------------------------------------------------
# the N = 2^16 split NTT, modelled on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [27, 31], ids=["lazy_q", "canonical_q"])
def test_split_ntt_model_matches_the_plain_transform(bits):
    """kernels/ntt.py's model of the split kernels' data flow (the top
    stage, two 2^15 transforms on the split tables, stride-2 slots, the
    inverse's stage with N^-1) equals math.ntt's plain 2^16 transform,
    natural and bit-reversed order, and the round trip."""
    N16 = kntt.SPLIT_N
    plan = ntt.make_plan(N16, primes.last_prime(bits, 2 * N16))
    x = torch.from_numpy(np.random.default_rng(bits).integers(0, plan.q, size=(2, N16))).to(
        torch.int32)
    f = ntt.forward_butterfly(plan, x)
    assert torch.equal(kntt.forward_split_model(plan, x), f)
    assert torch.equal(kntt.forward_split_model(plan, x, out_br=True),
                       ntt.forward_butterfly(plan, x, out_br=True))
    assert torch.equal(kntt.inverse_split_model(plan, f), ntt.inverse_butterfly(plan, f))
    assert torch.equal(kntt.inverse_split_model(plan, f), x)


def test_split_tables_layout():
    """T_h[u] = W[u + (1 + h) 2^k] for 2^k <= u < 2^(k+1), T_h[0] = W[1],
    for each limb of a stacked plan."""
    N16 = kntt.SPLIT_N
    plan = rns.make_rns_plan(N16, primes.ntt_primes(2, N16, 1 << 30))
    split = kntt.split_tables(plan)
    assert all(tuple(t.shape) == (2, N16) for t in split)
    W = plan.fwd_w.numpy()
    H16 = N16 // 2
    for h in (0, 1):
        T = split[0].numpy()[:, h * H16:(h + 1) * H16]
        assert (T[:, 0] == W[:, 1]).all()
        for k in (0, 3, 14):
            u = np.arange(1 << k, 1 << (k + 1))
            np.testing.assert_array_equal(T[:, u], W[:, u + (1 + h) * (1 << k)])


# ---------------------------------------------------------------------------
# the card's chain (pke/params.py track_scale)
# ---------------------------------------------------------------------------

BOOT_SET = dict(N=1 << 16, num_levels=22, scale_bits=52, composite_degree=2, first_bits=60,
                dnum=4)


def test_tracked_chain_holds_the_level_scales():
    """At N = 2^16 fhe_tpu's alternating chain (the port's default, equal to
    it) drifts: FLEXIBLEAUTO squares each block's miss, and twelve levels
    down the scale is past 2^500.  track_scale's blocks keep every level
    within 0.01 bits of 2^52, with fhe_tpu's q0 and P, 46 + 12 limbs below
    2^31, and pass the HE standard's 128-bit bound (1,747 bits)."""
    from fhe_tpu.pke import params as j_params
    from fhe_tpu_torch.lattice import stdparams
    from fhe_tpu_torch.pke import params
    plain = params.make_ckks_params(**BOOT_SET)
    j_plain = j_params.make_ckks_params(**BOOT_SET)
    assert (plain.moduli, plain.special_mods) == (j_plain.moduli, j_plain.special_mods)
    assert np.log2(ckks._level_scales(plain)[22]) > 500
    tracked = params.make_ckks_params(**BOOT_SET, track_scale=True)
    assert (len(tracked.moduli), len(tracked.special_mods)) == (46, 12)
    assert tracked.moduli[:2] == plain.moduli[:2]
    assert tracked.special_mods == plain.special_mods
    assert len(set(tracked.moduli + tracked.special_mods)) == 58
    assert all(q < 1 << 31 and q % (1 << 17) == 1 and primes.is_prime(q)
               for q in tracked.moduli)
    scales = np.log2(list(ckks._level_scales(tracked).values()))
    assert np.abs(scales - 52).max() < 0.01
    stdparams.validate(tracked.moduli, 1 << 16, "128_classic", "ternary", tracked.special_mods)
