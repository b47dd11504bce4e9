"""fhe_tpu_torch's packed wire formats (tfhe/packed.py) against fhe_tpu on
the CPU: every `pack_*` byte-identical to fhe_tpu's for the same values,
each package unpacking the other's bytes, and a TOY gate through an
unpacked key.  The values are the port's (TOY keys and ciphertexts on the
CPU), handed to fhe_tpu as numpy arrays.
"""

import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import packed as j_packed
from fhe_tpu.tfhe import rgsw as j_rgsw
from fhe_tpu.tfhe.params import make_params as j_make_params
from fhe_tpu_torch.tfhe import BinFheContext, lwe, packed

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def toy():
    ctx = BinFheContext.generate("TOY", device="cpu")
    sk = ctx.key_gen(41)
    key = ctx.bt_key_gen(sk, 42)
    m1, m2 = np.array([0, 0, 1, 1, 1]), np.array([0, 1, 0, 1, 1])
    return ctx, sk, key, ctx.encrypt(sk, m1, 43), ctx.encrypt(sk, m2, 44), m1 & m2


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _j_ct(ct):
    return jlwe.LweCiphertext(a=_u32(ct.a), b=_u32(ct.b), modulus=ct.modulus, pt_mod=ct.pt_mod)


def _j_key(key):
    return j_rgsw.BootstrapKey(bsk=_u32(key.bsk), ksk=jlwe.LweSwitchingKey(
        a=_u32(key.ksk.a), b=_u32(key.ksk.b)))


def _same_ct(got: lwe.LweCiphertext, want) -> None:
    assert (got.modulus, got.pt_mod) == (want.modulus, want.pt_mod)
    assert got.a.dtype == got.b.dtype == torch.int32 and got.a.device == CPU
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a).astype(np.int64))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b).astype(np.int64))


def test_pack_lwe_matches_fhe_tpu(toy):
    ct = toy[3]
    one = lwe.LweCiphertext(a=ct.a[2], b=ct.b[2], modulus=ct.modulus, pt_mod=ct.pt_mod)
    blob = packed.pack_lwe(one)
    assert blob == j_packed.pack_lwe(_j_ct(one))
    _same_ct(packed.unpack_lwe(blob, device=CPU), j_packed.unpack_lwe(blob))
    _same_ct(packed.unpack_lwe(j_packed.pack_lwe(_j_ct(one)), device=CPU), one)
    with pytest.raises(ValueError, match="pack_lwe_batch"):
        packed.pack_lwe(ct)


@pytest.mark.parametrize("flags", [packed.LWE_PACK_DEFAULT, packed.LWE_PACK_INTERLEAVED],
                         ids=["sequential", "interleaved"])
def test_pack_lwe_batch_matches_fhe_tpu(toy, flags):
    ct = toy[3]
    blob = packed.pack_lwe_batch(ct, flags)
    assert blob == j_packed.pack_lwe_batch(_j_ct(ct), flags)
    _same_ct(packed.unpack_lwe_batch(blob, device=CPU), ct)
    _same_ct(packed.unpack_lwe_batch(blob, device=CPU), j_packed.unpack_lwe_batch(blob))


def test_pack_keys_match_fhe_tpu(toy):
    """The switching key and the bootstrap key (with its switching key):
    fhe_tpu's bytes; each package unpacks the other's."""
    ctx, _, key, *_ = toy
    jp = j_make_params("TOY")
    blob = packed.pack_switching_key(key.ksk, ctx.params.q_ks)
    assert blob == j_packed.pack_switching_key(_j_key(key).ksk, jp.q_ks)
    ksk, q_ks = packed.unpack_switching_key(blob, device=CPU)
    assert q_ks == ctx.params.q_ks
    assert torch.equal(ksk.a, key.ksk.a) and torch.equal(ksk.b, key.ksk.b)
    bsk_blob = packed.pack_bsk(ctx.params, key)
    assert bsk_blob == j_packed.pack_bsk(jp, _j_key(key))
    jkey = j_packed.unpack_bsk(jp, bsk_blob, with_shoup=False)
    np.testing.assert_array_equal(np.asarray(jkey.bsk), _u32(key.bsk))
    got = packed.unpack_bsk(ctx.params, j_packed.pack_bsk(jp, _j_key(key)), device=CPU)
    assert torch.equal(got.bsk, key.bsk) and torch.equal(got.ksk.a, key.ksk.a)


def test_packed_header_errors(toy):
    ctx, _, key, ct, *_ = toy
    blob = packed.pack_lwe_batch(ct)
    with pytest.raises(ValueError, match="packed type"):
        packed.unpack_lwe(blob, device=CPU)
    with pytest.raises(ValueError, match="size mismatch"):
        packed.unpack_lwe_batch(blob[:-4], device=CPU)
    with pytest.raises(ValueError, match="bad magic"):
        packed.unpack_lwe_batch(b"\0" * 4 + blob[4:], device=CPU)
    with pytest.raises(ValueError, match="shorter than header"):
        packed.unpack_lwe_batch(b"LUXF", device=CPU)
    other = BinFheContext.generate("STD128", device="cpu").params
    with pytest.raises(ValueError, match="does not match params"):
        packed.unpack_bsk(other, packed.pack_bsk(ctx.params, key), device=CPU)


def test_gate_with_unpacked_key_is_the_original_s(toy):
    """A TOY AND through the key unpacked from its bytes (with_shoup
    accepted, no effect) is byte-identical to the AND through the key
    itself, and its inputs survive a packed round trip."""
    ctx, sk, key, ct1, ct2, truth = toy
    unpacked = packed.unpack_bsk(ctx.params, packed.pack_bsk(ctx.params, key), with_shoup=True,
                                 device=CPU)
    c1 = packed.unpack_lwe_batch(packed.pack_lwe_batch(ct1, packed.LWE_PACK_INTERLEAVED),
                                 device=CPU)
    c2 = packed.unpack_lwe_batch(packed.pack_lwe_batch(ct2), device=CPU)
    got = ctx.eval_bin_gate(unpacked, "AND", c1, c2)
    want = ctx.eval_bin_gate(key, "AND", ct1, ct2)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    np.testing.assert_array_equal(ctx.decrypt(sk, got).numpy(), truth)
