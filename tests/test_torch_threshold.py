"""fhe_tpu_torch's threshold decryption (tfhe/threshold.py) and its
transcripts and Merkle trees (tfhe/transcript.py) against fhe_tpu on the
CPU, byte for byte.

The ciphertexts are the port's (TOY on the CPU: its gates are held to
fhe_tpu's in test_torch_gate.py), handed to fhe_tpu as numpy arrays.
`secrets.token_bytes` (the shares', and the proofs' masks) is one seeded
stream, reset before each package's run, so both draw the same bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import threshold as j_th
from fhe_tpu.tfhe import transcript as j_tr
from fhe_tpu_torch import convert
from fhe_tpu_torch.tfhe import BinFheContext, lwe, threshold as th
from fhe_tpu_torch.tfhe import transcript as tr

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


class Stream:
    """A seeded byte stream in place of secrets.token_bytes."""

    def __init__(self, seed: int):
        self.seed = seed
        self.reset()

    def reset(self):
        self.rng = np.random.default_rng(self.seed)

    def __call__(self, n: int) -> bytes:
        return self.rng.bytes(n)


@pytest.fixture
def stream(monkeypatch):
    s = Stream(2026)
    monkeypatch.setattr("secrets.token_bytes", s)
    return s


@pytest.fixture(scope="module")
def toy():
    ctx = BinFheContext.generate("TOY", device="cpu")
    sk = ctx.key_gen(99)
    m = np.random.default_rng(98).integers(0, 2, size=16)
    return ctx, sk, m, ctx.encrypt(sk, m, 97)


def _j_ct(ct: lwe.LweCiphertext) -> jlwe.LweCiphertext:
    return jlwe.LweCiphertext(a=ct.a.numpy().astype(np.uint32), b=ct.b.numpy().astype(np.uint32),
                              modulus=ct.modulus, pt_mod=ct.pt_mod)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _both(stream, fn_t, fn_j):
    stream.reset()
    got = fn_t()
    stream.reset()
    return got, fn_j()


def _same_shares(ts, tv, js, jv):
    assert [(s.party_id, s.commitment) for s in ts] == [(s.party_id, s.commitment) for s in js]
    for t, j in zip(ts, js):
        _eq(t.share, j.share)
    assert [(v.party_id, v.commitment) for v in tv] == [(v.party_id, v.commitment) for v in jv]


# ---------------------------------------------------------------------------
# transcripts and Merkle trees
# ---------------------------------------------------------------------------

def test_transcript_bytes_match_fhe_tpu():
    def build(mod, vec):
        tx = mod.TranscriptBuilder("X")
        tx.append_u64(mod.DomainTag.PARTY_ID, 7)
        tx.append_vector(mod.DomainTag.PARTIAL_DEC, vec)
        tx.append_hash(mod.DomainTag.COMMITMENT, bytes(range(32)))
        tx.append_lwe(mod.DomainTag.CIPHERTEXT, vec, 5)
        first = tx.challenge()
        return first, tx.challenge_int(1 << 31), tx.current_hash
    got = build(tr, torch.arange(5))
    assert got == build(j_tr, np.arange(5))
    assert got == build(tr, np.arange(5))
    assert tr.derive_element_challenge(got[0], 9, 1024) == \
        j_tr.derive_element_challenge(got[0], 9, 1024)
    with pytest.raises(ValueError, match="32 bytes"):
        tr.TranscriptBuilder("X").append_hash(tr.DomainTag.COMMITMENT, b"short")


@pytest.mark.parametrize("count", [1, 7, 16])
def test_merkle_trees_and_inclusion_proofs_match_fhe_tpu(count):
    blobs = [bytes([i] * 4) for i in range(count)]
    mt, jmt = tr.MerkleTree(), j_tr.MerkleTree()
    mt.build_from_data(blobs)
    jmt.build_from_data(blobs)
    assert mt.root == jmt.root
    for i in range(count):
        pr, jpr = mt.prove_inclusion(i), jmt.prove_inclusion(i)
        assert (pr.index, pr.leaf_hash, pr.path) == (jpr.index, jpr.leaf_hash, jpr.path)
        assert tr.MerkleTree.verify_inclusion(mt.root, pr)
    if count > 1:
        pr = mt.prove_inclusion(0)
        pr.index = 1
        assert not tr.MerkleTree.verify_inclusion(mt.root, pr)
    with pytest.raises(ValueError, match="empty"):
        tr.MerkleTree().build([])


# ---------------------------------------------------------------------------
# threshold decryption
# ---------------------------------------------------------------------------

def test_additive_3_of_3_with_proofs_matches_fhe_tpu(toy, stream):
    """Shares, partial decryptions, proofs and the combine byte-equal; every
    proof verifies; the combine decrypts the bits."""
    ctx, sk, m, ct = toy
    jct = _j_ct(ct)
    cfg = th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    jcfg = j_th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    (ts, tv), (js, jv) = _both(stream, lambda: th.generate_key_shares(sk.s, ct.modulus, cfg),
                               lambda: j_th.generate_key_shares(sk.s.numpy(), ct.modulus, jcfg))
    _same_shares(ts, tv, js, jv)
    assert ts[0].share.device == sk.s.device
    for t_sh, j_sh in zip(ts, js):
        (pd, pf), (jpd, jpf) = _both(stream, lambda: th.batch_partial_decrypt(cfg, ct, t_sh),
                                     lambda: j_th.batch_partial_decrypt(jcfg, jct, j_sh))
        _eq(pd.values, jpd.values)
        assert (pd.party_id, pd.batch_commitment) == (jpd.party_id, jpd.batch_commitment)
        _eq(pf.commitments_R, jpf.commitments_R)
        _eq(pf.response, jpf.response)
        assert (pf.merkle_root, pf.batch_challenge) == (jpf.merkle_root, jpf.batch_challenge)
        vk = next(v for v in tv if v.party_id == t_sh.party_id)
        assert th.batch_verify_proofs(cfg, ct, pd, pf, vk)
    got, want = _both(stream, lambda: th.threshold_decrypt(cfg, ct, ts, tv, p=4),
                      lambda: j_th.threshold_decrypt(jcfg, jct, js, jv, p=4))
    _eq(got, want)
    np.testing.assert_array_equal(got.numpy() % 2, m)


def test_proof_rejects_tampering(toy, stream):
    ctx, sk, m, ct = toy
    cfg = th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    shares, vks = th.generate_key_shares(sk.s, ct.modulus, cfg)
    pd, proof = th.batch_partial_decrypt(cfg, ct, shares[0])
    assert th.batch_verify_proofs(cfg, ct, pd, proof, vks[0])
    bad = th.BatchPartialDecryption(pd.party_id, (pd.values + 1) % ct.modulus,
                                    pd.batch_commitment)
    assert not th.batch_verify_proofs(cfg, ct, bad, proof, vks[0])
    assert not th.batch_verify_proofs(cfg, ct, pd, proof, vks[1])
    bad_R = dataclasses.replace(proof, commitments_R=(proof.commitments_R + 1) % ct.modulus)
    assert not th.batch_verify_proofs(cfg, ct, pd, bad_R, vks[0])
    with pytest.raises(ValueError, match="proof failed for party 1"):
        th.threshold_decrypt(cfg, ct, shares, [th.VerificationKey(1, bytes(32))] + vks[1:])


def test_missing_party_and_named_errors(toy, stream):
    ctx, sk, m, ct = toy
    cfg = th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive",
                             generate_proofs=False)
    shares, _ = th.generate_key_shares(sk.s, ct.modulus, cfg)
    pds = [th.batch_partial_decrypt(cfg, ct, s)[0] for s in shares[:2]]
    assert th.batch_partial_decrypt(cfg, ct, shares[0])[1] is None
    with pytest.raises(ValueError, match="all n parties"):
        th.batch_combine(cfg, ct, pds)
    with pytest.raises(ValueError, match="additive for 2\\^k"):
        th.generate_key_shares(sk.s, ct.modulus, th.ThresholdConfig(scheme="shamir"))
    with pytest.raises(ValueError, match="below 2\\^31"):
        th.generate_key_shares(sk.s, 1 << 31, cfg)
    with pytest.raises(ValueError, match="bogus"):
        th.generate_key_shares(sk.s, ct.modulus, th.ThresholdConfig(scheme="bogus"))


def test_shamir_2_of_3_on_extended_outputs_matches_fhe_tpu(toy, stream):
    """Shamir over TOY's prime ring modulus Q on extended (pre-key-switch)
    OR outputs of a key whose ring secret the test holds: every 2-subset
    decrypts to 1, byte-equal to fhe_tpu; one share short is refused."""
    ctx, sk, m, ct = toy
    sk_n = lwe.keygen(ctx.params, np.random.default_rng(5), dim=ctx.params.N, device="cpu")
    key = ctx.bt_key_gen(sk, np.random.default_rng(5), sk_n=sk_n)
    ct2 = ctx.encrypt(sk, 1 - m, np.random.default_rng(6))
    ext = ctx.eval_bin_gate(key, "OR", ct, ct2, extended=True)
    assert ext.modulus == ctx.params.Q and ext.n == ctx.params.N
    jext = _j_ct(ext)
    cfg = th.ThresholdConfig(threshold=2, total_parties=3, scheme="shamir")
    jcfg = j_th.ThresholdConfig(threshold=2, total_parties=3, scheme="shamir")
    (ts, tv), (js, jv) = _both(stream, lambda: th.generate_key_shares(sk_n.s, ext.modulus, cfg),
                               lambda: j_th.generate_key_shares(sk_n.s.numpy(), ext.modulus,
                                                                jcfg))
    _same_shares(ts, tv, js, jv)
    for subset in ([0, 1], [0, 2], [1, 2]):
        got, want = _both(
            stream, lambda: th.threshold_decrypt(cfg, ext, [ts[i] for i in subset], tv, p=4),
            lambda: j_th.threshold_decrypt(jcfg, jext, [js[i] for i in subset], jv, p=4))
        _eq(got, want)
        np.testing.assert_array_equal(got.numpy() % 2, np.ones_like(m))
    assert th.lagrange_coefficients([1, 3], ext.modulus) == \
        j_th.lagrange_coefficients([1, 3], ext.modulus)
    pd = th.batch_partial_decrypt(cfg, ext, ts[0])[0]
    with pytest.raises(ValueError, match="not enough shares"):
        th.batch_combine(cfg, ext, [pd])


def test_convert_key_share_carries_fhe_tpu_s(toy, stream):
    ctx, sk, m, ct = toy
    jcfg = j_th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    js, jv = j_th.generate_key_shares(sk.s.numpy(), ct.modulus, jcfg)
    ts = [convert.key_share(s.party_id, s.share, s.commitment, device="cpu") for s in js]
    cfg = th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    vks = [th.VerificationKey(v.party_id, v.commitment) for v in jv]
    np.testing.assert_array_equal(th.threshold_decrypt(cfg, ct, ts, vks, p=4).numpy() % 2, m)


def test_proof_does_not_bind_a_share_to_its_commitment_in_either_package(toy, stream):
    """ROADMAP queue 3: the partial-decryption proof shows that the batch's
    d_j are evaluations of one vector z - c r, not of the committed share.
    A party that decrypts with another party's share under its own
    commitment passes verification in fhe_tpu and in the port alike, and
    the combine then decrypts wrong."""
    ctx, sk, m, ct = toy
    jct = _j_ct(ct)
    cfg = th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    jcfg = j_th.ThresholdConfig(threshold=3, total_parties=3, scheme="additive")
    (ts, tv), (js, jv) = _both(stream, lambda: th.generate_key_shares(sk.s, ct.modulus, cfg),
                               lambda: j_th.generate_key_shares(sk.s.numpy(), ct.modulus, jcfg))
    cheat = dataclasses.replace(ts[0], share=ts[1].share)
    jcheat = dataclasses.replace(js[0], share=js[1].share)
    (pd, pf), (jpd, jpf) = _both(stream, lambda: th.batch_partial_decrypt(cfg, ct, cheat),
                                 lambda: j_th.batch_partial_decrypt(jcfg, jct, jcheat))
    assert th.batch_verify_proofs(cfg, ct, pd, pf, tv[0])
    assert j_th.batch_verify_proofs(jcfg, jct, jpd, jpf, jv[0])
    _eq(pd.values, jpd.values)
    others = [th.batch_partial_decrypt(cfg, ct, s)[0] for s in ts[1:]]
    got = th.batch_combine(cfg, ct, [pd] + others, p=4)
    assert (got.numpy() % 2 != m).any()
