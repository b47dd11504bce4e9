"""fhe_tpu_torch's computation witnesses (tfhe/zkp.py) against fhe_tpu on
the CPU, byte for byte: fhe_tpu's TOY circuit (tests/test_zkp.py: two
inputs, AND, OR, XOR of the two, one output) recorded by both packages'
WitnessBuilder, with `secrets.token_bytes` (the commitments' randomness)
one seeded stream reset before each run.  The gates are the port's (TOY on
the CPU; held to fhe_tpu's in test_torch_gate.py), handed to fhe_tpu as
numpy arrays.  The replay reruns each sampled gate on the port from the
opened input bytes.
"""

import copy

import numpy as np
import pytest
import torch

from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import zkp as j_zkp
from fhe_tpu_torch.tfhe import BinFheContext, lwe, zkp

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)


def _j_ct(ct: lwe.LweCiphertext) -> jlwe.LweCiphertext:
    return jlwe.LweCiphertext(a=ct.a.numpy().astype(np.uint32), b=ct.b.numpy().astype(np.uint32),
                              modulus=ct.modulus, pt_mod=ct.pt_mod)


def _record(mod, cts, conv, security_parameter=8):
    """fhe_tpu's test circuit: inputs ct1, ct2; AND, OR; XOR of those."""
    ct1, ct2, ct3, ct4, ct5 = (conv(c) for c in cts)
    wb = mod.WitnessBuilder("circ-test", security_parameter=security_parameter)
    i1 = wb.register_input(ct1)
    i2 = wb.register_input(ct2)
    i3 = wb.record_gate(mod.GateType.AND, [i1, i2], ct3)
    i4 = wb.record_gate(mod.GateType.OR, [i1, i2], ct4)
    i5 = wb.record_gate(mod.GateType.XOR, [i3, i4], ct5)
    wb.mark_output(i5)
    return wb, wb.build()


@pytest.fixture(scope="module")
def circuit():
    ctx = BinFheContext.generate("TOY", device="cpu")
    rng = np.random.default_rng(17)
    sk = ctx.key_gen(rng)
    key = ctx.bt_key_gen(sk, rng)
    ct1 = ctx.encrypt(sk, np.array([1]), rng)
    ct2 = ctx.encrypt(sk, np.array([0]), rng)
    ct3 = ctx.eval_bin_gate(key, "AND", ct1, ct2)
    ct4 = ctx.eval_bin_gate(key, "OR", ct1, ct2)
    ct5 = ctx.eval_bin_gate(key, "XOR", ct3, ct4)
    return ctx, sk, key, (ct1, ct2, ct3, ct4, ct5)


@pytest.fixture
def both(circuit, monkeypatch):
    """The circuit recorded by the port and by fhe_tpu from one stream."""
    seed = np.random.default_rng(2027)
    state = seed.bit_generator.state
    monkeypatch.setattr("secrets.token_bytes", lambda n: seed.bytes(n))
    port = _record(zkp, circuit[3], lambda c: c)
    seed.bit_generator.state = state
    ref = _record(j_zkp, circuit[3], _j_ct)
    return port, ref


def _point(vp):
    return (vp.gate_index, vp.gate.serialize(), vp.gate_proof.leaf_hash, vp.gate_proof.path,
            [c.value for c in vp.input_commitments],
            [(p.index, p.leaf_hash, p.path) for p in vp.input_proofs],
            vp.output_commitment.value, vp.output_proof.path)


def test_witness_matches_fhe_tpu(both):
    """Roots, challenge seed, sampled gates, the linear proof and every
    commitment byte-equal; both verifiers accept."""
    (wb, w), (jwb, jw) = both
    assert (w.ciphertext_root, w.gate_trace_root, w.challenge_seed, w.linear_proof.digest) == \
        (jw.ciphertext_root, jw.gate_trace_root, jw.challenge_seed, jw.linear_proof.digest)
    assert (w.num_gates, w.num_ciphertexts) == (jw.num_gates, jw.num_ciphertexts) == (6, 5)
    assert [_point(vp) for vp in w.verification_points] == \
        [_point(vp) for vp in jw.verification_points]
    assert len(w.verification_points) == 3
    assert [c.value for c in w.input_commitments + w.output_commitments] == \
        [c.value for c in jw.input_commitments + jw.output_commitments]
    for i in range(len(wb.table)):
        assert wb.table.opening(i).committed_value == jwb.table.opening(i).committed_value
    assert zkp.WitnessVerifier().verify(w) and j_zkp.WitnessVerifier().verify(jw)


def test_ct_bytes_are_fhe_tpu_s(circuit):
    ct = circuit[3][0]
    assert zkp._ct_bytes(ct, 0) == j_zkp._ct_bytes(_j_ct(ct), 0)
    batch = lwe.LweCiphertext(a=torch.stack([ct.a[0], ct.a[0] + 1]), b=ct.b.repeat(2),
                              modulus=ct.modulus)
    assert zkp._ct_bytes(batch, 1) == j_zkp._ct_bytes(_j_ct(batch), 1)


def test_witness_rejects_tampering(both):
    (_, w), _ = both
    bad = copy.deepcopy(w)
    g = bad.verification_points[0].gate
    g.type = zkp.GateType.OR if g.type != zkp.GateType.OR else zkp.GateType.AND
    assert not zkp.WitnessVerifier().verify(bad)
    bad = copy.deepcopy(w)
    bad.ciphertext_root = bytes(32)
    assert not zkp.WitnessVerifier().verify(bad)
    bad = copy.deepcopy(w)
    bad.verification_points[1].output_commitment = zkp.Commitment(bytes(32))
    assert not zkp.WitnessVerifier().verify(bad)
    r = zkp.generate_randomness()
    c = zkp.commit(b"hello", r)
    assert zkp.CommitmentOpening(b"hello", r).verify(c)
    assert not zkp.CommitmentOpening(b"hellO", r).verify(c)


def _from_bytes(blob: bytes) -> lwe.LweCiphertext:
    """_ct_bytes back to a one-element ciphertext (u64 words: a, b, modulus)."""
    words = np.frombuffer(blob, dtype="<u8").astype(np.int64)
    return lwe.LweCiphertext(a=torch.from_numpy(words[None, :-2].astype(np.int32)),
                             b=torch.from_numpy(words[None, -2].astype(np.int32)),
                             modulus=int(words[-1]))


def test_gate_replay(circuit, both):
    """Every sampled gate rerun on the port from its opened inputs gives
    the committed output bytes (gates are deterministic); a wrong output
    is rejected."""
    ctx, _, key, _ = circuit
    (wb, w), _ = both
    names = {zkp.GateType.AND: "AND", zkp.GateType.OR: "OR", zkp.GateType.XOR: "XOR"}
    for vp in w.verification_points:
        openings = [wb.table.opening(i) for i in vp.gate.input_indices]
        out_op = wb.table.opening(vp.gate.output_index)
        replay = lambda ins, t=vp.gate.type: zkp._ct_bytes(
            ctx.eval_bin_gate(key, names[t], *(_from_bytes(b) for b in ins)), 0)
        assert zkp.WitnessVerifier().verify_gate_recomputation(w, vp, replay, openings, out_op)
        assert not zkp.WitnessVerifier().verify_gate_recomputation(
            w, vp, lambda ins: b"not-the-output", openings, out_op)
