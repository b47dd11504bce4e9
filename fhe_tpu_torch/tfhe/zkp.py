"""FHE computation witnesses: committed gate traces with sampled
verification points.

Port of fhe_tpu/tfhe/zkp.py (reference semantics: the C++ reference's
zkp/fhe_witness.h -- GateType, GateRecord, hash commitments
C = H(value || randomness), CiphertextTable, FHEWitness (Merkle roots over
the ciphertext commitments and the gate trace, sampled verification
points, a linear-combination proof), WitnessBuilder, WitnessVerifier).

The recorder attests WHAT was computed (gate graph + ciphertext
commitments), not the FHE math itself: a verifier replays sampled gates
against the committed table.  Hashing is host work, as in fhe_tpu; a
recorded ciphertext's row is copied from its device once, as fhe_tpu's
bytes: each residue of a as a little-endian u64, then b, then the
modulus.  The randomness comes from `secrets` (`generate_randomness`), so
the same stream gives fhe_tpu's commitments byte for byte.
"""

from __future__ import annotations

import dataclasses
import enum
import secrets

from . import lwe
from .transcript import DomainTag, MerkleTree, TranscriptBuilder, _h, u64_bytes


class GateType(enum.IntEnum):
    """fhe_witness.h:56-81."""
    AND = 0x01
    OR = 0x02
    NAND = 0x03
    NOR = 0x04
    XOR = 0x05
    XNOR = 0x06
    NOT = 0x07
    ADD = 0x10
    SUB = 0x11
    MUL = 0x12
    BOOTSTRAP = 0x20
    KEY_SWITCH = 0x21
    MOD_SWITCH = 0x22
    EXTERNAL_PRODUCT = 0x23
    CMUX = 0x24
    INPUT = 0xF0
    OUTPUT = 0xF1


@dataclasses.dataclass
class GateRecord:
    """fhe_witness.h:93-105."""
    gate_id: int
    type: GateType
    input_indices: list[int]
    output_index: int
    aux_data: bytes = b""

    def serialize(self) -> bytes:
        out = (self.gate_id.to_bytes(8, "little") +
               bytes([int(self.type)]) +
               len(self.input_indices).to_bytes(4, "little"))
        for i in self.input_indices:
            out += int(i).to_bytes(8, "little")
        out += int(self.output_index).to_bytes(8, "little")
        out += len(self.aux_data).to_bytes(4, "little") + self.aux_data
        return out


@dataclasses.dataclass
class Commitment:
    """C = H(value || randomness) (fhe_witness.h:113-127)."""
    value: bytes

    def __eq__(self, other):
        return isinstance(other, Commitment) and self.value == other.value


@dataclasses.dataclass
class CommitmentOpening:
    committed_value: bytes
    randomness: bytes

    def verify(self, commitment: Commitment) -> bool:
        return commit(self.committed_value,
                      self.randomness) == commitment


def commit(value: bytes, randomness: bytes) -> Commitment:
    return Commitment(_h(value + randomness))


def generate_randomness() -> bytes:
    return secrets.token_bytes(32)


def _ct_bytes(ct: lwe.LweCiphertext, index: int) -> bytes:
    """Canonical byte serialization of one batch element: fhe_tpu's u64
    words of a, then b, then the modulus (one row copied to the host)."""
    a = ct.a.reshape(-1, ct.a.shape[-1])
    b = ct.b.reshape(-1)
    return (u64_bytes(a[index]) + u64_bytes(b[index]) +
            int(ct.modulus).to_bytes(8, "little"))


class CiphertextTable:
    """Index -> (commitment, opening) registry (fhe_witness.h:157)."""

    def __init__(self):
        self._commitments: list[Commitment] = []
        self._openings: list[CommitmentOpening] = []

    def register(self, blob: bytes) -> int:
        r = generate_randomness()
        self._commitments.append(commit(blob, r))
        self._openings.append(CommitmentOpening(blob, r))
        return len(self._commitments) - 1

    def register_ct(self, ct: lwe.LweCiphertext, index: int = 0) -> int:
        return self.register(_ct_bytes(ct, index))

    def commitment(self, idx: int) -> Commitment:
        return self._commitments[idx]

    def opening(self, idx: int) -> CommitmentOpening:
        return self._openings[idx]

    def __len__(self):
        return len(self._commitments)


@dataclasses.dataclass
class VerificationPoint:
    """One sampled gate with Merkle inclusion proofs
    (fhe_witness.h FHEWitness::VerificationPoint)."""
    gate_index: int
    gate: GateRecord
    gate_proof: MerkleTree.InclusionProof
    input_commitments: list[Commitment]
    input_proofs: list[MerkleTree.InclusionProof]
    output_commitment: Commitment
    output_proof: MerkleTree.InclusionProof


@dataclasses.dataclass
class LinearCombinationProof:
    """Batched check: H(sum_j w_j * H(commit_j)) with Fiat-Shamir weights
    derived from the challenge seed -- binds every table entry, not just
    the sampled ones."""
    digest: bytes


@dataclasses.dataclass
class FHEWitness:
    """fhe_witness.h:279-320."""
    version: int
    circuit_id: str
    ciphertext_root: bytes
    gate_trace_root: bytes
    verification_points: list[VerificationPoint]
    linear_proof: LinearCombinationProof
    challenge_seed: bytes
    input_commitments: list[Commitment]
    output_commitments: list[Commitment]
    num_gates: int
    num_ciphertexts: int


def _linear_digest(seed: bytes, commitments: list[Commitment]) -> bytes:
    acc = 0
    for j, c in enumerate(commitments):
        w = int.from_bytes(_h(seed + j.to_bytes(8, "little")), "little")
        acc = (acc + w * int.from_bytes(c.value, "little")) % (1 << 512)
    return _h(acc.to_bytes(64, "little"))


class WitnessBuilder:
    """fhe_witness.h:340: register inputs, record gates, build witness."""

    def __init__(self, circuit_id: str, security_parameter: int = 80):
        self.circuit_id = circuit_id
        self.security_parameter = security_parameter
        self.table = CiphertextTable()
        self.gates: list[GateRecord] = []
        self._inputs: list[int] = []
        self._outputs: list[int] = []

    def register_input(self, ct: lwe.LweCiphertext, index: int = 0) -> int:
        idx = self.table.register_ct(ct, index)
        self._inputs.append(idx)
        self.gates.append(GateRecord(len(self.gates), GateType.INPUT,
                                     [], idx))
        return idx

    def record_gate(self, gtype: GateType, input_indices: list[int],
                    output_ct: lwe.LweCiphertext, index: int = 0,
                    aux: bytes = b"") -> int:
        out_idx = self.table.register_ct(output_ct, index)
        self.gates.append(GateRecord(len(self.gates), gtype,
                                     list(input_indices), out_idx, aux))
        return out_idx

    def mark_output(self, idx: int) -> None:
        self._outputs.append(idx)
        self.gates.append(GateRecord(len(self.gates), GateType.OUTPUT,
                                     [idx], idx))

    def build(self) -> FHEWitness:
        ct_tree = MerkleTree()
        ct_tree.build([c.value for c in self.table._commitments])
        gate_tree = MerkleTree()
        gate_tree.build_from_data([g.serialize() for g in self.gates])

        tx = TranscriptBuilder("FHEWitness")
        tx.append(DomainTag.PROTOCOL, self.circuit_id.encode())
        tx.append_hash(DomainTag.MERKLE_NODE, ct_tree.root)
        tx.append_hash(DomainTag.MERKLE_NODE, gate_tree.root)
        seed = tx.challenge()

        # sample gates (skip INPUT/OUTPUT markers)
        real = [i for i, g in enumerate(self.gates)
                if g.type not in (GateType.INPUT, GateType.OUTPUT)]
        k = min(self.security_parameter, len(real))
        picks = []
        ctr = 0
        while len(picks) < k:
            r = int.from_bytes(_h(seed + ctr.to_bytes(8, "little")),
                               "little") % len(real)
            ctr += 1
            if real[r] not in picks:
                picks.append(real[r])

        points = []
        for gi in picks:
            g = self.gates[gi]
            points.append(VerificationPoint(
                gate_index=gi, gate=g,
                gate_proof=gate_tree.prove_inclusion(gi),
                input_commitments=[self.table.commitment(i)
                                   for i in g.input_indices],
                input_proofs=[ct_tree.prove_inclusion(i)
                              for i in g.input_indices],
                output_commitment=self.table.commitment(g.output_index),
                output_proof=ct_tree.prove_inclusion(g.output_index),
            ))
        return FHEWitness(
            version=1, circuit_id=self.circuit_id,
            ciphertext_root=ct_tree.root, gate_trace_root=gate_tree.root,
            verification_points=points,
            linear_proof=LinearCombinationProof(
                _linear_digest(seed, self.table._commitments)),
            challenge_seed=seed,
            input_commitments=[self.table.commitment(i)
                               for i in self._inputs],
            output_commitments=[self.table.commitment(i)
                                for i in self._outputs],
            num_gates=len(self.gates),
            num_ciphertexts=len(self.table),
        )


class WitnessVerifier:
    """fhe_witness.h:501: structural verification of a witness."""

    def verify(self, w: FHEWitness) -> bool:
        # challenge seed must be reproducible from the roots
        tx = TranscriptBuilder("FHEWitness")
        tx.append(DomainTag.PROTOCOL, w.circuit_id.encode())
        tx.append_hash(DomainTag.MERKLE_NODE, w.ciphertext_root)
        tx.append_hash(DomainTag.MERKLE_NODE, w.gate_trace_root)
        if tx.challenge() != w.challenge_seed:
            return False
        for vp in w.verification_points:
            # quoted gate record must hash to the proven leaf
            if _h(bytes([DomainTag.MERKLE_NODE]) + _h(vp.gate.serialize())) \
                    != vp.gate_proof.leaf_hash:
                return False
            if not MerkleTree.verify_inclusion(w.gate_trace_root,
                                               vp.gate_proof):
                return False
            for pr in vp.input_proofs:
                if not MerkleTree.verify_inclusion(w.ciphertext_root, pr):
                    return False
            if not MerkleTree.verify_inclusion(w.ciphertext_root,
                                               vp.output_proof):
                return False
            # commitments quoted in the point must hash into the tree leaf
            for c, pr in zip(vp.input_commitments, vp.input_proofs):
                if _h(bytes([DomainTag.MERKLE_NODE]) + c.value) \
                        != pr.leaf_hash:
                    return False
            if _h(bytes([DomainTag.MERKLE_NODE]) +
                  vp.output_commitment.value) != vp.output_proof.leaf_hash:
                return False
        return True

    def verify_gate_recomputation(self, w: FHEWitness, vp: VerificationPoint,
                                  recompute_fn, openings: list[
                                      CommitmentOpening],
                                  out_opening: CommitmentOpening) -> bool:
        """Replay one sampled gate: check openings against the quoted
        commitments and the recomputed output bytes against the opening."""
        for c, op in zip(vp.input_commitments, openings):
            if not op.verify(c):
                return False
        if not out_opening.verify(vp.output_commitment):
            return False
        got = recompute_fn([op.committed_value for op in openings])
        return got == out_opening.committed_value
