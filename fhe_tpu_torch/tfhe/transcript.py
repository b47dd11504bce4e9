"""Fiat-Shamir transcripts and Merkle batch commitments, on the host.

Port of fhe_tpu/tfhe/transcript.py (reference semantics: the C++
reference's threshold transcript.h -- TranscriptBuilder (domain-separated
SHA-256 absorb/challenge), DomainTag, MerkleTree (batch commitments with
inclusion proofs)).  Pure Python hashlib, as in fhe_tpu: every digest is
fhe_tpu's byte for byte.  The port keeps its own copy because importing
fhe_tpu.tfhe loads jax.  `append_vector` also takes a tensor (its values
as little-endian u64, copied to the host once).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib

import numpy as np
import torch


class DomainTag(enum.IntEnum):
    """Domain separation tags (transcript.h:49-74)."""
    PROTOCOL = 0
    PARTY_ID = 1
    KEY_SHARE = 2
    CIPHERTEXT = 3
    PARTIAL_DEC = 4
    COMMITMENT = 5
    CHALLENGE = 6
    MERKLE_NODE = 7
    RESPONSE = 8
    INDEX = 9


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def u64_bytes(v) -> bytes:
    """Nonnegative integers (numpy, a list or a tensor on any device) as
    little-endian u64 words: fhe_tpu's `np.asarray(v, dtype=np.uint64)`
    bytes."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).astype("<u8").tobytes()


class TranscriptBuilder:
    """Domain-separated running-hash transcript (transcript.h:78).

    Each Append absorbs (tag || len || data) into a running SHA-256 chain;
    Challenge() finalizes with a ratchet so later absorbs stay bound."""

    def __init__(self, protocol: str):
        self._state = _h(bytes([DomainTag.PROTOCOL]) +
                         protocol.encode("utf-8"))

    def append(self, tag: DomainTag, data: bytes) -> None:
        blob = (self._state + bytes([int(tag)]) +
                len(data).to_bytes(8, "little") + data)
        self._state = _h(blob)

    def append_u64(self, tag: DomainTag, value: int) -> None:
        self.append(tag, int(value).to_bytes(8, "little"))

    def append_hash(self, tag: DomainTag, digest: bytes) -> None:
        if len(digest) != 32:
            raise ValueError(f"a digest is 32 bytes, got {len(digest)}")
        self.append(tag, digest)

    def append_vector(self, tag: DomainTag, v) -> None:
        self.append(tag, u64_bytes(v))

    def append_lwe(self, tag: DomainTag, a, b) -> None:
        self.append_vector(tag, a)
        self.append_vector(tag, b)          # a scalar's 8 bytes, as np.atleast_1d's

    def challenge(self) -> bytes:
        """32-byte Fiat-Shamir challenge; ratchets the state."""
        out = _h(self._state + bytes([int(DomainTag.CHALLENGE)]))
        self._state = _h(out + b"ratchet")
        return out

    def challenge_int(self, modulus: int) -> int:
        return int.from_bytes(self.challenge(), "little") % modulus

    @property
    def current_hash(self) -> bytes:
        return self._state


def derive_element_challenge(batch_challenge: bytes, index: int,
                             modulus: int) -> int:
    """Per-element challenge c_i = H(c || i) mod q
    (batch_threshold.h:163-168 'derive per-element challenges')."""
    return int.from_bytes(
        _h(batch_challenge + int(index).to_bytes(8, "little")),
        "little") % modulus


class MerkleTree:
    """Binary SHA-256 Merkle tree over leaf hashes (transcript.h:201)."""

    def __init__(self):
        self._levels: list[list[bytes]] = []

    def build(self, leaves: list[bytes]) -> None:
        if not leaves:
            raise ValueError("empty Merkle tree")
        level = [(_h(bytes([DomainTag.MERKLE_NODE]) + lf)) for lf in leaves]
        self._levels = [level]
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                right = level[i + 1] if i + 1 < len(level) else level[i]
                nxt.append(_h(level[i] + right))
            level = nxt
            self._levels.append(level)

    def build_from_data(self, blobs: list[bytes]) -> None:
        self.build([_h(b) for b in blobs])

    @property
    def root(self) -> bytes:
        return self._levels[-1][0]

    def leaf_hash(self, index: int) -> bytes:
        return self._levels[0][index]

    @dataclasses.dataclass
    class InclusionProof:
        index: int
        leaf_hash: bytes
        path: list[bytes]

    def prove_inclusion(self, index: int) -> "MerkleTree.InclusionProof":
        path = []
        i = index
        for level in self._levels[:-1]:
            sib = i ^ 1
            path.append(level[sib] if sib < len(level) else level[i])
            i >>= 1
        return MerkleTree.InclusionProof(index=index,
                                         leaf_hash=self._levels[0][index],
                                         path=path)

    @staticmethod
    def verify_inclusion(root: bytes, proof: "MerkleTree.InclusionProof"
                         ) -> bool:
        h = proof.leaf_hash
        i = proof.index
        for sib in proof.path:
            h = _h(h + sib) if i % 2 == 0 else _h(sib + h)
            i >>= 1
        return h == root
