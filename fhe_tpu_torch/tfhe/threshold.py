"""Batched threshold (t-of-n) TFHE decryption with verifiable partial
decryptions.

Port of fhe_tpu/tfhe/threshold.py (reference semantics: the C++
reference's batch_threshold.h -- ThresholdConfig, KeyShare,
BatchPartialDecryption, the batched correctness proof, GenerateKeyShares,
ComputeLagrangeCoefficients, BatchCombineShares and
ThresholdDecryptPipeline).  As in fhe_tpu: additive n-of-n sharing for
any q, Shamir t-of-n for a prime modulus (Q-extended ciphertexts), and a
linear-map sigma protocol on every partial decryption (commit
R_j = <a_j, r>, Merkle-hash all R_j, one Fiat-Shamir challenge c, response
z = r + c s_i; the verifier checks <a_j, z> = R_j + c d_j for every j).

Device.  Shares, partial decryptions, commitments, responses and combined
messages are int64 tensors on the ciphertext's device (a share on its
secret's, on the card for a numpy secret).  The batch's inner
products ([B, dim] x [dim] mod q, `_inner_products`) are int64 PyTorch
there: the port's LWE residues are int32, so q < 2^31 and every product
of two residues fits in int64 (a larger modulus is a ValueError).  The
Merkle leaves are the values' little-endian u64 bytes, fhe_tpu's, made
from one host copy of the batch.  The CSPRNG draws (`_csprng_vec`, from
`secrets`) and the hashing are on the host, as in fhe_tpu; their bytes
are fhe_tpu's for the same `secrets` stream.
"""

from __future__ import annotations

import dataclasses
import secrets

import numpy as np
import torch

from . import lwe
from .transcript import DomainTag, MerkleTree, TranscriptBuilder, u64_bytes

MAX_Q = 1 << 31


@dataclasses.dataclass(frozen=True)
class ThresholdConfig:
    """batch_threshold.h ThresholdConfig."""
    threshold: int = 2
    total_parties: int = 3
    verify_proofs: bool = True
    generate_proofs: bool = True
    scheme: str = "additive"     # "additive" (n-of-n) or "shamir" (t-of-n)


@dataclasses.dataclass
class KeyShare:
    party_id: int                # 1-indexed
    share: torch.Tensor          # [dim] int64 mod q
    commitment: bytes            # transcript hash of the share


@dataclasses.dataclass
class VerificationKey:
    party_id: int
    commitment: bytes


@dataclasses.dataclass
class BatchPartialDecryption:
    party_id: int
    values: torch.Tensor         # [B] int64: d_j = <a_j, s_i> mod q
    batch_commitment: bytes      # Merkle root over values


@dataclasses.dataclass
class BatchCorrectnessProof:
    party_id: int
    commitments_R: torch.Tensor  # [B] int64: R_j = <a_j, r> mod q
    merkle_root: bytes
    batch_challenge: bytes
    response: torch.Tensor       # [dim] int64: z = r + c*s_i mod q


def _check_q(q: int) -> None:
    if not 2 <= q < MAX_Q:
        raise ValueError(f"threshold decryption takes a modulus below 2^31 (int32 residues, "
                         f"int64 products), got q = {q}")


def _csprng_vec(dim: int, q: int) -> np.ndarray:
    """Rejection-free uniform vector mod q from the OS CSPRNG (host)."""
    raw = np.frombuffer(secrets.token_bytes(8 * dim), dtype=np.uint64)
    return (raw % np.uint64(q)).astype(np.uint64)


def _share_commitment(party_id: int, share) -> bytes:
    tx = TranscriptBuilder("ShareCommit")
    tx.append_u64(DomainTag.KEY_SHARE, party_id)
    tx.append_vector(DomainTag.KEY_SHARE, share)
    return tx.challenge()


def _merkle_root(values: torch.Tensor) -> bytes:
    """Merkle root over the values' little-endian u64 bytes (one host copy)."""
    raw = u64_bytes(values.reshape(-1))
    mt = MerkleTree()
    mt.build_from_data([raw[i:i + 8] for i in range(0, len(raw), 8)])
    return mt.root


def generate_key_shares(sk_vec, q: int, cfg: ThresholdConfig
                        ) -> tuple[list[KeyShare], list[VerificationKey]]:
    """Split the LWE secret (as a vector mod q) into shares
    (GenerateKeyShares), on sk_vec's device if it is a tensor, else on the
    card.

    additive: sk = sum_i s_i mod q (n-of-n; works for any q).
    shamir: per-coefficient degree-(t-1) polynomials (t-of-n; requires
    prime q so Lagrange denominators invert -- use on Q-extended cts)."""
    _check_q(q)
    device = sk_vec.device if isinstance(sk_vec, torch.Tensor) else "cuda"
    if isinstance(sk_vec, torch.Tensor):
        sk_vec = sk_vec.cpu().numpy()
    n_par, t = cfg.total_parties, cfg.threshold
    dim = len(sk_vec)
    sk_mod = (np.asarray(sk_vec, dtype=np.int64) % q).astype(np.uint64)
    host = []
    if cfg.scheme == "additive":
        acc = np.zeros(dim, dtype=np.uint64)
        for pid in range(1, n_par):
            sh = _csprng_vec(dim, q)
            acc = (acc + sh) % np.uint64(q)
            host.append((pid, sh))
        host.append((n_par, (sk_mod + np.uint64(q) - acc % np.uint64(q)) % np.uint64(q)))
    elif cfg.scheme == "shamir":
        # check q prime enough for Lagrange on party ids
        for i in range(1, n_par + 1):
            for j in range(i + 1, n_par + 1):
                try:
                    pow(j - i, -1, q)
                except ValueError:
                    raise ValueError(
                        "shamir sharing needs pairwise-invertible party-id "
                        f"differences mod q={q}; use additive for 2^k moduli") from None
        coeffs = [sk_mod] + [_csprng_vec(dim, q) for _ in range(t - 1)]
        for pid in range(1, n_par + 1):
            sh = np.zeros(dim, dtype=np.uint64)
            x = 1
            for c in coeffs:
                sh = (sh + c * np.uint64(x)) % np.uint64(q)
                x = (x * pid) % q
            host.append((pid, sh))
    else:
        raise ValueError(cfg.scheme)
    shares = [KeyShare(pid, torch.from_numpy(sh.astype(np.int64)).to(device),
                       _share_commitment(pid, sh)) for pid, sh in host]
    vks = [VerificationKey(s.party_id, s.commitment) for s in shares]
    return shares, vks


def lagrange_coefficients(party_ids: list[int], q: int) -> list[int]:
    """lambda_i = prod_j j/(j-i) mod q at x=0 (ComputeLagrangeCoefficients)."""
    out = []
    for i in party_ids:
        num, den = 1, 1
        for j in party_ids:
            if j == i:
                continue
            num = (num * j) % q
            den = (den * (j - i)) % q
        out.append((num * pow(den, -1, q)) % q)
    return out


def _inner_products(a: torch.Tensor, s, q: int) -> torch.Tensor:
    """[B, dim] x [dim] -> [B] mod q, int64 on a's device: each product of
    two residues below 2^31 reduced before the sum (dim q < 2^63)."""
    _check_q(q)
    s = torch.as_tensor(s).to(device=a.device, dtype=torch.int64)
    return (a.to(torch.int64) * s % q).sum(-1) % q


def _mask_rows(cts: lwe.LweCiphertext) -> torch.Tensor:
    return cts.a.reshape(-1, cts.a.shape[-1])


def _challenge(party_id: int, commitment: bytes, root: bytes, root_R: bytes,
               q: int) -> tuple[int, bytes]:
    tx = TranscriptBuilder("PartialDecProof")
    tx.append_u64(DomainTag.PARTY_ID, party_id)
    tx.append_hash(DomainTag.COMMITMENT, commitment)
    tx.append_hash(DomainTag.MERKLE_NODE, root)
    tx.append_hash(DomainTag.MERKLE_NODE, root_R)
    return tx.challenge_int(q), tx.current_hash


def batch_partial_decrypt(cfg: ThresholdConfig, cts: lwe.LweCiphertext,
                          share: KeyShare
                          ) -> tuple[BatchPartialDecryption,
                                     BatchCorrectnessProof | None]:
    """BatchPartialDecrypt: d_j = <a_j, s_i>, optional batched
    sigma-protocol proof."""
    q = cts.modulus
    a = _mask_rows(cts)
    d = _inner_products(a, share.share, q)
    root = _merkle_root(d)
    out = BatchPartialDecryption(share.party_id, d, root)
    if not cfg.generate_proofs:
        return out, None
    r = torch.from_numpy(_csprng_vec(a.shape[1], q).astype(np.int64)).to(a.device)
    R = _inner_products(a, r, q)
    root_R = _merkle_root(R)
    c, state = _challenge(share.party_id, share.commitment, root, root_R, q)
    z = (r + c * share.share.to(a.device) % q) % q
    return out, BatchCorrectnessProof(share.party_id, R, root_R, state, z)


def batch_verify_proofs(cfg: ThresholdConfig, cts: lwe.LweCiphertext,
                        partial: BatchPartialDecryption,
                        proof: BatchCorrectnessProof,
                        vk: VerificationKey) -> bool:
    """BatchVerifyProofs: check <a_j, z> == R_j + c*d_j mod q for all j
    (one batched matvec)."""
    q = cts.modulus
    a = _mask_rows(cts)
    if _merkle_root(proof.commitments_R) != proof.merkle_root:
        return False
    c, _ = _challenge(proof.party_id, vk.commitment, _merkle_root(partial.values),
                      proof.merkle_root, q)
    lhs = _inner_products(a, proof.response, q)
    rhs = (proof.commitments_R.to(a.device) + c * partial.values.to(a.device) % q) % q
    return bool(torch.equal(lhs, rhs))


def batch_combine(cfg: ThresholdConfig, cts: lwe.LweCiphertext,
                  partials: list[BatchPartialDecryption],
                  p: int | None = None) -> torch.Tensor:
    """BatchCombineShares: m_j = round(p/q * (b_j - sum_i lambda_i d_{i,j})),
    int64 [B] on the ciphertext's device."""
    q = cts.modulus
    _check_q(q)
    p = p or cts.pt_mod
    b = cts.b.reshape(-1).to(torch.int64)
    if cfg.scheme == "additive":
        if len(partials) != cfg.total_parties:
            raise ValueError("additive sharing needs all n parties")
        lams = [1] * len(partials)
    else:
        ids = [pd.party_id for pd in partials]
        if len(ids) < cfg.threshold:
            raise ValueError("not enough shares")
        lams = lagrange_coefficients(ids, q)
    acc = torch.zeros_like(b)
    for lam, pd in zip(lams, partials):
        acc = (acc + lam * pd.values.to(b.device) % q) % q
    phase = (b + q - acc) % q
    return (phase.to(torch.float64) * p / q + 0.5).to(torch.int64) % p


def threshold_decrypt(cfg: ThresholdConfig, cts: lwe.LweCiphertext,
                      shares: list[KeyShare],
                      vks: list[VerificationKey] | None = None,
                      p: int | None = None) -> torch.Tensor:
    """ThresholdDecryptPipeline: single-process simulation of the full
    protocol (all parties in one process)."""
    partials = []
    for sh in shares:
        pd, proof = batch_partial_decrypt(cfg, cts, sh)
        if cfg.generate_proofs and cfg.verify_proofs and vks is not None:
            vk = next(v for v in vks if v.party_id == sh.party_id)
            if not batch_verify_proofs(cfg, cts, pd, proof, vk):
                raise ValueError(f"proof failed for party {sh.party_id}")
        partials.append(pd)
    return batch_combine(cfg, cts, partials, p)
