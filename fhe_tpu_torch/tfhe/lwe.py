"""LWE scheme: keygen, encrypt/decrypt, modulus and key switching.

Port of fhe_tpu/tfhe/lwe.py (reference semantics: lwe-pke.cpp RoundqQ,
KeyGen, Encrypt, Decrypt, KeySwitchGen/KeySwitch, SwitchCTtoqn).  Host
randomness comes from an explicit `np.random.Generator`, drawn with the
same calls in the same order as fhe_tpu, so one seed gives byte-identical
keys and ciphertexts.  Residues are int32 tensors; arithmetic is int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math.modmath import add_mod, neg_mod, round_scale_mod, sub_mod, sum_mod
from .params import KeyDist, TfheParams

# peak bytes of the gathered key-switch rows (and of their int64 copy,
# where the sums need one) per batch chunk
KS_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class LweCiphertext:
    """(a, b) with b = <a,s> + e + encode(m); arbitrary leading batch dims.

    a: [..., n] int32, b: [...] int32, residues mod `modulus`."""
    a: torch.Tensor
    b: torch.Tensor
    modulus: int
    pt_mod: int = 4

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.b.shape)

    def to(self, device) -> "LweCiphertext":
        return dataclasses.replace(self, a=self.a.to(device), b=self.b.to(device))


@dataclasses.dataclass(frozen=True)
class LweSecretKey:
    """Secret key as small signed ints (ternary {-1,0,1} or Gaussian), int32."""
    s: torch.Tensor

    def to(self, device) -> "LweSecretKey":
        return LweSecretKey(s=self.s.to(device))


@dataclasses.dataclass(frozen=True)
class LweSwitchingKey:
    """KSK[i, k, j] = LWE_{sk,qKS}(j * Bks^k * skN[i]).

    a: [N, dc, Bks, n] int32; b: [N, dc, Bks] int32."""
    a: torch.Tensor
    b: torch.Tensor

    def to(self, device) -> "LweSwitchingKey":
        return LweSwitchingKey(a=self.a.to(device), b=self.b.to(device))


def _sample_error(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """Rounded-Gaussian error, drawn as fhe_tpu draws it."""
    return np.rint(rng.normal(0.0, std, size=shape)).astype(np.int64)


def _residues(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32)).to(device)


def keygen(params: TfheParams, rng: np.random.Generator, dim: int | None = None,
           device="cuda") -> LweSecretKey:
    """Ternary (or Gaussian) secret of dimension n (lwe-pke.cpp:48-56)."""
    dim = params.n if dim is None else dim
    if params.key_dist == KeyDist.GAUSSIAN:
        s = _sample_error(rng, dim, params.std_dev)
    else:
        s = rng.integers(-1, 2, size=dim, dtype=np.int64)
    return LweSecretKey(s=_residues(s, device))


def _dot_mod(a: torch.Tensor, s: torch.Tensor, q: int) -> torch.Tensor:
    """<a, s> mod q for a [..., n] and s [n], both in [0, q)."""
    return sum_mod(a.to(torch.int64) * s % q, -1, q)


def encrypt(params: TfheParams, sk: LweSecretKey, m, rng: np.random.Generator,
            p: int = 4, modulus: int | None = None) -> LweCiphertext:
    """b = (m mod p)*(q/p) + e + <a, s> mod q (lwe-pke.cpp:103-128).

    m: int or int array -> batch of ciphertexts, on the key's device."""
    q = params.q if modulus is None else modulus
    m = np.asarray(m, dtype=np.int64)
    n = int(sk.s.shape[0])
    a_np = rng.integers(0, q, size=m.shape + (n,), dtype=np.int64)
    e = _sample_error(rng, m.shape, params.std_dev)
    b0 = ((m % p) * (q // p) + e) % q
    dev = sk.s.device
    a = _residues(a_np, dev)
    s = sk.s.to(torch.int64) % q
    b = add_mod(torch.from_numpy(b0).to(dev), _dot_mod(a, s, q), q)
    return LweCiphertext(a=a, b=b.to(torch.int32), modulus=q, pt_mod=p)


@dataclasses.dataclass(frozen=True)
class LwePublicKey:
    """LWE public key over the ring dimension N (lwe-pke.cpp PubKeyGen):
    A [N, N] uniform, v = A s + e, int32 residues mod `modulus` (= Q)."""
    A: torch.Tensor
    v: torch.Tensor
    modulus: int

    def to(self, device) -> "LwePublicKey":
        return dataclasses.replace(self, A=self.A.to(device), v=self.v.to(device))


def pub_key_gen(params: TfheParams, sk_n: LweSecretKey,
                rng: np.random.Generator) -> LwePublicKey:
    """PubKeyGen: v_j = <A[j], s> + e_j mod Q, host numpy (exact: |A s| <
    N Q), output on sk_n's device."""
    Q = params.Q
    if Q >= 2**31:
        raise NotImplementedError("public-key mode needs a single-limb Q < 2^31 "
                                  "(use a non-RNS paramset)")
    N = int(sk_n.s.shape[0])
    A = rng.integers(0, Q, size=(N, N), dtype=np.int64)
    s = sk_n.s.cpu().numpy().astype(np.int64)
    e = _sample_error(rng, N, params.std_dev)
    v = (A @ s + e) % Q
    dev = sk_n.s.device
    return LwePublicKey(A=_residues(A, dev), v=_residues(v, dev), modulus=Q)


def encrypt_pk(params: TfheParams, pk: LwePublicKey, m, rng: np.random.Generator,
               p: int = 4) -> LweCiphertext:
    """Public-key encryption (lwe-pke.cpp EncryptN): a ternary combiner sp
    per message, a = A^t sp + e_a, b = m Q/p + e_b + <v, sp> mod Q.  Gives
    dimension-N ciphertexts mod Q on the key's device; switch_ct_to_qn
    brings them to (n, q).

    sp, e_a and e_b are drawn on the host in fhe_tpu's order (8 bytes a
    coefficient of each, the batch's only host work).  The products sp A
    and sp v run on the key's device as float64 matrix products, which are
    exact: every partial sum is an integer below N Q < 2^53."""
    Q = pk.modulus
    m = np.asarray(m, dtype=np.int64)
    N = pk.A.shape[0]
    sp = rng.integers(-1, 2, size=m.shape + (N,), dtype=np.int64)
    e_a = _sample_error(rng, m.shape + (N,), params.std_dev)
    e_b = _sample_error(rng, m.shape, params.std_dev)
    dev = pk.A.device
    spf = torch.from_numpy(sp.astype(np.int8)).to(dev).to(torch.float64)
    a = torch.matmul(spf, pk.A.to(torch.float64)).to(torch.int64)
    a = torch.remainder(a + torch.from_numpy(e_a).to(dev), Q)
    b = torch.matmul(spf, pk.v.to(torch.float64)).to(torch.int64)
    b = torch.remainder(b + torch.from_numpy((m % p) * (Q // p) + e_b).to(dev), Q)
    return LweCiphertext(a=a.to(torch.int32), b=b.to(torch.int32), modulus=Q, pt_mod=p)


def decrypt(params: TfheParams, sk: LweSecretKey, ct: LweCiphertext,
            p: int | None = None) -> torch.Tensor:
    """floor(p/q * (b - <a,s>) + 1/2) (lwe-pke.cpp:182-214), int32."""
    p = ct.pt_mod if p is None else p
    q = ct.modulus
    s = sk.s.to(ct.a.device, torch.int64) % q
    r = sub_mod(ct.b, _dot_mod(ct.a, s, q), q)
    r = add_mod(r, q // (p * 2), q)
    return (r * p // q % p).to(torch.int32)


def noise(params: TfheParams, sk: LweSecretKey, ct: LweCiphertext, m,
          p: int | None = None) -> torch.Tensor:
    """Signed error e = b - <a,s> - encode(m), in (-q/2, q/2], int32."""
    p = ct.pt_mod if p is None else p
    q = ct.modulus
    s = sk.s.to(ct.a.device, torch.int64) % q
    r = sub_mod(ct.b, _dot_mod(ct.a, s, q), q)
    enc = torch.from_numpy(np.asarray(m, dtype=np.int64) % p * (q // p)).to(r.device)
    e = sub_mod(r, enc, q)
    return torch.where(e > q // 2, e - q, e).to(torch.int32)


def add(ct1: LweCiphertext, ct2: LweCiphertext) -> LweCiphertext:
    q = ct1.modulus
    return LweCiphertext(a=add_mod(ct1.a, ct2.a, q).to(torch.int32),
                         b=add_mod(ct1.b, ct2.b, q).to(torch.int32),
                         modulus=q, pt_mod=ct1.pt_mod)


def not_(ct: LweCiphertext) -> LweCiphertext:
    """EvalNOT: (-a, q/4 - b) (binfhe-base-scheme.cpp EvalNOT)."""
    q = ct.modulus
    return LweCiphertext(a=neg_mod(ct.a, q).to(torch.int32),
                         b=sub_mod(q >> 2, ct.b, q).to(torch.int32),
                         modulus=q, pt_mod=ct.pt_mod)


def mod_switch(ct: LweCiphertext, q_to: int) -> LweCiphertext:
    """RoundqQ on every component (lwe-pke.cpp ModSwitch)."""
    Q = ct.modulus
    return LweCiphertext(
        a=round_scale_mod(ct.a, q_to, Q, q_to).to(torch.int32),
        b=round_scale_mod(ct.b, q_to, Q, q_to).to(torch.int32),
        modulus=q_to, pt_mod=ct.pt_mod)


def key_switch_gen(params: TfheParams, sk: LweSecretKey, sk_n: LweSecretKey,
                   rng: np.random.Generator) -> LweSwitchingKey:
    """KSK[i,k,j] encrypting j * Bks^k * skN[i] under sk, mod qKS
    (lwe-pke.cpp KeySwitchGen).  Host numpy (exact), output on sk's device."""
    q = params.q_ks
    n = int(sk.s.shape[0])
    N = int(sk_n.s.shape[0])
    bks, dc = params.base_ks, params.digits_ks
    s = sk.s.cpu().numpy().astype(np.int64) % q
    sN = sk_n.s.cpu().numpy().astype(np.int64) % q

    a = rng.integers(0, q, size=(N, dc, bks, n), dtype=np.int64)
    e = _sample_error(rng, (N, dc, bks), params.std_dev)
    pow_k = np.array([pow(bks, k, q) for k in range(dc)], dtype=np.int64)
    j = np.arange(bks, dtype=np.int64)
    msg = (sN[:, None, None] * pow_k[None, :, None] * j[None, None, :]) % q
    dot = (a.reshape(-1, n) @ s).reshape(N, dc, bks) % q
    b = (msg + e + dot) % q
    dev = sk.s.device
    return LweSwitchingKey(a=_residues(a, dev), b=_residues(b, dev))


def key_switch(params: TfheParams, ksk: LweSwitchingKey,
               ct: LweCiphertext) -> LweCiphertext:
    """Dim N -> dim n at modulus qKS: (a', b') = (0, b) - sum_{i,k}
    KSK[i, k, digit_{i,k}(a_i)] (lwe-pke.cpp KeySwitch).

    Gather semantics (fhe_tpu lwe.key_switch impl="gather").  The gathered
    rows [B, N*dc, n] would take ~25 GB at STD128 batch 4096, so the batch
    runs in chunks of at most KS_CHUNK_BYTES.  Where the N*dc terms of a sum
    stay below 2^31 (STD128: 3072 terms < 2^14) the rows are summed in
    int32; otherwise (TOY, q_ks = Q) they are widened to int64 first."""
    q = params.q_ks
    if ct.modulus != q:
        raise ValueError(f"key switch expects modulus {q}, got {ct.modulus}")
    bks, dc = params.base_ks, params.digits_ks
    N = ct.a.shape[-1]
    n = ksk.a.shape[-1]
    lead = ct.batch_shape
    dev = ct.a.device
    a_in = ct.a.reshape(-1, N).to(torch.int64)
    b_in = ct.b.reshape(-1).to(torch.int64)
    B = a_in.shape[0]
    ka = ksk.a.reshape(N * dc * bks, n)
    kb = ksk.b.reshape(N * dc * bks)
    shifts = torch.tensor([bks ** k for k in range(dc)], dtype=torch.int64, device=dev)
    row_base = torch.arange(N * dc, dtype=torch.int64, device=dev) * bks
    narrow = N * dc * (q - 1) < 2**31
    row_bytes = N * dc * n * (4 if narrow else 4 + 8)
    chunk = max(1, KS_CHUNK_BYTES // row_bytes)
    a_out = torch.empty(B, n, dtype=torch.int32, device=dev)
    b_out = torch.empty(B, dtype=torch.int32, device=dev)
    for lo in range(0, B, chunk):
        hi = min(B, lo + chunk)
        d = (a_in[lo:hi, :, None] // shifts) % bks              # [Bc, N, dc]
        rows = row_base + d.reshape(hi - lo, N * dc)            # [Bc, N*dc]
        if narrow:
            sa = ka[rows].sum(dim=1, dtype=torch.int32) % q     # [Bc, n]
            sb = kb[rows].sum(dim=1, dtype=torch.int32) % q
        else:
            sa = sum_mod(ka[rows], 1, q)
            sb = sum_mod(kb[rows], 1, q)
        a_out[lo:hi] = neg_mod(sa, q)
        b_out[lo:hi] = sub_mod(b_in[lo:hi], sb, q)
    return LweCiphertext(a=a_out.reshape(*lead, n), b=b_out.reshape(lead),
                         modulus=q, pt_mod=ct.pt_mod)


def switch_ct_to_qn(params: TfheParams, ksk: LweSwitchingKey,
                    ct: LweCiphertext) -> LweCiphertext:
    """ModSwitch(qKS) -> KeySwitch -> ModSwitch(q) (lwe-pke.cpp:170-178)."""
    ct_ms = mod_switch(ct, params.q_ks)
    ct_ks = key_switch(params, ksk, ct_ms)
    return mod_switch(ct_ks, params.q)
