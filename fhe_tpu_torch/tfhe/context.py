"""BinFHE context facade (port of fhe_tpu/tfhe/context.py).

A thin wrapper over the functions of lwe/rgsw/boot: parameters are static
Python data, keys and ciphertexts are dataclasses of tensors on
`self.device` (the first CUDA card unless the caller names another
device, such as "cpu"), and every Eval* accepts batched ciphertexts.
`ntt_impl` selects the GINX accumulator as in fhe_tpu
(`boot.run_accumulator`).  All three blind-rotation methods are ported
(GINX/CGGI, AP/DM and LMKCDEY) with a single-limb ring modulus, and GINX on
the 2-limb RNS ring (the sets with Q >= 2^31, `rgsw_rns`), where
`ntt_impl` changes nothing, as in fhe_tpu.  What fhe_tpu has no RNS path
for raises a named ValueError there (`_single_limb_only`): functional
bootstrapping (`funcboot`) runs on a single-limb GINX key only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import acc, boot, funcboot, lwe, rgsw, rgsw_rns
from .boot import Key
from .params import Gate, Method, TfheParams, make_params


def _rng(rng: np.random.Generator | int) -> np.random.Generator:
    return np.random.default_rng(rng) if isinstance(rng, int) else rng


@dataclasses.dataclass
class BinFheContext:
    params: TfheParams
    device: torch.device = torch.device("cuda")
    ntt_impl: str | None = None   # None: the natural-order whole scan (kernel 3)

    # -- construction -------------------------------------------------------
    @classmethod
    def generate(cls, param_set: str = "STD128", method: Method | str | None = None,
                 device: str | torch.device = "cuda",
                 ntt_impl: str | None = None) -> "BinFheContext":
        """method=None auto-selects from the paramset name (*_LMKCDEY sets
        get LMKCDEY, everything else GINX); an explicit incompatible method
        raises ValueError."""
        method = Method[method] if isinstance(method, str) else method
        return cls(params=make_params(param_set, method), device=torch.device(device),
                   ntt_impl=ntt_impl)

    def _single_limb_only(self, what: str) -> None:
        """ValueError for what has no 2-limb RNS ring path, here or in
        fhe_tpu (its rgsw_rns runs GINX keys and two-input gates only)."""
        if self.params.moduli_rns:
            raise ValueError(f"{self.params.name}: {what} has no path on the 2-limb RNS ring "
                             f"(Q = q1 q2 >= 2^31); fhe_tpu's rgsw_rns has none either")

    # -- key generation -----------------------------------------------------
    def key_gen(self, rng: np.random.Generator | int = 0) -> lwe.LweSecretKey:
        return lwe.keygen(self.params, _rng(rng), device=self.device)

    def key_gen_n(self, rng: np.random.Generator | int = 0) -> lwe.LweSecretKey:
        """A secret key of the ring dimension N."""
        return lwe.keygen(self.params, _rng(rng), dim=self.params.N, device=self.device)

    def bt_key_gen(self, sk: lwe.LweSecretKey, rng: np.random.Generator | int = 0,
                   sk_n: lwe.LweSecretKey | None = None) -> Key | rgsw_rns.RnsKey:
        """BTKeyGen: draws sk_n (unless given), then the switching key, then
        the bootstrap key of the context's method (on a 2-limb RNS ring, an
        `rgsw_rns.RnsKey`), in fhe_tpu's order.  A set LMKCDEY cannot key,
        and method AP on an RNS ring, raise ValueError before any draw."""
        p = self.params
        if p.method == Method.LMKCDEY:
            acc.check_lmkcdey(p)
        if p.method != Method.GINX:
            self._single_limb_only(f"method {p.method.value}")
        rng = _rng(rng)
        if sk_n is None:
            sk_n = lwe.keygen(p, rng, dim=p.N, device=self.device)
        ksk = lwe.key_switch_gen(p, sk, sk_n, rng)
        if p.moduli_rns:
            return rgsw_rns.RnsKey(bsk=rgsw_rns.bsk_gen_rns(p, sk, sk_n, rng), ksk=ksk)
        if p.method == Method.GINX:
            return rgsw.BootstrapKey(bsk=rgsw.bsk_gen(p, sk, sk_n, rng), ksk=ksk)
        if p.method == Method.AP:
            return acc.DmKey(bsk=acc.dm_bsk_gen(p, sk, sk_n, rng), ksk=ksk)
        rgsw_keys, auto_keys = acc.lmkcdey_key_gen(p, sk, sk_n, rng)
        return acc.LmkcdeyKey(rgsw=rgsw_keys, auto=auto_keys, ksk=ksk)

    def key_gen_pair(self, rng: np.random.Generator | int = 0
                     ) -> tuple[lwe.LweSecretKey, lwe.LweSecretKey, lwe.LwePublicKey]:
        """KeyGenPair: (sk of dimension n, sk_n of dimension N, the public
        key over N), drawn in fhe_tpu's order."""
        rng = _rng(rng)
        sk = lwe.keygen(self.params, rng, device=self.device)
        sk_n = lwe.keygen(self.params, rng, dim=self.params.N, device=self.device)
        return sk, sk_n, lwe.pub_key_gen(self.params, sk_n, rng)

    def encrypt_pk(self, pk: lwe.LwePublicKey, m, rng: np.random.Generator | int = 0,
                   p: int = 4, ksk: lwe.LweSwitchingKey | None = None) -> lwe.LweCiphertext:
        """Public-key encryption: dimension-N ciphertexts mod Q; with the
        bootstrap key's ksk, switched down to (n, q) for the gates."""
        ct = lwe.encrypt_pk(self.params, pk, m, _rng(rng), p)
        return ct if ksk is None else lwe.switch_ct_to_qn(self.params, ksk, ct)

    # -- encryption ---------------------------------------------------------
    def encrypt(self, sk: lwe.LweSecretKey, m, rng: np.random.Generator | int = 0,
                p: int = 4, modulus: int | None = None) -> lwe.LweCiphertext:
        return lwe.encrypt(self.params, sk, m, _rng(rng), p, modulus)

    def decrypt(self, sk: lwe.LweSecretKey, ct: lwe.LweCiphertext,
                p: int | None = None) -> torch.Tensor:
        return lwe.decrypt(self.params, sk, ct, p)

    # -- gates --------------------------------------------------------------
    def eval_bin_gate(self, key: Key, gate: Gate | str,
                      ct1: lwe.LweCiphertext, ct2: lwe.LweCiphertext,
                      extended: bool = False) -> lwe.LweCiphertext:
        gate = Gate[gate] if isinstance(gate, str) else gate
        if gate == Gate.CMUX:
            raise ValueError("CMUX takes 3 inputs")
        if self.params.moduli_rns:
            if extended:
                self._single_limb_only("extended=True (an output mod Q)")
            return rgsw_rns.eval_bin_gate_rns(self.params, key, gate, ct1, ct2)
        return boot.eval_bin_gate(self.params, key, gate, ct1, ct2, extended, self.ntt_impl)

    def eval_bin_gate_multi(self, key: Key, gate: Gate | str, cts,
                            extended: bool = False) -> lwe.LweCiphertext:
        gate = Gate[gate] if isinstance(gate, str) else gate
        self._single_limb_only("eval_bin_gate_multi")
        return boot.eval_bin_gate_multi(self.params, key, gate, list(cts), extended,
                                        self.ntt_impl)

    def eval_cmux(self, key: Key, ct0: lwe.LweCiphertext,
                  ct1: lwe.LweCiphertext, ct_sel: lwe.LweCiphertext) -> lwe.LweCiphertext:
        """CMUX by three NANDs (EvalBinGate vector overload): ct_sel ? ct1 : ct0."""
        nand1 = self.eval_bin_gate(key, Gate.NAND, ct0, self.eval_not(ct_sel))
        nand2 = self.eval_bin_gate(key, Gate.NAND, ct1, ct_sel)
        return self.eval_bin_gate(key, Gate.NAND, nand1, nand2)

    def eval_not(self, ct: lwe.LweCiphertext) -> lwe.LweCiphertext:
        return lwe.not_(ct)

    def eval_constant(self, value, batch: int | None = None) -> lwe.LweCiphertext:
        """Trivial (noiseless, a=0) encryption of a constant bit
        (EvalConstant -> NoiselessEmbedding): b = (q/4)*m, a = 0."""
        q, n = self.params.q, self.params.n
        v = np.asarray(value, dtype=np.int64)
        if batch is not None and v.ndim == 0:
            v = np.full(batch, int(v))
        b = torch.from_numpy((v % 4) * (q // 4)).to(self.device, torch.int32)
        a = torch.zeros(v.shape + (n,), dtype=torch.int32, device=self.device)
        return lwe.LweCiphertext(a=a, b=b, modulus=q, pt_mod=4)

    def key_switch_gen(self, sk: lwe.LweSecretKey, sk_n: lwe.LweSecretKey,
                       rng: np.random.Generator | int = 0) -> lwe.LweSwitchingKey:
        """KeySwitchGen: the LWE switching key from sk_n (dim N) to sk (dim n)."""
        return lwe.key_switch_gen(self.params, sk, sk_n, _rng(rng))

    def switch_ct_to_qn(self, ksk: lwe.LweSwitchingKey,
                        ct: lwe.LweCiphertext) -> lwe.LweCiphertext:
        """SwitchCTtoqn: ModSwitch -> KeySwitch -> ModSwitch an extended
        (N, Q) ciphertext to (n, q)."""
        return lwe.switch_ct_to_qn(self.params, ksk, ct)

    def bootstrap(self, key: Key, ct: lwe.LweCiphertext,
                  extended: bool = False) -> lwe.LweCiphertext:
        self._single_limb_only("bootstrap")
        return boot.bootstrap(self.params, key, ct, extended, self.ntt_impl)

    # -- functional bootstrapping (eprint 2021/1337) ------------------------
    def generate_lut(self, f, p: int) -> np.ndarray:
        """The LUT over Z_q of f: Z_p -> Z_p (GenerateLUTviaFunction)."""
        return funcboot.generate_lut(f, p, self.params.q)

    def eval_func(self, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
                  lut) -> lwe.LweCiphertext:
        self._single_limb_only("functional bootstrapping")
        return funcboot.eval_func(self.params, key, ct, lut, ntt_impl=self.ntt_impl)

    def eval_floor(self, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
                   roundbits: int = 0) -> lwe.LweCiphertext:
        self._single_limb_only("functional bootstrapping")
        return funcboot.eval_floor(self.params, key, ct, roundbits=roundbits,
                                   ntt_impl=self.ntt_impl)

    def eval_sign(self, key: rgsw.BootstrapKey, ct: lwe.LweCiphertext,
                  scheme_switch: bool = False) -> lwe.LweCiphertext:
        self._single_limb_only("functional bootstrapping")
        return funcboot.eval_sign(self.params, key, ct, scheme_switch=scheme_switch,
                                  ntt_impl=self.ntt_impl)

    def eval_decomp(self, key: rgsw.BootstrapKey,
                    ct: lwe.LweCiphertext) -> list[lwe.LweCiphertext]:
        self._single_limb_only("functional bootstrapping")
        return funcboot.eval_decomp(self.params, key, ct, ntt_impl=self.ntt_impl)

    @property
    def max_plaintext_space(self) -> int:
        """q / (2 beta)."""
        return self.params.q // (2 * funcboot.BETA)
