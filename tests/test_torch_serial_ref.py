"""fhe_tpu_torch/utils/serial_ref.py and serial_ref_pke.py on the
reference's cereal archives in tests/vectors, on the CPU.

The LWE archives load into the port's LweCiphertext with fhe_tpu's values
and decrypt with the reference's key; the PKE archives come back byte for
byte through `dump_binary(load_binary(...))`, and the reference's CKKS
ciphertexts decrypt through the port's decode, as
tests/test_serial_ref_pke.py does for fhe_tpu.
"""

import json
import os

import numpy as np
import pytest
import torch

from fhe_tpu.utils import serial_ref as jserial_ref
from fhe_tpu.utils import serial_ref_pke as jsp
from fhe_tpu_torch.pke import ckks
from fhe_tpu_torch.tfhe import lwe, make_params
from fhe_tpu_torch.utils import serial_ref
from fhe_tpu_torch.utils import serial_ref_pke as sp

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CPU = torch.device("cpu")
VEC = os.path.join(os.path.dirname(__file__), "vectors")
PKE = [("context", "pke_cc.bin"), ("private_key", "pke_sk.bin"), ("public_key", "pke_pk.bin"),
       ("ciphertext", "pke_ct.bin"), ("ciphertext", "pke_ct2.bin")]


def _p(name):
    return os.path.join(VEC, name)


def _manifest(name):
    with open(_p(name)) as f:
        return json.load(f)


def _lwe_sk() -> lwe.LweSecretKey:
    v = np.load(_p("serial_lwe_sk.npy")).astype(np.int64)
    return lwe.LweSecretKey(s=torch.from_numpy(np.where(v > 1, -1, v).astype(np.int32)))


@pytest.mark.parametrize("bit", (0, 1))
def test_lwe_binary_archive_decrypts(bit):
    ct = serial_ref.load_lwe_binary(_p(f"serial_lwe_ct{bit}.bin"), device=CPU)
    assert ct.modulus == _manifest("manifest_pke.json")["serial_lwe"]["q"]
    assert ct.a.dtype == torch.int32 and ct.a.device == CPU
    assert int(lwe.decrypt(make_params("TOY"), _lwe_sk(), ct, p=4)) == bit
    ref = jserial_ref.load_lwe_binary(_p(f"serial_lwe_ct{bit}.bin"))
    np.testing.assert_array_equal(ct.a.numpy(), np.asarray(ref.a).astype(np.int64))
    assert int(ct.b) == int(ref.b) and (ct.modulus, ct.pt_mod) == (ref.modulus, ref.pt_mod)


@pytest.mark.parametrize("bit", (0, 1))
def test_lwe_json_archive_matches_binary(bit):
    cb = serial_ref.load_lwe_binary(_p(f"serial_lwe_ct{bit}.bin"), device=CPU)
    cj = serial_ref.load_lwe_json(_p(f"serial_lwe_ct{bit}.json"), device=CPU)
    assert torch.equal(cb.a, cj.a) and torch.equal(cb.b, cj.b) and cb.modulus == cj.modulus


@pytest.mark.parametrize("bit", (0, 1))
def test_lwe_binary_round_trip_byte_identical(bit, tmp_path):
    src = _p(f"serial_lwe_ct{bit}.bin")
    out = tmp_path / "roundtrip.bin"
    serial_ref.dump_lwe_binary(serial_ref.load_lwe_binary(src, device=CPU), str(out))
    assert out.read_bytes() == open(src, "rb").read()


def test_lwe_archive_errors(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00" + open(_p("serial_lwe_ct0.bin"), "rb").read()[1:])
    with pytest.raises(ValueError, match="little-endian"):
        serial_ref.load_lwe_binary(str(bad), device=CPU)
    bad.write_bytes(open(_p("serial_lwe_ct0.bin"), "rb").read() + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        serial_ref.load_lwe_binary(str(bad), device=CPU)
    bad.write_text("{}")
    with pytest.raises(ValueError, match="not a serialized LWE"):
        serial_ref.load_lwe_json(str(bad), device=CPU)
    ct = serial_ref.load_lwe_binary(_p("serial_lwe_ct0.bin"), device=CPU)
    two = lwe.LweCiphertext(a=ct.a.expand(2, -1), b=ct.b.expand(2), modulus=ct.modulus)
    with pytest.raises(ValueError, match="one ciphertext"):
        serial_ref.dump_lwe_binary(two, str(bad))


@pytest.mark.parametrize("kind,name", PKE, ids=[n for _, n in PKE])
def test_pke_binary_round_trip_byte_identical(kind, name):
    tree = sp.load_binary(_p(name), kind)
    with open(_p(name), "rb") as f:
        assert sp.dump_binary(tree, kind) == f.read()


def test_pke_context_summary_matches_fhe_tpu():
    tree = sp.load_binary(_p("pke_cc.bin"), "context")
    info = sp.context_summary(tree)
    assert info == jsp.context_summary(jsp.load_binary(_p("pke_cc.bin"), "context"))
    man = _manifest("manifest_pke_ser.json")
    assert info["ring_dim"] == man["ring_dim"] and len(info["moduli"]) == man["depth"] + 1


def _inverse_ref_ntt(ev, q: int, psi: int) -> list:
    """coeff_j = N^-1 sum_i ev[i] psi^{-(2 br(i) + 1) j} mod q, exactly: the
    reference's EVALUATION towers are eval[i] = a(psi^(2 br(i) + 1))
    (transformnat-impl.h:302)."""
    N = len(ev)
    logn = N.bit_length() - 1
    br = [int(format(i, f"0{logn}b")[::-1], 2) for i in range(N)]
    psi_inv = pow(psi, -1, q)
    pows = [pow(psi_inv, e, q) for e in range(2 * N)]
    ninv = pow(N, -1, q)
    e_i = [(2 * br[i] + 1) % (2 * N) for i in range(N)]
    return [sum(int(ev[i]) * pows[e_i[i] * j % (2 * N)] for i in range(N)) % q * ninv % q
            for j in range(N)]


def _decrypt_archive(ct_tree, sk_tree) -> np.ndarray:
    """phase c0 + c1 s per tower (the 40/50-bit limbs as Python ints), the
    reference's inverse NTT, Garner's CRT: the centred coefficients."""
    table = sp.build_ptr_table(ct_tree)
    els = ct_tree["data"]["v"]
    c0, mods, fmt = sp.dcrt_to_arrays(els[0])
    c1, _, _ = sp.dcrt_to_arrays(els[1])
    s, smods, _ = sp.dcrt_to_arrays(sk_tree["data"]["s"])
    assert fmt == "EVAL" and smods[:len(mods)] == mods
    towers = sp.deref(els[0]["p"], table)["towers"]
    roots = [int(sp.deref(t, table)["base"]["ru"]) for t in towers]
    limbs = [_inverse_ref_ntt([(int(a) + int(b) * int(c)) % q for a, b, c in zip(c0[i], c1[i], s[i])],
                              q, roots[i]) for i, q in enumerate(mods)]
    Q = int(np.prod([int(q) for q in mods], dtype=object))
    coefs = []
    for j in range(len(limbs[0])):
        x, m = 0, 1
        for limb, q in zip(limbs, mods):
            x += (limb[j] - x) % q * pow(m % q, -1, q) % q * m
            m *= q
        coefs.append(float(x - Q if x > Q // 2 else x))
    return np.array(coefs)


@pytest.mark.parametrize("name,scale_key,power", [("pke_ct.bin", "scale", 1),
                                                  ("pke_ct2.bin", "scale2", 2)])
def test_reference_ciphertext_decrypts_through_the_port(name, scale_key, power):
    """pke_ct.bin decodes to the values, pke_ct2.bin (EvalMult + Rescale)
    to their squares, with the port's CKKS decode."""
    man = _manifest("manifest_pke_ser.json")
    coefs = _decrypt_archive(sp.load_binary(_p(name), "ciphertext"),
                             sp.load_binary(_p("pke_sk.bin"), "private_key"))
    got = ckks.decode(coefs, man["ring_dim"], man[scale_key])
    want = np.load(_p("pke_ser_values.npy")) ** power
    assert np.abs(got[:man["slots"]].real - want).max() < (1e-4 if power == 1 else 1e-3)
