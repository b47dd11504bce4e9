"""fhe_tpu_torch/utils/serial.py and pke/keycache.py against fhe_tpu on
the CPU.

One wire format for both packages: the port's archives of an LWE
ciphertext, an LWE secret key, a CKKS ciphertext and an fhEVM
EncryptedInt (tests/test_torch_radix.py) are byte-identical to fhe_tpu's
for the same values, binary and JSON, and fhe_tpu's archives load in the
port to the same values.  The fhe_tpu objects are built from the port's
tensors (their residue words as uint32), so the two packages hold the same
values by construction.
"""

import dataclasses
import enum
import importlib
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.lattice import rns as jrns
from fhe_tpu.pke import ckks as jckks
from fhe_tpu.pke import keycache as jkeycache
from fhe_tpu.pke import rlwe as jrlwe
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import rgsw as jrgsw
from fhe_tpu.utils import serial as jserial
from fhe_tpu_torch import BinFheContext, CkksContext
from fhe_tpu_torch.pke import keycache
from fhe_tpu_torch.tfhe import lwe, rgsw
from fhe_tpu_torch.utils import serial

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

CPU = torch.device("cpu")
MODES = ("binary", "json")


def _u32(t: torch.Tensor):
    return jnp.asarray(t.numpy().view(np.uint32))


def _jpoly(p):
    return jrns.RnsPoly(_u32(p.data), tuple(p.moduli), p.fmt)


@pytest.fixture(scope="module")
def lwe_pair():
    """(port, fhe_tpu) TOY secret key and a batch of 8 ciphertexts."""
    ctx = BinFheContext.generate("TOY", device=CPU)
    rng = np.random.default_rng(7)
    sk = ctx.key_gen(rng)
    ct = ctx.encrypt(sk, rng.integers(0, 2, size=8), rng)
    jsk = jlwe.LweSecretKey(s=jnp.asarray(sk.s.numpy()))
    jct = jlwe.LweCiphertext(a=_u32(ct.a), b=_u32(ct.b), modulus=ct.modulus, pt_mod=ct.pt_mod)
    return {"secret key": (sk, jsk), "ciphertext": (ct, jct)}


@pytest.fixture(scope="module")
def ckks_state():
    ctx = CkksContext.create(N=128, num_levels=3, scale_bits=26, dnum=2, device=CPU)
    rng = np.random.default_rng(11)
    sk, pk = ctx.keygen(rng)
    z = rng.normal(size=64)
    ct = ctx.encrypt(pk, z, rng)
    jct = jckks.Ciphertext(c0=_jpoly(ct.c0), c1=_jpoly(ct.c1), scale=ct.scale)
    return ctx, rng, sk, pk, z, ct, jct


def _wire(kind, lwe_pair, ckks_state):
    if kind == "CKKS ciphertext":
        return ckks_state[5], ckks_state[6]
    return lwe_pair[kind]


WIRE = ("ciphertext", "secret key", "CKKS ciphertext")


@pytest.mark.parametrize("mod,name,unsigned", serial.COUNTERPARTS,
                         ids=[f"{m}.{n}" for m, n, _ in serial.COUNTERPARTS])
def test_counterpart_has_the_same_fields(mod, name, unsigned):
    """Each class written under an fhe_tpu tag has fhe_tpu's fields (or
    enum members) in fhe_tpu's order; its unsigned fields are fields."""
    port = getattr(importlib.import_module(f"fhe_tpu_torch.{mod}"), name)
    ref = getattr(importlib.import_module(f"fhe_tpu.{mod}"), name)
    if issubclass(port, enum.Enum):
        assert [(e.name, e.value) for e in port] == [(e.name, e.value) for e in ref]
    else:
        names = [f.name for f in dataclasses.fields(port)]
        assert names == [f.name for f in dataclasses.fields(ref)]
        assert set(unsigned) <= set(names)
    assert serial._type_tag(port) == f"{ref.__module__}.{ref.__qualname__}"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", WIRE)
def test_archive_byte_identical_to_fhe_tpu(kind, mode, lwe_pair, ckks_state):
    port, ref = _wire(kind, lwe_pair, ckks_state)
    assert serial.dumps(port, mode) == jserial.dumps(ref, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", WIRE)
def test_fhe_tpu_archive_loads_to_equal_tensors(kind, mode, lwe_pair, ckks_state):
    port, ref = _wire(kind, lwe_pair, ckks_state)
    got = serial.loads(jserial.dumps(ref, mode), mode, device=CPU)
    assert type(got) is type(port)
    for f in dataclasses.fields(port):
        a, b = getattr(got, f.name), getattr(port, f.name)
        if isinstance(b, torch.Tensor):
            assert a.device == CPU and a.dtype == b.dtype and torch.equal(a, b)
        elif hasattr(b, "data"):                       # RnsPoly
            assert torch.equal(a.data, b.data) and (a.moduli, a.fmt) == (b.moduli, b.fmt)
        else:
            assert a == b


def test_loaded_ciphertexts_decrypt(lwe_pair, ckks_state):
    ctx = BinFheContext.generate("TOY", device=CPU)
    (sk, jsk), (ct, jct) = lwe_pair["secret key"], lwe_pair["ciphertext"]
    back = serial.loads(jserial.dumps(jct), device=CPU)
    assert torch.equal(ctx.decrypt(sk, back), ctx.decrypt(sk, ct))
    cctx, _, csk, _, z, _, cjct = ckks_state
    np.testing.assert_allclose(cctx.decrypt(csk, serial.loads(jserial.dumps(cjct), device=CPU)).real,
                               z, atol=1e-3)


def test_fhe_tpu_type_without_counterpart_raises():
    """fhe_tpu's BootstrapKey has a field the port's has not (its Shoup
    duals): its archive names a type the port does not read."""
    a = np.zeros((2, 1, 2, 2, 8), dtype=np.uint32)
    ksk = jlwe.LweSwitchingKey(a=jnp.zeros((8, 1, 2, 2), jnp.uint32),
                               b=jnp.zeros((8, 1, 2), jnp.uint32))
    blob = jserial.dumps(jrgsw.BootstrapKey(bsk=jnp.asarray(a), ksk=ksk, bsk_shoup=None))
    with pytest.raises(serial.UnknownTypeError, match="fhe_tpu.tfhe.rgsw.BootstrapKey"):
        serial.loads(blob, device=CPU)


def test_unknown_tag_is_never_imported():
    """A tag naming any module raises before anything is imported."""
    assert "this" not in sys.modules
    spec = {"r": {"kind": "object", "type": "this.Nothing", "fields": []}}
    doc = json.dumps({"header": {"version": 1, "spec": spec}, "arrays": {}}).encode()
    with pytest.raises(serial.UnknownTypeError, match="this.Nothing"):
        serial.loads(doc, "json", device=CPU)
    spec = {"r": {"kind": "enum", "type": "antigravity.Fly", "name": "UP"}}
    doc = json.dumps({"header": {"version": 1, "spec": spec}, "arrays": {}}).encode()
    with pytest.raises(serial.UnknownTypeError):
        serial.loads(doc, "json", device=CPU)
    assert "this" not in sys.modules and "antigravity" not in sys.modules


def test_dict_keys_are_read_without_eval():
    obj = {1: b"\x00\x01", -3: (None, "x", 2.5), "k": [True, torch.arange(4)], (1, "a"): {}}
    for mode in MODES:
        back = serial.loads(serial.dumps(obj, mode), mode, device=CPU)
        assert set(back) == set(obj) and back[1] == b"\x00\x01" and back[-3] == (None, "x", 2.5)
        assert back["k"][0] is True and torch.equal(back["k"][1], torch.arange(4))
    spec = {"r": {"kind": "dict", "keys": ["__import__('os')"]}}
    doc = json.dumps({"header": {"version": 1, "spec": spec}, "arrays": {}}).encode()
    with pytest.raises(ValueError):
        serial.loads(doc, "json", device=CPU)


def test_port_only_type_round_trip(tmp_path):
    """A port class with no counterpart of the same fields goes under its
    own tag; its int32 words stay int32."""
    rng = np.random.default_rng(3)
    ksk = lwe.LweSwitchingKey(a=torch.from_numpy(rng.integers(0, 99, (8, 1, 2, 2), dtype=np.int32)),
                              b=torch.from_numpy(rng.integers(0, 99, (8, 1, 2), dtype=np.int32)))
    key = rgsw.BootstrapKey(bsk=torch.from_numpy(rng.integers(0, 99, (2, 2, 1, 2, 8),
                                                              dtype=np.int32)), ksk=ksk)
    blob = serial.dumps(key)
    header = json.loads(bytes(np.load(io.BytesIO(blob))["__header__"]).decode())
    assert header["spec"]["r"]["type"] == "fhe_tpu_torch.tfhe.rgsw.BootstrapKey"
    assert header["spec"]["r.ksk"]["type"] == "fhe_tpu.tfhe.lwe.LweSwitchingKey"
    path = str(tmp_path / "key.fhe")
    serial.save(key, path)
    back = serial.load(path, device=CPU)
    assert torch.equal(back.bsk, key.bsk) and torch.equal(back.ksk.a, key.ksk.a)
    assert serial.dumps(back) == blob


@dataclasses.dataclass
class _Custom:
    x: torch.Tensor
    tag: str


def test_classes_outside_the_table():
    """A dataclass outside the table does not read back for having been
    written in this process; once registered, it reads back under its own
    tag, and an unregistered one from elsewhere still does not."""
    obj = _Custom(torch.arange(3, dtype=torch.int32), "t")
    blob = serial.dumps(obj)
    with pytest.raises(serial.UnknownTypeError, match="_Custom"):
        serial.loads(blob, device=CPU)
    assert serial.register(_Custom) is _Custom
    back = serial.loads(blob, device=CPU)
    assert type(back) is _Custom and torch.equal(back.x, obj.x) and back.tag == "t"

    @dataclasses.dataclass
    class Fresh:
        y: int
    blob = serial.dumps(Fresh(4), "json").replace(b"Fresh", b"Frash")
    with pytest.raises(serial.UnknownTypeError):
        serial.loads(blob, "json", device=CPU)
    Frash = dataclasses.make_dataclass("Frash", [("y", int)])
    Frash.__module__, Frash.__qualname__ = Fresh.__module__, Fresh.__qualname__.replace(
        "Fresh", "Frash")
    assert serial.register(Frash) is Frash
    assert serial.loads(blob, "json", device=CPU) == Frash(4)


def test_newer_format_version_raises(lwe_pair):
    doc = json.loads(serial.dumps(lwe_pair["secret key"][0], "json"))
    doc["header"]["version"] = serial.FORMAT_VERSION + 1
    with pytest.raises(ValueError, match="too new"):
        serial.loads(json.dumps(doc).encode(), "json", device=CPU)


def test_key_cache_round_trip(ckks_state):
    """Per-tag mult and automorphism keys: serialised, cleared, restored
    (the mult key's archive byte-identical to fhe_tpu's key cache's), and
    the restored keys still multiply and rotate."""
    ctx, rng, sk, pk, z, ct, _ = ckks_state
    evk = ctx.relin_key_gen(sk, rng)
    rot = ctx.rotation_key_gen(sk, [1, -1], rng)
    keycache.clear_eval_mult_keys()
    keycache.clear_eval_automorphism_keys()
    keycache.insert_eval_mult_key(evk, "alice")
    keycache.insert_eval_automorphism_key(rot, "alice")
    assert keycache.get_existing_eval_automorphism_key_indices("alice") == [-1, 1]
    blob = keycache.serialize_eval_mult_key("alice")
    ablob = keycache.serialize_eval_automorphism_key("alice", mode="json")
    jkeycache.clear_eval_mult_keys()
    jkeycache.insert_eval_mult_key(jrlwe.EvalKey(b=_u32(evk.b), a=_u32(evk.a),
                                                 moduli_qp=tuple(evk.moduli_qp),
                                                 num_per_part=evk.num_per_part), "alice")
    assert blob == jkeycache.serialize_eval_mult_key("alice")
    jkeycache.clear_eval_mult_keys()
    keycache.clear_eval_mult_keys("alice")
    keycache.clear_eval_automorphism_keys("alice")
    assert keycache.get_all_eval_mult_keys() == {}
    assert keycache.deserialize_eval_mult_key(blob, device=CPU) == ["alice"]
    assert keycache.deserialize_eval_automorphism_key(ablob, mode="json", device=CPU) == ["alice"]
    out = ctx.rescale(ctx.mul(ct, ct, keycache.get_eval_mult_key("alice")))
    np.testing.assert_allclose(ctx.decrypt(sk, out).real, z * z, atol=1e-2)
    rotated = ctx.rotate(ct, 1, keycache.get_eval_automorphism_key("alice"))
    np.testing.assert_allclose(ctx.decrypt(sk, rotated).real, np.roll(z, -1), atol=1e-3)
    keycache.clear_eval_mult_keys()
    keycache.clear_eval_automorphism_keys()
