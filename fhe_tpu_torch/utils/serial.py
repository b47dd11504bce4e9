"""Serialization: a deterministic binary (npz) or JSON container for the
port's keys and ciphertexts, on fhe_tpu's wire format.

Port of fhe_tpu/utils/serial.py (reference: the cereal layer,
utils/serial.h:69-71, JSON and portable-binary archives).  An object
flattens to {path: numpy array} plus a JSON-able spec; the container is one
`np.savez` zip or one JSON document with base64 arrays, with a format
version and a type tag per object.

One wire format for both packages: a port class that has an fhe_tpu
counterpart with the same fields is written under the counterpart's tag
(`fhe_tpu.tfhe.lwe.LweCiphertext`, ...), its residue words in the
counterpart's unsigned type (the port holds them as int32 / int64, fhe_tpu
as uint32 / uint64; the bits are the same).  So the archive of an LWE
ciphertext, an LWE secret key, a CKKS ciphertext or an fhEVM EncryptedInt
is byte-identical to fhe_tpu's for the same values, and either package
reads the other's.  A port class with no such counterpart is written under
its own name.

Reading maps every tag through the explicit table below (plus the classes a
caller registers with `register`); writing a class registers nothing.  It
never imports a module named in an archive, and reads dict keys with
`ast.literal_eval`.  A tag it does not know raises UnknownTypeError.  Arrays load as tensors on
the device the caller names (the first CUDA card by default), unsigned
words as the signed type of their width.
"""

from __future__ import annotations

import ast
import base64
import dataclasses
import enum
import functools
import importlib
import io
import json
from typing import Any

import numpy as np
import torch

FORMAT_VERSION = 1

# (port module, class, fields fhe_tpu holds unsigned) of each port class
# written under its fhe_tpu counterpart's tag (same module path and name,
# same fields); tests/test_torch_serial.py holds each row to fhe_tpu's class
COUNTERPARTS = (
    ("tfhe.params", "Method", ()),
    ("tfhe.params", "KeyDist", ()),
    ("tfhe.params", "Gate", ()),
    ("tfhe.params", "RawParams", ()),
    ("tfhe.params", "TfheParams", ()),
    ("tfhe.lwe", "LweCiphertext", ("a", "b")),
    ("tfhe.lwe", "LweSecretKey", ()),
    ("tfhe.lwe", "LweSwitchingKey", ("a", "b")),
    ("tfhe.lwe", "LwePublicKey", ("A", "v")),
    ("tfhe.acc", "DmKey", ("bsk",)),
    ("tfhe.acc", "LmkcdeyKey", ("rgsw", "auto")),
    ("tfhe.shortint", "ShortIntParams", ()),
    ("tfhe.radix", "RadixParams", ()),
    ("tfhe.radix", "RadixInt", ()),
    ("tfhe.fhevm", "FheType", ()),
    ("tfhe.fhevm", "EncryptedInt", ()),
    ("tfhe.threshold", "ThresholdConfig", ()),
    ("tfhe.threshold", "KeyShare", ("share",)),
    ("tfhe.threshold", "VerificationKey", ()),
    ("lattice.rns", "RnsPoly", ("data",)),
    ("pke.rlwe", "SecretKey", ("s_eval_full",)),
    ("pke.rlwe", "PublicKey", ()),
    ("pke.rlwe", "EvalKey", ("b", "a")),
    ("pke.rlwe", "BvEvalKey", ("b", "a")),
    ("pke.ckks", "Ciphertext", ()),
    ("pke.bfv", "Ciphertext", ()),
    ("pke.bgv", "Ciphertext", ()),
)
# port classes whose fhe_tpu namesake has other fields (BootstrapKey: no
# Shoup duals; PreparedEvalKey: int64 words, not Montgomery) or none
OWN = (
    ("tfhe.rgsw", "BootstrapKey"),
    ("tfhe.rgsw_rns", "RnsKey"),
    ("pke.rlwe", "PreparedEvalKey"),
)

_PKG = __name__.rsplit(".", 2)[0]          # fhe_tpu_torch
_WIRE_PKG = "fhe_tpu"

_UNSIGNED = {np.dtype(np.int32): np.dtype(np.uint32), np.dtype(np.int64): np.dtype(np.uint64)}
_SIGNED = {v: k for k, v in _UNSIGNED.items()}

# classes registered by callers: tag -> class
_REGISTRY: dict[str, type] = {}


class UnknownTypeError(TypeError):
    """An archive names a type this package has no class for."""


@functools.lru_cache(maxsize=None)
def _table() -> tuple[dict, dict, dict]:
    """(tag -> port class, port class -> tag, port class -> unsigned fields)."""
    by_tag, tag_of, unsigned = {}, {}, {}
    for mod, name, fields in COUNTERPARTS:
        cls = getattr(importlib.import_module(f"{_PKG}.{mod}"), name)
        tag = f"{_WIRE_PKG}.{mod}.{name}"
        by_tag[tag], tag_of[cls], unsigned[cls] = cls, tag, frozenset(fields)
    for mod, name in OWN:
        cls = getattr(importlib.import_module(f"{_PKG}.{mod}"), name)
        tag = f"{cls.__module__}.{cls.__qualname__}"
        by_tag[tag], tag_of[cls] = cls, tag
    return by_tag, tag_of, unsigned


def register(cls):
    """Register a dataclass or enum for reading (tag = its qualified name)."""
    _REGISTRY[f"{cls.__module__}.{cls.__qualname__}"] = cls
    return cls


def _type_tag(cls) -> str:
    return _table()[1].get(cls) or f"{cls.__module__}.{cls.__qualname__}"


def _lookup(tag: str):
    cls = _table()[0].get(tag) or _REGISTRY.get(tag)
    if cls is None:
        raise UnknownTypeError(f"no {_PKG} class for the archived type {tag!r}")
    return cls


def _host_array(x, unsigned: bool) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    a = np.ascontiguousarray(x)
    return a.view(_UNSIGNED[a.dtype]) if unsigned and a.dtype in _UNSIGNED else a


def _flatten(obj, path: str, arrays: dict, spec: dict, unsigned: bool = False):
    if obj is None:
        spec[path] = {"kind": "none"}
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        arrays[path] = _host_array(obj, unsigned)
        spec[path] = {"kind": "array"}
    elif isinstance(obj, (int, float, str, bool)):
        spec[path] = {"kind": "scalar", "value": obj}
    elif isinstance(obj, bytes):
        spec[path] = {"kind": "bytes"}
        arrays[path] = np.frombuffer(obj, dtype=np.uint8)
    elif isinstance(obj, enum.Enum):
        spec[path] = {"kind": "enum", "type": _type_tag(type(obj)), "name": obj.name}
    elif isinstance(obj, (tuple, list)):
        spec[path] = {"kind": "tuple" if isinstance(obj, tuple) else "list", "items": len(obj)}
        for i, v in enumerate(obj):
            _flatten(v, f"{path}.{i}", arrays, spec)
    elif isinstance(obj, dict):
        keys = sorted(obj.keys(), key=str)
        spec[path] = {"kind": "dict", "keys": [repr(k) for k in keys]}
        for i, k in enumerate(keys):
            _flatten(obj[k], f"{path}.{i}", arrays, spec)
    elif dataclasses.is_dataclass(obj):
        cls = type(obj)
        fields = [f.name for f in dataclasses.fields(obj)]
        spec[path] = {"kind": "object", "type": _type_tag(cls), "fields": fields}
        words = _table()[2].get(cls, frozenset())
        for f in fields:
            _flatten(getattr(obj, f), f"{path}.{f}", arrays, spec, f in words)
    else:
        raise TypeError(f"cannot serialize {type(obj)} at {path}")


def _unflatten(path: str, arrays: dict, spec: dict, device):
    ent = spec[path]
    kind = ent["kind"]
    if kind == "none":
        return None
    if kind == "array":
        a = arrays[path]
        a = np.array(a.view(_SIGNED.get(a.dtype, a.dtype)))
        return torch.from_numpy(a).to(device)
    if kind == "scalar":
        return ent["value"]
    if kind == "bytes":
        return arrays[path].tobytes()
    if kind == "enum":
        return _lookup(ent["type"])[ent["name"]]
    if kind in ("tuple", "list"):
        items = [_unflatten(f"{path}.{i}", arrays, spec, device) for i in range(ent["items"])]
        return tuple(items) if kind == "tuple" else items
    if kind == "dict":
        return {ast.literal_eval(kr): _unflatten(f"{path}.{i}", arrays, spec, device)
                for i, kr in enumerate(ent["keys"])}
    if kind == "object":
        cls = _lookup(ent["type"])
        return cls(**{f: _unflatten(f"{path}.{f}", arrays, spec, device)
                      for f in ent["fields"]})
    raise ValueError(f"bad spec kind {kind}")


def dumps(obj, mode: str = "binary") -> bytes:
    """Serialize to bytes: mode='binary' (npz container, compact) or
    'json' (text archive with base64 arrays).  Tensors are copied to the
    host first."""
    arrays: dict[str, np.ndarray] = {}
    spec: dict[str, Any] = {}
    _flatten(obj, "r", arrays, spec)
    header = {"version": FORMAT_VERSION, "spec": spec}
    if mode == "json":
        payload = {k: {"dtype": str(v.dtype), "shape": list(v.shape),
                       "data": base64.b64encode(v.tobytes()).decode()}
                   for k, v in arrays.items()}
        return json.dumps({"header": header, "arrays": payload}).encode()
    buf = io.BytesIO()
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(buf, **arrays)
    return buf.getvalue()


def loads(data: bytes, mode: str = "binary", device="cuda"):
    """Deserialize what `dumps` (here or in fhe_tpu) wrote; arrays become
    tensors on `device`."""
    if mode == "json":
        doc = json.loads(data.decode())
        header = doc["header"]
        arrays = {k: np.frombuffer(base64.b64decode(v["data"]),
                                   dtype=np.dtype(v["dtype"])).reshape(v["shape"])
                  for k, v in doc["arrays"].items()}
    else:
        with np.load(io.BytesIO(data)) as z:
            arrays = {k: z[k] for k in z.files}
        header = json.loads(bytes(arrays.pop("__header__")).decode())
    if header["version"] > FORMAT_VERSION:
        raise ValueError(f"format version {header['version']} too new")
    return _unflatten("r", arrays, header["spec"], torch.device(device))


def save(obj, path: str, mode: str = "binary"):
    with open(path, "wb") as f:
        f.write(dumps(obj, mode))


def load(path: str, mode: str = "binary", device="cuda"):
    with open(path, "rb") as f:
        return loads(f.read(), mode, device)
