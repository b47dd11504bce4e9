"""Per-keyTag evaluation-key caches with serialization.

Port of fhe_tpu/pke/keycache.py (reference semantics: CryptoContextImpl's
static key caches, cryptocontext.h:643-800: InsertEvalMultKey /
GetAllEvalMultKeys / ClearEvalMultKeys + Serialize/DeserializeEvalMultKey,
and the same family for automorphism (rotation) keys, with EvalSumKey
routed onto the automorphism cache, cryptocontext.h:741-768).

Contexts are functional (keys are explicit arguments), so the cache is an
OPT-IN process-wide registry for the serialization workflow: a service
loads keys once per tag (e.g. per client) and fetches them by tag for each
request, as the reference's server deployments use the statics.  Nothing
in the compute path reads it implicitly.  Archives are utils/serial's, on
fhe_tpu's wire format; a deserialized key lands on the device the caller
names (the first CUDA card by default).
"""

from __future__ import annotations

import threading

from ..utils import serial

_lock = threading.Lock()
_mult_keys: dict[str, object] = {}
_auto_keys: dict[str, dict] = {}


# -- EvalMult (relinearization) keys ------------------------------------------

def insert_eval_mult_key(evk, key_tag: str = "") -> None:
    """InsertEvalMultKey (cryptocontext.h:730)."""
    with _lock:
        _mult_keys[key_tag] = evk


def get_eval_mult_key(key_tag: str = ""):
    """GetEvalMultKeyVector analogue; KeyError if absent."""
    with _lock:
        return _mult_keys[key_tag]


def get_all_eval_mult_keys() -> dict:
    with _lock:
        return dict(_mult_keys)


def clear_eval_mult_keys(key_tag: str | None = None) -> None:
    """ClearEvalMultKeys (:709-715): one tag, or the whole cache."""
    with _lock:
        if key_tag is None:
            _mult_keys.clear()
        else:
            _mult_keys.pop(key_tag, None)


def serialize_eval_mult_key(key_tag: str | None = None,
                            mode: str = "binary") -> bytes:
    """SerializeEvalMultKey (:643): one tag or the full cache."""
    with _lock:
        data = (dict(_mult_keys) if key_tag is None
                else {key_tag: _mult_keys[key_tag]})
    return serial.dumps(data, mode=mode)


def deserialize_eval_mult_key(blob: bytes, mode: str = "binary", device="cuda") -> list:
    """DeserializeEvalMultKey (:693): merge into the cache, return tags."""
    data = serial.loads(blob, mode=mode, device=device)
    with _lock:
        _mult_keys.update(data)
    return sorted(data)


# -- EvalAutomorphism (rotation) keys -----------------------------------------

def insert_eval_automorphism_key(rot_keys: dict, key_tag: str = "") -> None:
    """InsertEvalAutomorphismKey: {rotation index -> EvalKey}."""
    with _lock:
        _auto_keys.setdefault(key_tag, {}).update(rot_keys)


def get_eval_automorphism_key(key_tag: str = "") -> dict:
    with _lock:
        return dict(_auto_keys[key_tag])


def get_existing_eval_automorphism_key_indices(key_tag: str = "") -> list:
    """GetExistingEvalAutomorphismKeyIndices (cryptocontext.h:242)."""
    with _lock:
        return sorted(_auto_keys.get(key_tag, {}))


def clear_eval_automorphism_keys(key_tag: str | None = None) -> None:
    with _lock:
        if key_tag is None:
            _auto_keys.clear()
        else:
            _auto_keys.pop(key_tag, None)


def serialize_eval_automorphism_key(key_tag: str | None = None,
                                    mode: str = "binary") -> bytes:
    with _lock:
        data = ({t: dict(v) for t, v in _auto_keys.items()}
                if key_tag is None else {key_tag: dict(_auto_keys[key_tag])})
    # dict keys must be strings for the archive; indices may be negative
    flat = {t: {str(i): k for i, k in v.items()} for t, v in data.items()}
    return serial.dumps(flat, mode=mode)


def deserialize_eval_automorphism_key(blob: bytes, mode: str = "binary",
                                      device="cuda") -> list:
    flat = serial.loads(blob, mode=mode, device=device)
    with _lock:
        for t, v in flat.items():
            _auto_keys.setdefault(t, {}).update(
                {int(i): k for i, k in v.items()})
    return sorted(flat)


# -- EvalSum keys route onto the automorphism cache (cryptocontext.h:741) ----

insert_eval_sum_key = insert_eval_automorphism_key
get_eval_sum_key = get_eval_automorphism_key
clear_eval_sum_keys = clear_eval_automorphism_keys
serialize_eval_sum_key = serialize_eval_automorphism_key
deserialize_eval_sum_key = deserialize_eval_automorphism_key
