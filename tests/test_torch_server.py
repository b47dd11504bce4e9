"""fhe_tpu_torch/server.py over HTTP against fhe_tpu's FheManager on the
CPU.

The port's server runs in a thread on 127.0.0.1, port 0 (an ephemeral
port, so that test workers cannot collide), its contexts on the CPU.  At
TOY, from the same seeds, its base64 ciphertexts for encrypt, every gate
and NOT are the very strings fhe_tpu's FheManager returns (called
directly).  As in test_torch_capi.py, fhe_tpu's BSK assembly runs jitted
and its mod switch Q -> Q (TOY's q_ks == Q) is the identity, as the
port's is (fhe_tpu's is off by a few units there: ROADMAP.md queue 3).
"""

import base64
import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fhe_tpu import server as jserver
from fhe_tpu.tfhe import lwe as jlwe
from fhe_tpu.tfhe import rgsw as j_rgsw
from fhe_tpu_torch import server
from fhe_tpu_torch.utils import profiling, serial

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

BITS1, BITS2 = [0, 0, 1, 1], [0, 1, 0, 1]
TRUTH = {"AND": lambda a, b: a & b, "OR": lambda a, b: a | b, "XOR": lambda a, b: a ^ b,
         "NAND": lambda a, b: 1 - (a & b), "NOR": lambda a, b: 1 - (a | b),
         "XNOR": lambda a, b: 1 - (a ^ b)}


@pytest.fixture(scope="module")
def srv():
    httpd = server.make_server(0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def jmgr():
    """fhe_tpu's manager, its BSK assembly jitted and its mod switch the
    identity when the moduli agree."""
    bsk_device, mod_switch = j_rgsw._bsk_device, jlwe.mod_switch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rgsw, "_bsk_device", lambda plan, params, *x: jax.jit(
            functools.partial(bsk_device, plan, params))(*x))
        mp.setattr(jlwe, "mod_switch",
                   lambda ct, q_to: ct if ct.modulus == q_to else mod_switch(ct, q_to))
        # fhe_tpu's gate pipeline is jitted once a process: trace it anew
        # with the patch, and without it for the tests after this module
        jax.clear_caches()
        yield jserver.FheManager()
    jax.clear_caches()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def keyed(srv, jmgr):
    """TOY contexts and keys (seed 7), and two encryptions (seeds 1, 2),
    in both packages."""
    cid = _post(srv, "/context", {"param_set": "TOY"})[1]["context_id"]
    kid = _post(srv, "/keygen", {"context_id": cid, "seed": 7})[1]["key_id"]
    jcid = jmgr.create_context("TOY")
    jkid = jmgr.keygen(jcid, 7)
    cts = [_post(srv, "/encrypt", {"context_id": cid, "key_id": kid, "bits": bits,
                                   "seed": seed})[1]["ciphertext"]
           for bits, seed in ((BITS1, 1), (BITS2, 2))]
    jcts = [jmgr.encrypt(jcid, jkid, bits, seed) for bits, seed in ((BITS1, 1), (BITS2, 2))]
    return cid, kid, cts, jcid, jkid, jcts


def test_health_reports_the_torch_device(srv):
    h = _get(srv, "/health")
    assert h["status"] == "ok" and h["version"] == server.VERSION
    assert (h["backend"], h["device"], h["device_name"]) == ("cpu", "cpu", "cpu")
    assert h["devices"] == torch.cuda.device_count()


def test_encrypt_matches_fhe_tpu(keyed):
    _, _, cts, _, _, jcts = keyed
    assert cts == jcts
    ct = serial.loads(base64.b64decode(cts[0]), device="cpu")
    assert ct.a.shape == (4, 64) and ct.modulus == 512


@pytest.mark.parametrize("gate", sorted(TRUTH))
def test_gate_matches_fhe_tpu(srv, jmgr, keyed, gate):
    cid, kid, cts, jcid, jkid, jcts = keyed
    code, g = _post(srv, "/gate", {"context_id": cid, "key_id": kid, "gate": gate,
                                   "ct1": cts[0], "ct2": cts[1]})
    assert code == 200
    assert g["ciphertext"] == jmgr.gate(jcid, jkid, gate, jcts[0], jcts[1])
    _, d = _post(srv, "/decrypt", {"context_id": cid, "key_id": kid,
                                   "ciphertext": g["ciphertext"]})
    assert d["bits"] == [TRUTH[gate](a, b) for a, b in zip(BITS1, BITS2)]


def test_not_matches_fhe_tpu(srv, jmgr, keyed):
    cid, kid, cts, jcid, jkid, jcts = keyed
    _, nt = _post(srv, "/not", {"context_id": cid, "ciphertext": cts[0]})
    assert nt["ciphertext"] == jmgr.not_(jcid, jcts[0])
    _, d = _post(srv, "/decrypt", {"context_id": cid, "key_id": kid,
                                   "ciphertext": nt["ciphertext"]})
    assert d["bits"] == [1 - b for b in BITS1]


def test_fhe_tpu_ciphertexts_decrypt_here(srv, keyed):
    """fhe_tpu's archives are the port's wire format."""
    cid, kid, _, _, _, jcts = keyed
    _, d = _post(srv, "/decrypt", {"context_id": cid, "key_id": kid, "ciphertext": jcts[1]})
    assert d["bits"] == BITS2


def test_operations_are_timed(srv, keyed):
    cid, kid, cts, *_ = keyed
    profiling.reset()
    _post(srv, "/v1/eval/and", {"context_id": cid, "key_id": kid, "ct1": cts[0], "ct2": cts[1]})
    rep = profiling.report(reset=True)
    assert rep["server.gate"]["calls"] == 1 and rep["server.gate"]["total_s"] > 0


def test_error_paths(srv):
    code, r = _post(srv, "/keygen", {"context_id": "nope"})
    assert code == 400 and "error" in r
    assert _post(srv, "/nosuch", {})[0] == 404
    code, r = _post(srv, "/context", {"param_set": "NOT_A_SET"})
    assert code in (400, 500) and "error" in r
    assert _post(srv, "/v1/eval/bogus", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError):
        _get(srv, "/nosuch")


def test_v1_route_aliases(srv):
    """The reference controller's verbatim /v1/* routes map onto the flat
    endpoints (unseeded keys and encryptions)."""
    cid = _post(srv, "/v1/context/create", {"param_set": "TOY"})[1]["context_id"]
    kid = _post(srv, "/v1/keys/generate", {"context_id": cid})[1]["key_id"]
    c1 = _post(srv, "/v1/encrypt", {"context_id": cid, "key_id": kid, "bits": [1, 0]})[1]
    c2 = _post(srv, "/v1/encrypt", {"context_id": cid, "key_id": kid, "bits": [1, 1]})[1]
    code, r = _post(srv, "/v1/eval/nand", {"context_id": cid, "key_id": kid,
                                           "ct1": c1["ciphertext"], "ct2": c2["ciphertext"]})
    assert code == 200
    _, n = _post(srv, "/v1/eval/not", {"context_id": cid, "ciphertext": r["ciphertext"]})
    _, r = _post(srv, "/v1/decrypt", {"context_id": cid, "key_id": kid,
                                      "ciphertext": n["ciphertext"]})
    assert r["bits"] == [1, 0]
    stats = _get(srv, "/v1/stats")
    assert stats["contexts"] >= 2 and stats["keys"] >= 2 and stats["version"] == server.VERSION


def test_each_server_owns_its_manager(srv):
    """A second server keeps its own registries and device: the first
    one's contexts and its /health are unchanged by it."""
    before = _get(srv, "/v1/stats")["contexts"]
    other = server.make_server(0, device="meta")
    try:
        assert other.manager.device == torch.device("meta")
        assert other.manager._contexts == {}
        h = _get(srv, "/health")
        assert (h["backend"], h["device"]) == ("cpu", "cpu")
        assert _get(srv, "/v1/stats")["contexts"] == before
    finally:
        other.server_close()
