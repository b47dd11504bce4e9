"""HTTP FHE service: context/key registries + REST endpoints.

Port of fhe_tpu/server.py (reference semantics: server/fhe_controller.h:
23-80, a singleton FHEManager with mutex-guarded context and key
registries, endpoints for create-context / keygen / encrypt / decrypt /
gate evaluation; server/main.cc, smoke test server/test.sh).

Implemented on the standard library's ThreadingHTTPServer (no external
web framework; the reference uses Drogon), with fhe_tpu's routes and the
reference controller's /v1 aliases.  Ciphertexts travel as base64 of
utils/serial's binary archives, on fhe_tpu's wire format, so a client of
either server reads the other's ciphertexts.  Each server owns its
manager, whose contexts live on the device `serve` / `make_server` name,
the first CUDA card by default; each operation's time goes into utils/profiling's registry as
the stage "server.<op>" (the device's time, from CUDA events, on a card).

    python3 -m fhe_tpu_torch.server [port]
"""

from __future__ import annotations

import base64
import json
import sys
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .tfhe import BinFheContext, Gate
from .utils import profiling, serial

VERSION = "1.0.0"


class FheManager:
    """fhe_controller.h FHEManager: registries guarded by a lock."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._contexts: dict[str, BinFheContext] = {}
        self._keys: dict[str, dict] = {}      # key_id -> {sk, bt, ctx_id}

    # -- operations -----------------------------------------------------------
    def create_context(self, param_set: str, method: str = "GINX") -> str:
        ctx = BinFheContext.generate(param_set, method, device=self.device)
        cid = uuid.uuid4().hex[:16]
        with self._lock:
            self._contexts[cid] = ctx
        return cid

    def keygen(self, ctx_id: str, seed: int | None = None) -> str:
        ctx = self._get_ctx(ctx_id)
        rng = np.random.default_rng(seed)
        sk = ctx.key_gen(rng)
        bt = ctx.bt_key_gen(sk, rng)
        kid = uuid.uuid4().hex[:16]
        with self._lock:
            self._keys[kid] = {"sk": sk, "bt": bt, "ctx": ctx_id}
        return kid

    def _get_ctx(self, cid: str) -> BinFheContext:
        with self._lock:
            if cid not in self._contexts:
                raise KeyError(f"unknown context {cid}")
            return self._contexts[cid]

    def _get_key(self, kid: str) -> dict:
        with self._lock:
            if kid not in self._keys:
                raise KeyError(f"unknown key {kid}")
            return self._keys[kid]

    @staticmethod
    def _load(ctx: BinFheContext, b64: str):
        return serial.loads(base64.b64decode(b64), device=ctx.device)

    @staticmethod
    def _dump(ct) -> str:
        return base64.b64encode(serial.dumps(ct)).decode()

    def encrypt(self, ctx_id: str, key_id: str, bits: list[int],
                seed: int | None = None) -> str:
        ctx = self._get_ctx(ctx_id)
        key = self._get_key(key_id)
        rng = np.random.default_rng(seed)
        with profiling.stage("server.encrypt", device=ctx.device):
            ct = ctx.encrypt(key["sk"], np.asarray(bits, dtype=np.int64), rng)
        return self._dump(ct)

    def decrypt(self, ctx_id: str, key_id: str, ct_b64: str) -> list[int]:
        ctx = self._get_ctx(ctx_id)
        key = self._get_key(key_id)
        ct = self._load(ctx, ct_b64)
        with profiling.stage("server.decrypt", device=ctx.device):
            bits = ctx.decrypt(key["sk"], ct, p=4)
        return [int(x) for x in bits.cpu().numpy()]

    def gate(self, ctx_id: str, key_id: str, gate: str, ct1_b64: str,
             ct2_b64: str) -> str:
        ctx = self._get_ctx(ctx_id)
        key = self._get_key(key_id)
        ct1, ct2 = self._load(ctx, ct1_b64), self._load(ctx, ct2_b64)
        with profiling.stage("server.gate", device=ctx.device):
            out = ctx.eval_bin_gate(key["bt"], Gate[gate], ct1, ct2)
        return self._dump(out)

    def not_(self, ctx_id: str, ct_b64: str) -> str:
        ctx = self._get_ctx(ctx_id)
        ct = self._load(ctx, ct_b64)
        with profiling.stage("server.not", device=ctx.device):
            out = ctx.eval_not(ct)
        return self._dump(out)


class FheHandler(BaseHTTPRequestHandler):
    """Routes mirroring the reference controller's endpoint set, over the
    manager of the server that took the request."""

    def log_message(self, fmt, *args):      # quiet
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # v1 aliases mirror the reference controller's routes verbatim
    # (fhe_controller.h:242-254); /v1/eval/<gate> maps onto /gate.
    _ALIASES = {"/v1/context/create": "/context",
                "/v1/keys/generate": "/keygen",
                "/v1/encrypt": "/encrypt",
                "/v1/decrypt": "/decrypt",
                "/v1/eval/not": "/not"}
    _GATES = {"and": "AND", "or": "OR", "xor": "XOR", "nand": "NAND",
              "nor": "NOR", "xnor": "XNOR"}

    def do_GET(self):
        if self.path == "/health":
            dev = self.server.manager.device
            self._reply(200, {"status": "ok", "version": VERSION,
                              "backend": dev.type, "device": str(dev),
                              "device_name": (torch.cuda.get_device_name(dev)
                                              if dev.type == "cuda" else "cpu"),
                              "devices": torch.cuda.device_count()})
        elif self.path == "/v1/stats":
            mgr = self.server.manager
            with mgr._lock:
                self._reply(200, {"contexts": len(mgr._contexts),
                                  "keys": len(mgr._keys),
                                  "version": VERSION})
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            mgr = self.server.manager
            path = self._ALIASES.get(self.path, self.path)
            if path.startswith("/v1/eval/"):
                g = self._GATES.get(path.rsplit("/", 1)[-1])
                if g is None:
                    self._reply(404, {"error": "unknown gate"})
                    return
                req.setdefault("gate", g)
                path = "/gate"
            self.path = path
            if self.path == "/context":
                cid = mgr.create_context(req.get("param_set", "STD128"),
                                         req.get("method", "GINX"))
                self._reply(200, {"context_id": cid})
            elif self.path == "/keygen":
                kid = mgr.keygen(req["context_id"], req.get("seed"))
                self._reply(200, {"key_id": kid})
            elif self.path == "/encrypt":
                ct = mgr.encrypt(req["context_id"], req["key_id"],
                                 req["bits"], req.get("seed"))
                self._reply(200, {"ciphertext": ct})
            elif self.path == "/decrypt":
                bits = mgr.decrypt(req["context_id"], req["key_id"],
                                   req["ciphertext"])
                self._reply(200, {"bits": bits})
            elif self.path == "/gate":
                out = mgr.gate(req["context_id"], req["key_id"],
                               req["gate"], req["ct1"], req["ct2"])
                self._reply(200, {"ciphertext": out})
            elif self.path == "/not":
                out = mgr.not_(req["context_id"], req["ciphertext"])
                self._reply(200, {"ciphertext": out})
            else:
                self._reply(404, {"error": "not found"})
        except KeyError as e:
            self._reply(400, {"error": f"missing/unknown: {e}"})
        except Exception as e:              # noqa: BLE001
            self._reply(500, {"error": str(e)})


def make_server(port: int = 8080, device="cuda") -> ThreadingHTTPServer:
    """The service bound to 127.0.0.1:port (0: an ephemeral port, read it
    from `server_address`), with a manager of its own whose contexts live
    on `device`."""
    httpd = ThreadingHTTPServer(("127.0.0.1", port), FheHandler)
    httpd.manager = FheManager(device)
    return httpd


def serve(port: int = 8080, device="cuda"):
    srv = make_server(port, device)
    print(f"fhe_tpu_torch server on 127.0.0.1:{srv.server_address[1]} ({device})")
    srv.serve_forever()


def main():
    """Console entry point (`fhe-tpu-torch-server [port]`)."""
    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 8080)


if __name__ == "__main__":
    main()
