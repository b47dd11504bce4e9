"""fhe_tpu_torch/utils/security.py and profiling.py on the CPU, and the
port's import hygiene: with jax and fhe_tpu blocked from import, every
module of the package, and chip_smoke.py, imports, and the slice's host
path (serialization, the server's manager, the C client) runs."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from fhe_tpu.utils import security as jsecurity
from fhe_tpu_torch.utils import profiling, security

# One pytest-xdist worker a core: torch's intra-op thread pool in each
# worker would oversubscribe the cores and slow the whole suite.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ct_scalar_primitives_match_fhe_tpu(rng):
    vals = [0, 1, 5, 6, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    vals += [int(v) for v in rng.integers(0, 1 << 63, size=8, dtype=np.uint64)]
    for a in vals:
        for b in vals:
            assert security.ct_eq(a, b) == jsecurity.ct_eq(a, b) == int(a == b)
            assert security.ct_lt(a, b) == jsecurity.ct_lt(a, b) == int(a < b)
            for c in (0, 1):
                assert security.ct_select(c, a, b) == jsecurity.ct_select(c, a, b) == \
                    (a if c else b)
    for x, y in ((b"abcd", b"abcd"), (b"abcd", b"abcx"), (b"ab", b"abc"), (b"", b"")):
        assert security.ct_memcmp(x, y) == jsecurity.ct_memcmp(x, y) == int(x != y)


def test_ct_table_lookup(rng):
    t = rng.integers(0, 1 << 60, size=37).astype(np.uint64)
    for i in (0, 5, 36):
        assert security.ct_table_lookup(t, i) == jsecurity.ct_table_lookup(t, i) == int(t[i])


def test_ct_select_vec_tensors_and_arrays(rng):
    a = rng.integers(0, 1 << 40, 16)
    b = rng.integers(0, 1 << 40, 16)
    c = rng.integers(0, 2, 16)
    want = np.where(c == 1, a, b)
    got = security.ct_select_vec(torch.from_numpy(c), torch.from_numpy(a), torch.from_numpy(b))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(security.ct_select_vec(c, a, b),
                                  jsecurity.ct_select_vec(c, a, b))


def test_timing_guard():
    t0 = time.perf_counter_ns()
    with security.TimingGuard(min_ns=20_000_000) as g:
        pass
    assert time.perf_counter_ns() - t0 >= 20_000_000 and g.elapsed_ns >= 20_000_000


def test_tic_toc_and_synchronize_find_nested_tensors():
    @dataclasses.dataclass
    class Box:
        x: torch.Tensor
        rest: tuple

    t0 = profiling.tic()
    box = Box(torch.arange(1024) * 2, ({"k": [torch.ones(3)]},))
    assert profiling.toc(t0, box, torch.zeros(2)) >= 0
    assert profiling._cuda_devices(box, set()) == set()       # CPU tensors: nothing to wait for


def test_stage_registry_and_report():
    profiling.reset()
    for _ in range(2):
        with profiling.stage("unit_stage"):
            time.sleep(0.01)
    with profiling.stage("cpu_stage", device="cpu"):          # the host clock off a card
        time.sleep(0.005)
    rep = profiling.report()
    assert rep["unit_stage"]["calls"] == 2 and rep["unit_stage"]["mean_ms"] >= 10.0
    assert rep["cpu_stage"]["min_ms"] >= 5.0
    assert profiling.report(reset=True) == rep and profiling.report() == {}


def test_profiled_decorator_and_enable_switch():
    profiling.reset()

    @profiling.profiled(name="decorated")
    def f(x):
        return torch.sum(x)

    f(torch.ones(16))
    assert profiling.report()["decorated"]["calls"] == 1
    profiling.enable(False)
    try:
        f(torch.ones(16))
        with profiling.stage("off"):
            pass
        assert profiling.report()["decorated"]["calls"] == 1 and "off" not in profiling.report()
    finally:
        profiling.enable(True)
    profiling.reset()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]


def test_port_imports_neither_jax_nor_fhe_tpu():
    """Every module of fhe_tpu_torch and chip_smoke.py import with jax and
    fhe_tpu blocked; serialization, the server's manager and the C client
    then run on the CPU."""
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, shutil, sys
        sys.modules["jax"] = None
        sys.modules["fhe_tpu"] = None
        import numpy as np
        import torch
        import fhe_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(fhe_tpu_torch.__path__, "fhe_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("fhe_tpu_torch.utils.serial", "fhe_tpu_torch.utils.serial_ref",
                     "fhe_tpu_torch.utils.serial_ref_pke", "fhe_tpu_torch.utils.security",
                     "fhe_tpu_torch.utils.profiling", "fhe_tpu_torch.native",
                     "fhe_tpu_torch.native.client", "fhe_tpu_torch.native.capi",
                     "fhe_tpu_torch.native.capi_impl", "fhe_tpu_torch.pke.keycache",
                     "fhe_tpu_torch.server", "fhe_tpu_torch.cli"):
            assert name in names, name
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from fhe_tpu_torch import server
        from fhe_tpu_torch.utils import serial
        mgr = server.FheManager("cpu")
        cid = mgr.create_context("TOY")
        kid = mgr.keygen(cid, 1)
        c1, c2 = mgr.encrypt(cid, kid, [0, 1, 1], 2), mgr.encrypt(cid, kid, [1, 1, 0], 3)
        assert mgr.decrypt(cid, kid, mgr.gate(cid, kid, "AND", c1, c2)) == [0, 1, 0]
        sk = mgr._keys[kid]["sk"]
        assert torch.equal(serial.loads(serial.dumps(sk, "json"), "json", device="cpu").s, sk.s)
        if shutil.which("g++"):
            from fhe_tpu_torch.native import client
            assert len(client.blake2b(b"abc")) == 32
        assert not [m for m in sys.modules if m.startswith("fhe_tpu.")]
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
