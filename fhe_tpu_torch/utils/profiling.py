"""Tracing / profiling utilities.

Port of fhe_tpu/utils/profiling.py (reference semantics: utils/debug.h,
TIC/TOC wall-clock macros :123-148, PROFILELOG stream logging, and the
per-stage bootstrap timing prints, ckksrns-fhe.cpp:683-684).

* tic()/toc() -- wall-clock pairs; toc() first synchronises the CUDA device
  of every tensor it is given (found inside tuples, lists, dicts and
  dataclasses too), so a toc() after a call measures the work, not its
  asynchronous launch.
* stage() context manager / @profiled decorator -- the PROFILELOG
  analogue; records into a process-wide registry that report() dumps.
  stage(name, device=d) on a CUDA device times the block's work on the
  device with CUDA events recorded on d's current stream (the device
  time, in seconds); without a CUDA device it takes the host clock.
  @profiled synchronises the devices of the result's tensors, so the
  callee's kernels are charged to its stage.
* trace(logdir) -- wraps torch.profiler (host and CUDA activity) and
  writes a Chrome trace into logdir.
* enable(False) -- the master switch: stages and decorators record
  nothing (the reference's NDEBUG/PROFILE compile flags, at run time).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from collections import defaultdict

import torch

_REGISTRY: dict[str, list[float]] = defaultdict(list)
_ENABLED = True


def enable(on: bool = True) -> None:
    """Master switch (the reference's NDEBUG/PROFILE compile flags,
    flipped at runtime)."""
    global _ENABLED
    _ENABLED = on


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in obj (nested containers and
    dataclasses included)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), out)
    return out


def synchronize(*values) -> None:
    """Wait for the work of every CUDA device that holds one of values'
    tensors (the block_until_ready of the port)."""
    for dev in _cuda_devices(values, set()):
        torch.cuda.synchronize(dev)


def tic() -> float:
    return time.perf_counter()


def toc(t0: float, *block_on) -> float:
    """Elapsed seconds since t0; synchronises the devices of any given
    tensors first (TOC with device-synchronous semantics)."""
    synchronize(*block_on)
    return time.perf_counter() - t0


@contextlib.contextmanager
def stage(name: str, *, log: bool = False, device=None):
    """PROFILELOG analogue: time a named stage into the registry.

        with profiling.stage("CoeffsToSlots", device=ct.c0.data.device):
            enc = ...

    On a CUDA device the time is the device's, from CUDA events around the
    block (the exit waits for the end event); else the host clock's."""
    dev = torch.device(device) if device is not None else None
    events = None
    if _ENABLED and dev is not None and dev.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _ENABLED:
            if events is None:
                dt = time.perf_counter() - t0
            else:
                events[1].record(torch.cuda.current_stream(dev))
                events[1].synchronize()
                dt = events[0].elapsed_time(events[1]) * 1e-3
            _REGISTRY[name].append(dt)
            if log:
                print(f"[profile] {name}: {dt * 1e3:.3f} ms")


def profiled(fn=None, *, name: str | None = None):
    """Decorator form of stage(); synchronises the devices of the result's
    tensors so the callee's kernels are charged to the right stage."""
    if fn is None:
        return functools.partial(profiled, name=name)
    label = name or fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _ENABLED:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        _REGISTRY[label].append(time.perf_counter() - t0)
        return out

    return wrapper


def report(reset: bool = False) -> dict[str, dict[str, float]]:
    """Summary stats per stage: {name: {calls, total_s, mean_ms, min_ms}}."""
    out = {}
    for name, ts in _REGISTRY.items():
        out[name] = {
            "calls": len(ts),
            "total_s": sum(ts),
            "mean_ms": 1e3 * sum(ts) / len(ts),
            "min_ms": 1e3 * min(ts),
        }
    if reset:
        _REGISTRY.clear()
    return out


def reset() -> None:
    _REGISTRY.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Timeline capture with torch.profiler (host and, where there is a
    card, CUDA activity); writes logdir/trace.json (Chrome trace format)
    and yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
