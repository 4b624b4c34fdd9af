"""Adapter between :mod:`repro_torch.obs` and ``torch.profiler`` (the
port of :mod:`repro.obs.jaxprof`).

Two directions of the same timeline:

* **obs spans → torch profiler**: while a ``torch.profiler`` collects,
  every obs span enters a ``torch.profiler.record_function`` of its name,
  with or without the obs ring, so the program's structure
  (``tick.place``, ``sweep.chunk``, ``train.optimizer``,
  ``serve.prefill``, ``kernel.qos_matrix``, ...) shows up in the profile
  next to the CUDA kernels it launches.
* **kernel time → obs**: :func:`kernel_span` is the host-side wrapper the
  kernel dispatchers use — an obs span named ``kernel.<x>`` — and
  :func:`named_scope` tags the CUDA or the plain branch of a dispatcher
  (``qos_matrix_cuda``, ``greedy_argmax_ref``, ...) on the profiler's
  timeline, so a kernel's device time is attributable to its dispatcher.
  Both follow the profiler: with none collecting they cost one flag read.
  A ``record_function`` range also shows on the device timeline, as a
  user annotation: a sum of device times skips those events
  (``is_user_annotation``).

:func:`profile_trace` runs a block under ``torch.profiler.profile`` and
writes a Chrome trace (``chrome://tracing`` / https://ui.perfetto.dev).
On a machine with CUDA it always records the CUDA activity too, and
raises rather than profile without it. :func:`kernel_launches` reads such
a trace back: one kernel's device launches, their device times, and how
many of them a named range (a dispatcher's scope, a ``kernel.*`` span)
launched; :func:`scope_device_ms` the device time of every operation a
named range launched.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Tuple, Union

from .trace import _NULL_SPAN, _profiler, kernel_span

__all__ = ["kernel_span", "named_scope", "profile_trace",
           "have_torch_profiler", "kernel_launches", "scope_device_ms"]

#: Chrome-trace categories of the host calls that launch a device kernel
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: Chrome-trace categories of the device's operations
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def have_torch_profiler() -> bool:
    try:
        import torch.profiler  # noqa: F401
        return True
    except Exception:  # pragma: no cover - torch without its profiler
        return False


def named_scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler collects, else the shared no-op span (one flag read: the
    dispatchers open one per call, hundreds a tick)."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL_SPAN


@contextlib.contextmanager
def profile_trace(log_dir) -> Iterator[str]:
    """Run the body under ``torch.profiler.profile`` and write its Chrome
    trace to ``<log_dir>/trace_<pid>.json``; yields that path (the file
    exists once the block has exited).

    It records the CUDA activity whenever a CUDA device is there, and a
    profiler that cannot record it raises instead of quietly profiling
    the CPU alone. The program's spans and the dispatchers' scopes are in
    the dump whether or not the obs ring is on::

        with profile_trace("/tmp/torchprof") as path:
            run_sweep(spec)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities

    want_cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if want_cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity here; refusing "
                "to profile the CPU alone on a CUDA machine")
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}.json"
    with profile(activities=activities) as prof:
        yield str(path)
        if want_cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def _x_events(trace) -> list:
    """The complete (``X``) events of a Chrome trace or its path."""
    doc = trace if isinstance(trace, Mapping) else \
        json.loads(Path(trace).read_text())
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def _ranges(events: list, scope: str) -> List[Tuple[float, float]]:
    """The host ``record_function`` ranges named ``scope``, in time
    order."""
    return sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == scope)


def _launched_at(events: list) -> Dict[Any, float]:
    """Host time of each launch call, by its correlation id."""
    return {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("cat") in _LAUNCH_CATS
            and "correlation" in e.get("args", {})}


def kernel_launches(trace: Union[str, os.PathLike, Mapping[str, Any]],
                    kernel: str, scope: str) -> Dict[str, Any]:
    """One kernel's device launches in a Chrome trace written by
    :func:`profile_trace`: ``{"launches": n, "device_ms": [ms each, in
    device start order], "queued_ms": [device start − host launch call,
    each], "in_scope": m}``, counting the device events whose name holds
    ``kernel``, and ``m`` of them launched (their host launch call, found
    by its correlation id) inside a ``record_function`` range named
    ``scope``."""
    events = _x_events(trace)
    ranges = _ranges(events, scope)
    launched_at = _launched_at(events)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and kernel in e.get("name", "")),
                     key=lambda e: e["ts"])
    device_ms, queued_ms, inside = [], [], 0
    for e in kernels:
        device_ms.append(e.get("dur", 0) / 1e3)
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        queued_ms.append((e["ts"] - t) / 1e3)
        if any(a <= t <= b for a, b in ranges):
            inside += 1
    return {"launches": len(device_ms), "device_ms": device_ms,
            "queued_ms": queued_ms, "in_scope": inside}


def scope_device_ms(trace: Union[str, os.PathLike, Mapping[str, Any]],
                    scope: str) -> Dict[str, Any]:
    """The device operations (kernels, copies, sets) that each
    ``record_function`` range named ``scope`` launched, in a Chrome trace
    written by :func:`profile_trace`, each operation's host launch call
    found by its correlation id as :func:`kernel_launches` finds it:
    ``{"ranges": [(start_us, end_us) of each range, in time order],
    "device_ms": [ms summed over each range's operations], "ops":
    [operations of each range], "unpaired": k}``, ``k`` the device
    operations without a launch call in the trace."""
    events = _x_events(trace)
    ranges = _ranges(events, scope)
    starts = [a for a, _ in ranges]
    launched_at = _launched_at(events)
    device_ms, ops, unpaired = [0.0] * len(ranges), [0] * len(ranges), 0
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if t is None:
            unpaired += 1
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            device_ms[i] += e.get("dur", 0) / 1e3
            ops[i] += 1
    return {"ranges": ranges, "device_ms": device_ms, "ops": ops,
            "unpaired": unpaired}
