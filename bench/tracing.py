"""The traced window: ``torch.profiler`` over the window, reduced to the
device's operations and the host's ranges on one clock.

:func:`profiled` runs a block under the profiler with the card's activity
and returns a :class:`Trace`: every device operation (kernels, copies,
sets) as ``(name, start_us, end_us)``, every host range the same way, and
the window's own range (``bench.window``, opened by the block's caller).
Readers take what they need from it: busy time (the union of the device
intervals inside the window), time by kernel name, idle gaps labelled by
what the host was doing.
"""
from __future__ import annotations

import contextlib
import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

Event = Tuple[str, float, float]
WINDOW = "bench.window"
CALL = "bench.call"
OWN = "bench."
SHORT_GAP_US = 20.0


@dataclass
class Trace:
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self) -> List[Event]:
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device
                if e > a and s < b]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations inside the window."""
        out: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.in_window(), key=lambda t: t[1]):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_between(self, a: float, b: float) -> float:
        """Seconds of ``[a, b]`` (µs) inside the window in which the device
        ran an operation."""
        return sum(max(0.0, min(e, b) - max(s, a))
                   for s, e in self.busy_intervals()) / 1e6

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        """The host ranges named ``name``, in time order."""
        return sorted((s, e) for n, s, e in self.host if n == name)

    def seconds_by_name(self, keep: Optional[Callable[[str], bool]] = None
                        ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.in_window():
            if keep is None or keep(n):
                out[n] = out.get(n, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of the window in which the device ran nothing, summed by
        the innermost host range open at each gap's middle; gaps shorter
        than :data:`SHORT_GAP_US` go together."""
        a, b = self.window
        busy = self.busy_intervals()
        gaps, t = [], a
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        # the innermost range open at t is the latest-starting one that
        # has not ended: a heap of the started ranges, latest start on top,
        # dropping those that ended (the gaps come in time order)
        host = sorted(self.host, key=lambda h: h[1])
        started: List[Tuple[float, float, str]] = []
        j = 0
        out: Dict[str, float] = {}
        for s, e in gaps:
            if e - s < SHORT_GAP_US:
                name = f"gaps under {SHORT_GAP_US:g} us"
            else:
                t = (s + e) / 2
                while j < len(host) and host[j][1] <= t:
                    heapq.heappush(started, (-host[j][1], host[j][2],
                                             host[j][0]))
                    j += 1
                while started and started[0][1] < t:
                    heapq.heappop(started)
                name = started[0][2] if started else \
                    "host outside any range"
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out


@contextlib.contextmanager
def profiled(on: bool) -> Iterator[Optional[Trace]]:
    """Profile the block with the card's activity when ``on``; the
    :class:`Trace` is filled when the block exits. Raises where the
    profiler cannot record the card."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("torch.profiler cannot record the card here")
        acts.append(ProfilerActivity.CUDA)
    trace = Trace()
    with profile(activities=acts) as prof:
        yield trace
        if cuda:
            torch.cuda.synchronize()
    # the profiler's raw events: building its FunctionEvent tree for a
    # decode call's hundreds of thousands of operations takes minutes
    cuda_type = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        ev = (e.name(), start, start + e.duration_ns() / 1e3)
        if e.device_type() == cuda_type:
            # the benchmark's own ranges also show on the device's
            # timeline; they are no device work
            if not (e.is_user_annotation() or ev[0].startswith(OWN)):
                trace.device.append(ev)
        else:
            if ev[0] == WINDOW:
                trace.window = (ev[1], ev[2])
            trace.host.append(ev)


def window_range():
    """The range that marks the traced window on the host's timeline."""
    return torch.profiler.record_function(WINDOW)


def call_range(on: bool):
    """A range around one call of the program on the traced timeline."""
    return torch.profiler.record_function(CALL) if on \
        else contextlib.nullcontext()


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took the most time and the ten
    largest sums of idle gaps by host range, as ``[name, seconds]``."""
    ops = sorted(trace.seconds_by_name().items(), key=lambda kv: -kv[1])
    gaps = sorted(trace.idle_gaps().items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:10]],
            "idle_gaps": [[n[:160], s] for n, s in gaps[:10]]}
