"""``python -m repro_torch.obs dash`` — ANSI terminal dashboard over the
live telemetry stream (the port of :mod:`repro.obs.dash`; the same screen
from the same frames).

Consumes the :mod:`repro_torch.obs.stream` wire protocol (file tails and/or
sockets, any number of streams — e.g. one per fleet worker) and renders
a refreshing text dashboard: per-scenario tick rate, realized QoS,
deadline-miss rate, queue depth and in-flight count from ``tick``
frames; per-worker items/s and pending-task ETA from ``worker`` frames;
sweep chunk throughput from ``chunk`` frames; the most recent sampled
request traces from ``reqtrace`` frames (uid/edge/impl/latency/flags —
feed a uid to ``python -m repro_torch.obs explain``); and the live SLO
pane (:mod:`repro_torch.obs.slo` burn rates) evaluated over the same frames.

Everything is pure functions over accumulated frames
(:class:`DashState` → :func:`render`), so the dashboard is testable
without a terminal and a smoke run can assert a frame rendered.
"""
from __future__ import annotations

import math
import queue
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional

from .slo import DEFAULT_SLOS, SLO, evaluate_slos
from .stream import read_stream

__all__ = ["DashState", "render", "run_dash"]

_CLEAR = "\x1b[H\x1b[2J"


class DashState:
    """Accumulated view of one or more telemetry streams."""

    def __init__(self):
        self.n_frames = 0
        self.sources: Dict[str, Mapping[str, Any]] = {}   # hello payloads
        self.frames: List[Mapping[str, Any]] = []          # for SLO window
        #: (scenario, seed, policy) -> latest tick payload + timing
        self.ticks: Dict[tuple, Dict[str, Any]] = {}
        self.workers: Dict[str, Mapping[str, Any]] = {}
        #: (scenario, seed, policy) -> latest gateway payload (live
        #: control plane: the gateway's per-tick operational frames)
        self.gateways: Dict[tuple, Dict[str, Any]] = {}
        self.chunks = {"n": 0, "items": 0}
        self.counters: Dict[str, float] = {}
        #: most recent sampled request traces (reqtrace frames)
        self.requests: "deque" = deque(maxlen=8)
        self.n_requests = 0
        self.last_t: Optional[float] = None

    def update(self, frame: Mapping[str, Any]) -> None:
        self.n_frames += 1
        self.frames.append(frame)
        if len(self.frames) > 4096:         # bound memory on long runs
            del self.frames[:2048]
        t = float(frame.get("t", 0.0))
        self.last_t = t if self.last_t is None else max(self.last_t, t)
        kind = frame.get("type")
        payload = frame.get("payload", {})
        if kind == "hello":
            self.sources[f"{payload.get('source')}:{payload.get('pid')}"] \
                = payload
        elif kind == "tick":
            key = (payload.get("scenario"), payload.get("seed"),
                   payload.get("policy"))
            cell = self.ticks.setdefault(
                key, {"first_t": t, "n_ticks": 0})
            cell.update(payload)
            cell["n_ticks"] += 1
            cell["last_t"] = t
        elif kind == "gateway":
            key = (payload.get("scenario"), payload.get("seed"),
                   payload.get("policy"))
            cell = self.gateways.setdefault(
                key, {"first_t": t, "n_ticks": 0})
            cell.update(payload)
            cell["n_ticks"] += 1
            cell["last_t"] = t
        elif kind == "worker":
            self.workers[str(payload.get("owner"))] = payload
        elif kind == "chunk":
            self.chunks["n"] += 1
            self.chunks["items"] += int(payload.get("items", 0))
        elif kind == "metrics":
            self.counters.update(payload.get("counters", {}))
        elif kind == "reqtrace":
            self.requests.append(payload)
            self.n_requests += 1

    def tick_rate(self, cell: Mapping[str, Any]) -> float:
        span = cell.get("last_t", 0.0) - cell.get("first_t", 0.0)
        n = cell.get("n_ticks", 0)
        return (n - 1) / span if n > 1 and span > 0 else float("nan")


def _fmt(v, spec: str = ".3f", width: int = 7) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return " " * (width - 3) + "n/a"
    return f"{v:{spec}}".rjust(width)


def render(state: DashState, *, slos: Iterable[SLO] = DEFAULT_SLOS,
           width: int = 100) -> str:
    """One dashboard screen as a plain string (no cursor control)."""
    bar = "=" * min(width, 100)
    when = time.strftime("%H:%M:%S", time.localtime(state.last_t)) \
        if state.last_t else "--:--:--"
    out = [bar,
           f" repro.obs dash   {len(state.sources)} source(s)   "
           f"{state.n_frames} frame(s)   last {when}",
           bar]

    if state.ticks:
        out.append(f" {'scenario':<20} {'seed':>4} {'pol':>4} {'tick':>5} "
                   f"{'tick/s':>7} {'qos':>7} {'miss':>7} {'queue':>6} "
                   f"{'infl':>5} {'drop':>5}")
        for (scenario, seed, policy), cell in sorted(
                state.ticks.items(), key=lambda kv: str(kv[0])):
            out.append(
                f" {str(scenario):<20} {str(seed):>4} "
                f"{str(policy)[:4]:>4} {cell.get('tick', 0):>5} "
                f"{_fmt(state.tick_rate(cell), '.2f')} "
                f"{_fmt(cell.get('window_qos'))} "
                f"{_fmt(cell.get('miss_rate'))} "
                f"{cell.get('queue_depth', 0):>6} "
                f"{cell.get('in_flight', 0):>5} "
                f"{cell.get('dropped', 0):>5}")
    else:
        out.append(" (no tick frames yet)")

    if state.gateways:
        out.append("")
        out.append(f" {'gateway':<20} {'mode':>5} {'spd':>5} {'tick':>5} "
                   f"{'adm':>6} {'ingr':>5} {'lag ms':>7} {'drop':>5} "
                   f"{'late':>5}")
        for (scenario, seed, policy), cell in sorted(
                state.gateways.items(), key=lambda kv: str(kv[0])):
            out.append(
                f" {f'{scenario}/s{seed}':<20} "
                f"{str(cell.get('mode', '?'))[:5]:>5} "
                f"{_fmt(cell.get('speed'), '.3g', 5)} "
                f"{cell.get('tick', 0):>5} "
                f"{cell.get('requests', 0):>6} "
                f"{cell.get('ingress_depth', 0):>5} "
                f"{_fmt(cell.get('loop_lag_ms'), '.2f')} "
                f"{cell.get('dropped_ingress', 0):>5} "
                f"{cell.get('late', 0):>5}")

    if state.workers:
        out.append("")
        out.append(f" {'worker':<20} {'tasks':>6} {'items':>7} "
                   f"{'items/s':>8} {'pending':>8} {'eta':>8}")
        for owner, w in sorted(state.workers.items()):
            rate = float(w.get("items_per_s") or 0.0)
            pending = w.get("queue_pending_items")
            eta = pending / rate if pending and rate > 0 else None
            out.append(f" {owner:<20} {w.get('tasks_done', 0):>6} "
                       f"{w.get('items_done', 0):>7} "
                       f"{_fmt(rate, '.2f', 8)} "
                       f"{pending if pending is not None else 'n/a':>8} "
                       f"{_fmt(eta, '.0f', 7) + 's' if eta is not None else '     n/a'}")

    if state.requests:
        out.append("")
        out.append(f" requests ({state.n_requests} sampled)"
                   f"{'':<7} {'uid':>6} {'tick':>5} {'edge':>5} "
                   f"{'impl':>5} {'lat ms':>8} {'kept for':>13} flags")
        for rec in state.requests:
            impl = next((ev.get("impl") for ev in rec.get("events", [])
                         if ev.get("stage") == "route"), None)
            lat = rec.get("latency_s")
            flags = ",".join(f for f in ("dropped", "missed", "requeued")
                             if rec.get(f)) or "-"
            out.append(
                f" {'':<20} {rec.get('uid', '?'):>6} "
                f"{rec.get('tick', '?'):>5} {rec.get('edge', '?'):>5} "
                f"{impl if impl is not None else '-':>5} "
                f"{_fmt(lat * 1e3 if lat is not None else None, '.2f', 8)} "
                f"{str(rec.get('keep_reason', '?')):>13} {flags}")

    if state.chunks["n"]:
        out.append("")
        out.append(f" sweep chunks: {state.chunks['n']} "
                   f"({state.chunks['items']} item(s))")

    reports = [r for r in evaluate_slos(slos, frames=state.frames)
               if r.n_samples > 0]
    if reports:
        out.append("")
        out.append(" SLO")
        for r in reports:
            out.append(" " + r.line())
    out.append(bar)
    return "\n".join(out)


def _pump(spec: str, sink: "queue.Queue", timeout_s: float) -> None:
    try:
        for frame in read_stream(spec, follow=True, timeout_s=timeout_s):
            sink.put(frame)
    except Exception as e:  # surfaced by the main loop, never lost
        sink.put({"type": "_error", "payload": {"spec": spec,
                                                "error": str(e)}})
    finally:
        sink.put({"type": "_eof", "payload": {"spec": spec}})


def run_dash(specs: List[str], *, interval: float = 1.0,
             timeout_s: float = 10.0, once: bool = False,
             max_frames: Optional[int] = None,
             slos: Iterable[SLO] = DEFAULT_SLOS,
             out=None, clear: bool = True) -> int:
    """Tail the given streams and render until they end.

    ``once`` drains what is currently available, renders a single screen,
    and exits (0 when at least one frame arrived, 2 otherwise — the
    smoke contract). Returns a process exit code.
    """
    out = out or sys.stdout
    state = DashState()
    frames: "queue.Queue" = queue.Queue()
    threads = []
    for spec in specs:
        th = threading.Thread(
            target=_pump, args=(spec, frames, 0.5 if once else timeout_s),
            daemon=True)
        th.start()
        threads.append(th)
    live = len(threads)
    errors: List[str] = []
    last_render = 0.0
    while live > 0:
        try:
            frame = frames.get(timeout=0.2)
        except queue.Empty:
            frame = None
        if frame is not None:
            if frame.get("type") == "_eof":
                live -= 1
            elif frame.get("type") == "_error":
                errors.append(f"{frame['payload']['spec']}: "
                              f"{frame['payload']['error']}")
                live -= 1
            else:
                state.update(frame)
        if not once and time.monotonic() - last_render >= interval:
            screen = render(state, slos=slos)
            out.write((_CLEAR if clear else "") + screen + "\n")
            out.flush()
            last_render = time.monotonic()
        if max_frames is not None and state.n_frames >= max_frames:
            break
    screen = render(state, slos=slos)
    out.write((_CLEAR if clear and not once else "") + screen + "\n")
    for err in errors:
        out.write(f" [dash] stream error: {err}\n")
    out.flush()
    if errors:
        return 1
    return 0 if state.n_frames > 0 else 2
