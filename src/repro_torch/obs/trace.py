"""Determinism-safe span/event tracer with a preallocated ring buffer.

The tracer is the timing half of :mod:`repro_torch.obs`: nestable
``span("tick.place")`` context managers, monotonic counters, and
timestamped gauge samples, all recorded into preallocated NumPy ring
buffers so the *enabled* hot path allocates nothing but one small span
handle and the *disabled* path is a single module-global load, a ``None``
check, and a slotted no-op context manager.

Hard invariant (the reason this module exists at all): tracing is
**observational only**. Nothing here feeds back into placement, routing,
scheduling, or sweep values — enabling the tracer changes no stored byte
of any :class:`~repro_torch.sweeps.store.SweepStore`. Everything is **off
by default**; a process opts in via :func:`enable`, a CLI ``--obs`` flag,
or the ``REPRO_OBS`` environment variable (see :func:`enable_from_env`).

Artifacts: :meth:`Tracer.snapshot` serializes the buffers into a
versioned JSON document (``obs_schema`` :data:`OBS_SCHEMA_VERSION`, the
same schema as :mod:`repro.obs.trace`'s, so either package loads the
other's artifacts); :func:`to_chrome_trace` converts any such document
into Chrome-trace / Perfetto JSON (open ``chrome://tracing`` or
https://ui.perfetto.dev and load the file).

When the owning :class:`Tracer` was enabled with ``annotations=True``
every span additionally enters a ``torch.profiler.record_function`` of the
same name, so obs spans appear on a ``torch.profiler`` timeline next to
the CUDA kernels they launch.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from .metrics import MetricsRegistry

__all__ = [
    "OBS_SCHEMA_VERSION",
    "READABLE_OBS_SCHEMAS",
    "DEFAULT_CAPACITY",
    "Tracer",
    "enable",
    "disable",
    "enabled",
    "get_tracer",
    "span",
    "count",
    "sample",
    "save",
    "enable_from_env",
    "load_artifact",
    "to_chrome_trace",
    "validate_chrome_trace",
]

#: Version stamp of the raw obs artifact (``Tracer.snapshot()`` output),
#: the reference's: v2 added the ``anchor`` wall/monotonic clock pair that
#: aligns traces from different processes onto one timeline; v1 artifacts
#: still load.
OBS_SCHEMA_VERSION = 2

#: Artifact schema versions :func:`load_artifact` accepts.
READABLE_OBS_SCHEMAS = (1, 2)

#: Default ring-buffer capacity (spans and gauge samples each). At ~26
#: bytes/span this is ~1.7 MB of preallocated buffer — hours of per-tick
#: serving spans before the ring wraps (wraps drop the *oldest* records
#: and are counted, never silently).
DEFAULT_CAPACITY = 65536

_ENV_FLAG = "REPRO_OBS"
_ENV_DIR = "REPRO_OBS_DIR"


class _NullSpan:
    """The disabled-path span: one shared, stateless, slotted no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle; records into the tracer's ring on ``__exit__``."""

    __slots__ = ("_tracer", "_name_id", "_args", "_t0", "_ann_ctx")

    def __init__(self, tracer: "Tracer", name_id: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name_id = name_id
        self._args = args
        self._t0 = 0
        self._ann_ctx = None

    def __enter__(self) -> "_Span":
        tr = self._tracer
        if tr._ann is not None:
            self._ann_ctx = tr._ann(tr._names[self._name_id])
            self._ann_ctx.__enter__()
        tr._depth_of(threading.get_ident())  # ensure tid registered
        local = tr._local
        local.depth = getattr(local, "depth", 0) + 1
        self._t0 = tr._clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._clock()
        tr = self._tracer
        local = tr._local
        depth = getattr(local, "depth", 1)
        local.depth = depth - 1
        tr._record(self._name_id, self._t0, t1, depth - 1, self._args)
        if self._ann_ctx is not None:
            self._ann_ctx.__exit__(*(exc or (None, None, None)))
        return False


class Tracer:
    """Span/counter/gauge recorder over preallocated ring buffers.

    ``clock`` is injectable (defaults to :func:`time.perf_counter_ns`) so
    tests can drive a deterministic fake clock and golden-test the export
    byte-for-byte. ``annotations=True`` mirrors every span into a
    ``torch.profiler.record_function`` (near no-op when no profiler is
    collecting), putting obs spans on the torch/CUDA profile next to the
    kernels' device time.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 clock: Optional[Callable[[], int]] = None,
                 annotations: bool = False):
        self.capacity = int(capacity)
        if self.capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._clock = clock or time.perf_counter_ns
        self._lock = threading.Lock()
        self._local = threading.local()
        # interned span/gauge names
        self._names: List[str] = []
        self._name_ids: Dict[str, int] = {}
        # span ring: parallel preallocated arrays, slot = n % capacity
        self._s_name = np.zeros(self.capacity, np.int32)
        self._s_t0 = np.zeros(self.capacity, np.int64)
        self._s_t1 = np.zeros(self.capacity, np.int64)
        self._s_tid = np.zeros(self.capacity, np.int32)
        self._s_depth = np.zeros(self.capacity, np.int16)
        self._s_args: Dict[int, Dict[str, Any]] = {}  # slot -> args
        self._n_spans = 0   # total ever recorded (>= capacity ⇒ wrapped)
        # gauge-sample ring (timeline counters: queue depth, QoS, ...)
        self._g_name = np.zeros(self.capacity, np.int32)
        self._g_t = np.zeros(self.capacity, np.int64)
        self._g_val = np.zeros(self.capacity, np.float64)
        self._n_gauges = 0
        # monotonic counters + the metrics registry (histograms/gauges)
        self.counters: Dict[str, float] = {}
        self.metrics = MetricsRegistry()
        # small-int thread ids, stable within this tracer
        self._tids: Dict[int, int] = {}
        self._ann = None
        if annotations:
            from torch.profiler import record_function
            self._ann = record_function

    # -- recording ---------------------------------------------------------
    def _depth_of(self, ident: int) -> int:
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _intern(self, name: str) -> int:
        name_id = self._name_ids.get(name)
        if name_id is None:
            with self._lock:
                name_id = self._name_ids.get(name)
                if name_id is None:
                    name_id = len(self._names)
                    self._names.append(name)
                    self._name_ids[name] = name_id
        return name_id

    def span(self, name: str, args: Optional[Dict[str, Any]] = None
             ) -> _Span:
        return _Span(self, self._intern(name), args)

    def _record(self, name_id: int, t0: int, t1: int, depth: int,
                args: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            slot = self._n_spans % self.capacity
            self._s_name[slot] = name_id
            self._s_t0[slot] = t0
            self._s_t1[slot] = t1
            self._s_tid[slot] = self._tids.get(threading.get_ident(), 0)
            self._s_depth[slot] = depth
            if args is not None:
                self._s_args[slot] = args
            else:
                self._s_args.pop(slot, None)  # slot reuse after a wrap
            self._n_spans += 1

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def sample(self, name: str, value: float) -> None:
        """Record a timestamped gauge sample (a Chrome-trace ``C`` event:
        queue depth, realized QoS, ... over the span timeline)."""
        name_id = self._intern(name)  # gauge names share the intern table
        with self._lock:
            slot = self._n_gauges % self.capacity
            self._g_name[slot] = name_id
            self._g_t[slot] = self._clock()
            self._g_val[slot] = value
            self._n_gauges += 1

    # -- export ------------------------------------------------------------
    @property
    def n_spans(self) -> int:
        return self._n_spans

    @property
    def dropped_spans(self) -> int:
        return max(0, self._n_spans - self.capacity)

    def _ring_view(self, arrays: List[np.ndarray], n_total: int
                   ) -> List[np.ndarray]:
        """Live records of one ring, oldest → newest."""
        n = min(n_total, self.capacity)
        if n_total <= self.capacity:
            return [a[:n].copy() for a in arrays]
        head = n_total % self.capacity
        return [np.concatenate([a[head:], a[:head]]) for a in arrays]

    def snapshot(self) -> Dict[str, Any]:
        """The versioned raw artifact (JSON-serializable)."""
        with self._lock:
            s_name, s_t0, s_t1, s_tid, s_depth = self._ring_view(
                [self._s_name, self._s_t0, self._s_t1, self._s_tid,
                 self._s_depth], self._n_spans)
            g_name, g_t, g_val = self._ring_view(
                [self._g_name, self._g_t, self._g_val], self._n_gauges)
            # args are keyed by slot; map them back to snapshot row order
            n = min(self._n_spans, self.capacity)
            base = self._n_spans - n
            args = {}
            for row in range(n):
                slot = (base + row) % self.capacity
                if slot in self._s_args:
                    args[str(row)] = self._s_args[slot]
            # wall/monotonic pair sampled under the same lock: both clocks
            # advance at wall rate, so the offset (wall_ns − mono_ns) is a
            # process constant and any capture time yields the same
            # cross-process alignment (to clock-sync precision)
            anchor = {"wall_ns": time.time_ns(), "mono_ns": self._clock()}
            return {
                "obs_schema": OBS_SCHEMA_VERSION,
                "clock": "perf_counter_ns",
                "anchor": anchor,
                "names": list(self._names),
                "spans": {
                    "name": s_name.tolist(), "t0_ns": s_t0.tolist(),
                    "t1_ns": s_t1.tolist(), "tid": s_tid.tolist(),
                    "depth": s_depth.tolist(),
                },
                "span_args": args,
                "gauges": {
                    "name": g_name.tolist(), "t_ns": g_t.tolist(),
                    "value": g_val.tolist(),
                },
                "counters": dict(self.counters),
                "metrics": self.metrics.snapshot(),
                "dropped_spans": self.dropped_spans,
                "dropped_gauges": max(0, self._n_gauges - self.capacity),
                "pid": os.getpid(),
            }

    def save(self, path) -> None:
        """Atomically publish the snapshot as JSON at ``path``."""
        _atomic_write_text(path, json.dumps(self.snapshot()))

    def chrome_trace(self) -> Dict[str, Any]:
        return to_chrome_trace(self.snapshot())

    def span_durations_s(self, name: str) -> np.ndarray:
        """Recorded durations (seconds) of every live span named
        ``name``."""
        name_id = self._name_ids.get(name)
        if name_id is None:
            return np.zeros(0, np.float64)
        with self._lock:
            s_name, s_t0, s_t1 = self._ring_view(
                [self._s_name, self._s_t0, self._s_t1], self._n_spans)
        mask = s_name == name_id
        return (s_t1[mask] - s_t0[mask]).astype(np.float64) / 1e9


# ===========================================================================
# Module-level switch (the fast path lives here)
# ===========================================================================

_TRACER: Optional[Tracer] = None


def enable(capacity: int = DEFAULT_CAPACITY, *,
           clock: Optional[Callable[[], int]] = None,
           annotations: bool = False) -> Tracer:
    """Install (and return) the process-global tracer. Idempotent-ish:
    enabling over a live tracer replaces it (the old one keeps working
    for code still holding a reference)."""
    global _TRACER
    _TRACER = Tracer(capacity, clock=clock, annotations=annotations)
    return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall the global tracer; returns it so callers can still
    snapshot/save what was recorded."""
    global _TRACER
    tr, _TRACER = _TRACER, None
    return tr


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **args: Any):
    """``with span("tick.place"): ...`` — the one instrumentation
    primitive on every hot path. Disabled cost: one global load, one
    ``None`` check, one shared no-op context manager."""
    tr = _TRACER
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, args or None)


def count(name: str, n: float = 1) -> None:
    tr = _TRACER
    if tr is not None:
        tr.count(name, n)


def sample(name: str, value: float) -> None:
    tr = _TRACER
    if tr is not None:
        tr.sample(name, value)


def save(path) -> bool:
    """Save the global tracer's snapshot; False when tracing is off."""
    tr = _TRACER
    if tr is None:
        return False
    tr.save(path)
    return True


def enable_from_env(default_name: str = "obs") -> Optional[Tracer]:
    """Opt-in via environment — how a child process inherits tracing.

    ``REPRO_OBS=1`` enables the tracer; if ``REPRO_OBS_DIR`` is also set,
    an :mod:`atexit` hook saves ``<dir>/<default_name>_<pid>.json`` on
    clean exit. Anything else leaves observability off (the default).
    """
    if os.environ.get(_ENV_FLAG, "").strip() not in ("1", "true", "on"):
        return None
    tr = enable()
    out_dir = os.environ.get(_ENV_DIR, "").strip()
    if out_dir:
        import atexit

        path = os.path.join(out_dir, f"{default_name}_{os.getpid()}.json")

        def _save(tracer=tr, path=path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tracer.save(path)

        atexit.register(_save)
    return tr


# ===========================================================================
# Artifact I/O + Chrome-trace conversion
# ===========================================================================

def _atomic_write_text(path, text: str) -> None:
    """Tempfile + rename publish (obs depends on nothing else in
    repro_torch, so it carries its own copy of the crash-safe write)."""
    import tempfile

    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_artifact(path) -> Dict[str, Any]:
    """Load + version-check a raw obs artifact."""
    with open(path) as f:
        doc = json.load(f)
    have = int(doc.get("obs_schema", -1))
    if have not in READABLE_OBS_SCHEMAS:
        raise ValueError(f"{path}: obs artifact schema v{have}, this code "
                         f"reads v{list(READABLE_OBS_SCHEMAS)}")
    return doc


def _cat_of(name: str) -> str:
    """Chrome-trace category = the name's first dotted component
    (``kernel.qos_matrix`` → ``kernel``)."""
    return name.split(".", 1)[0]


def to_chrome_trace(doc: Mapping[str, Any]) -> Dict[str, Any]:
    """Convert a raw artifact into Chrome-trace / Perfetto JSON.

    Timestamps are rebased so the earliest record sits at t=0 (µs), which
    also makes the export a pure function of the recorded deltas — the
    golden-export test relies on that.
    """
    names = list(doc.get("names", []))
    spans = doc.get("spans", {})
    gauges = doc.get("gauges", {})
    s_t0 = spans.get("t0_ns", [])
    g_t = gauges.get("t_ns", [])
    base = min([*s_t0, *g_t], default=0)
    pid = int(doc.get("pid", 0))
    events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": "repro_torch.obs"}},
    ]
    span_args = doc.get("span_args", {})
    for row, (nid, t0, t1, tid, _depth) in enumerate(zip(
            spans.get("name", []), s_t0, spans.get("t1_ns", []),
            spans.get("tid", []), spans.get("depth", []))):
        name = names[nid]
        ev: Dict[str, Any] = {
            "ph": "X", "name": name, "cat": _cat_of(name), "pid": pid,
            "tid": int(tid), "ts": (t0 - base) / 1e3,
            "dur": (t1 - t0) / 1e3,
        }
        args = span_args.get(str(row))
        if args:
            ev["args"] = args
        events.append(ev)
    for nid, t, v in zip(gauges.get("name", []), g_t,
                         gauges.get("value", [])):
        name = names[nid]
        events.append({"ph": "C", "name": name, "cat": _cat_of(name),
                       "pid": pid, "tid": 0, "ts": (t - base) / 1e3,
                       "args": {"value": v}})
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "obs_schema": doc.get("obs_schema", OBS_SCHEMA_VERSION),
            "dropped_spans": doc.get("dropped_spans", 0),
            "counters": doc.get("counters", {}),
        },
        "traceEvents": events,
    }


def validate_chrome_trace(doc: Mapping[str, Any]) -> int:
    """Structural validation of a Chrome-trace document; returns the
    number of duration (``X``) events. Raises ``ValueError`` on malformed
    documents."""
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("chrome trace has no traceEvents")
    n_x = 0
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"malformed trace event: {ev!r}")
        if ev["ph"] == "X":
            for field in ("name", "ts", "dur", "pid", "tid"):
                if field not in ev:
                    raise ValueError(f"X event missing {field!r}: {ev!r}")
            if ev["dur"] <= 0:
                raise ValueError(
                    f"non-positive duration ({ev['dur']}): span "
                    f"{ev.get('name')!r} must close strictly after it "
                    f"opens — zero-length spans indicate a clock that "
                    f"did not advance: {ev!r}")
            n_x += 1
    return n_x
