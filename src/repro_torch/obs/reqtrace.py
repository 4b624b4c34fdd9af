"""Per-request causal tracing — the "explain this request" layer.

A :class:`RequestTrace` record follows one user request through its
whole life on the control plane::

    receipt → admit → place → route → queue → execute
                                    ↘ requeue ↗   ↘ drop
                                            complete

Requests are keyed by ``(seed, tick, uid)`` — ``uid`` is the
horizon-global request id assigned by
:class:`~repro_torch.serving.horizon.TickController` (globally unique and
advanced even for dropped users, so the key is stable between a live
run and an offline replay of the same seeded trace).

Design rules, those of the span tracer (:mod:`repro_torch.obs.trace`):

* **Off by default, observational always.** Every hook site reads one
  module global (``_REQTRACER``) and bails on ``None`` — the disabled
  path is a single load + identity check, within the existing ~0.25 µs
  span budget. Enabled or not, hooks only *read* control-plane state;
  stores, TickReports, and gateway digests stay byte-identical.
* **Preallocated ring storage.** Finished traces land in a
  fixed-capacity ring (oldest evicted, eviction counted) so a long
  soak cannot grow memory without bound.
* **Deterministic tail-based sampling.** At completion a trace is kept
  iff it is *special* — deadline miss, drop, requeue, or a latency at
  or above the tracer's own running p99 — or its uid survives a seeded
  multiplicative hash (``sample_every`` knob). No wall clock, no RNG:
  the same (config, seed, trace) keeps the identical uid set across
  runs and across gateway-vs-offline replay.

Exported artifacts are JSON documents versioned by
:data:`REQTRACE_SCHEMA_VERSION`, the reference's schema
(:mod:`repro.obs.reqtrace`): each package's :func:`load_reqtrace` reads
the other's documents and ``reqtrace`` stream frames.
"""
from __future__ import annotations

import atexit
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import Histogram

__all__ = [
    "REQTRACE_SCHEMA_VERSION",
    "STAGES",
    "RequestTracer",
    "enable_request_tracing",
    "disable_request_tracing",
    "get_request_tracer",
    "enable_reqtrace_from_env",
    "load_reqtrace",
    "explain_uid",
]

#: Version stamp of the request-trace export document.
REQTRACE_SCHEMA_VERSION = 1

#: Canonical lifecycle stages, in causal order. ``receipt`` only exists
#: for wall-clock gateway runs (socket receipt time); offline horizons
#: start at ``admit``.
STAGES = ("receipt", "admit", "place", "route", "queue",
          "execute", "requeue", "drop", "complete")

# Fibonacci-hashing multiplier (golden-ratio constant) — uid bits are
# sequential, so plain modulo would sample one contiguous block per
# tick; the multiply decorrelates uid from keep decision.
_HASH_MULT = 0x9E3779B97F4A7C15
_HASH_MASK = (1 << 64) - 1

#: The one module-global hook target. Hot paths read this directly
#: (``rt = reqtrace._REQTRACER``) so the disabled cost is one global
#: load + ``is None``.
_REQTRACER: Optional["RequestTracer"] = None


class RequestTracer:
    """Collects per-request lifecycle events with tail-based sampling.

    Parameters
    ----------
    capacity:
        Ring size for *kept* (finished, sampled-in) traces.
    sample_every:
        Keep roughly 1-in-N of the non-special tail by seeded uid
        hash. ``1`` keeps everything, ``0`` keeps only special traces
        (misses / drops / requeues / p99 outliers).
    salt:
        Seed folded into the hash — set from the horizon seed so
        replaying the same trace reproduces the same sampled uid set.
    exemplars_per_bucket:
        How many uids a histogram bucket links to (first-N, see
        :meth:`repro_torch.obs.metrics.Histogram.observe`).
    """

    def __init__(self, *, capacity: int = 4096, sample_every: int = 16,
                 salt: int = 0, exemplars_per_bucket: int = 2) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if sample_every < 0:
            raise ValueError(
                f"sample_every must be >= 0, got {sample_every}")
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.salt = int(salt)
        self.exemplars_per_bucket = int(exemplars_per_bucket)
        self.seed: Optional[int] = None
        # in-flight traces: uid -> mutable record
        self._pending: Dict[int, Dict[str, Any]] = {}
        # finished + kept traces on a preallocated ring
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._n_kept = 0          # monotone; slot = n % capacity
        self.evicted_records = 0  # kept traces overwritten by the ring
        self.discarded = 0        # finished traces sampled out
        # the tracer's own latency view — drives the p99-outlier rule
        self._lat_hist = Histogram()
        # per-tick placement-epoch context for `explain`
        self._epochs: Dict[int, Dict[str, Any]] = {}
        # kept-trace queue for per-tick stream emission (drained by the
        # controller; bounded by the same capacity)
        self._emit_queue: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    # lifecycle hooks (all observational)
    # ------------------------------------------------------------------
    def set_context(self, seed: int) -> None:
        """Bind the horizon seed (also folds it into the sample hash)."""
        if self.seed is None:
            self.seed = int(seed)
            self.salt = (self.salt + int(seed)) & _HASH_MASK

    def _rec(self, uid: int) -> Dict[str, Any]:
        rec = self._pending.get(uid)
        if rec is None:
            rec = {"uid": int(uid), "tick": -1, "events": [],
                   "missed": False, "dropped": False, "requeued": False}
            self._pending[uid] = rec
        return rec

    def event(self, uid: int, stage: str, t: float,
              **detail: Any) -> None:
        """Record one lifecycle event at simulation time ``t``."""
        ev: Dict[str, Any] = {"stage": stage, "t": float(t)}
        if detail:
            ev.update(detail)
        self._rec(uid)["events"].append(ev)

    def admit(self, uid: int, tick: int, *, edge: int, service: int,
              alpha: float, delta: float, arrival: float) -> None:
        rec = self._rec(uid)
        rec["tick"] = int(tick)
        rec["edge"] = int(edge)
        rec["service"] = int(service)
        rec["alpha"] = float(alpha)
        rec["delta"] = float(delta)
        rec["events"].append({"stage": "admit", "t": float(arrival),
                              "tick": int(tick)})

    def route(self, uid: int, t: float, *, impl: int, q: float,
              candidates: Iterable[Tuple[int, float]] = ()) -> None:
        """OMS picked ``impl``; ``candidates`` are the rejected
        runners-up as ``(impl, qos)`` pairs, best first."""
        self.event(uid, "route", t, impl=int(impl), q=float(q),
                   rejected=[[int(p), float(v)] for p, v in candidates])

    def requeue(self, uid: int, t: float, *, impl: int) -> None:
        rec = self._rec(uid)
        rec["requeued"] = True
        rec["events"].append({"stage": "requeue", "t": float(t),
                              "impl": int(impl)})

    def execute(self, uid: int, t: float, *, wait_s: float) -> None:
        self.event(uid, "execute", t, wait_s=float(wait_s))

    def drop(self, uid: int, t: float, *, reason: str) -> None:
        """Terminal: the request could not be served. Always kept."""
        rec = self._rec(uid)
        rec["dropped"] = True
        rec["events"].append({"stage": "drop", "t": float(t),
                              "reason": reason})
        self._finish(uid, rec)

    def complete(self, uid: int, t: float, *, latency: float,
                 missed: bool) -> None:
        """Terminal: the request finished executing."""
        rec = self._rec(uid)
        rec["missed"] = bool(missed)
        rec["latency_s"] = float(latency)
        rec["events"].append({"stage": "complete", "t": float(t),
                              "latency_s": float(latency),
                              "missed": bool(missed)})
        # observe-then-test: with one sample the p99 is that sample, so
        # early completions over-keep — deterministic, and exactly what
        # a tail sampler warming up should do.
        self._lat_hist.observe(latency)
        self._finish(uid, rec)

    def epoch(self, tick: int, **info: Any) -> None:
        """Record placement-epoch context (σ, loads, …) for a tick."""
        self._epochs[int(tick)] = {k: v for k, v in info.items()}

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _hash_keep(self, uid: int) -> bool:
        if self.sample_every == 0:
            return False
        if self.sample_every == 1:
            return True
        h = ((uid * _HASH_MULT) + self.salt) & _HASH_MASK
        return (h >> 32) % self.sample_every == 0

    def keep_reason(self, rec: Dict[str, Any]) -> Optional[str]:
        """Why this finished trace is kept (``None`` → sampled out)."""
        if rec.get("dropped"):
            return "dropped"
        if rec.get("missed"):
            return "deadline_miss"
        if rec.get("requeued"):
            return "requeued"
        lat = rec.get("latency_s")
        if lat is not None and self._lat_hist.count > 0:
            if lat >= self._lat_hist.quantile(0.99):
                return "p99_outlier"
        if self._hash_keep(rec["uid"]):
            return "sampled"
        return None

    def _finish(self, uid: int, rec: Dict[str, Any]) -> None:
        self._pending.pop(uid, None)
        reason = self.keep_reason(rec)
        if reason is None:
            self.discarded += 1
            return
        rec["keep_reason"] = reason
        slot = self._n_kept % self.capacity
        if self._ring[slot] is not None:
            self.evicted_records += 1
        self._ring[slot] = rec
        self._n_kept += 1
        if len(self._emit_queue) >= self.capacity:
            self._emit_queue.pop(0)
        self._emit_queue.append(rec)

    # ------------------------------------------------------------------
    # reads / export
    # ------------------------------------------------------------------
    def kept(self) -> List[Dict[str, Any]]:
        """Kept traces, oldest first."""
        n = min(self._n_kept, self.capacity)
        start = self._n_kept - n
        return [self._ring[i % self.capacity]
                for i in range(start, self._n_kept)]

    def kept_uids(self) -> List[int]:
        return [rec["uid"] for rec in self.kept()]

    def trace(self, uid: int) -> Optional[Dict[str, Any]]:
        """Look up one trace by uid (kept ring, then in-flight)."""
        for rec in self.kept():
            if rec["uid"] == uid:
                return rec
        return self._pending.get(uid)

    def drain_emits(self) -> List[Dict[str, Any]]:
        """Kept traces since the last drain (for stream emission)."""
        out, self._emit_queue = self._emit_queue, []
        return out

    def exemplar(self, uid: int, tick: int) -> Dict[str, int]:
        """The histogram-exemplar payload linking a bucket to a trace."""
        return {"uid": int(uid), "tick": int(tick)}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "reqtrace_schema": REQTRACE_SCHEMA_VERSION,
            "seed": self.seed,
            "sample_every": self.sample_every,
            "capacity": self.capacity,
            "kept": self._n_kept,
            "discarded": self.discarded,
            "evicted_records": self.evicted_records,
            "pending": len(self._pending),
            "records": self.kept(),
            "epochs": {str(t): info
                       for t, info in sorted(self._epochs.items())},
        }

    def save(self, path: str) -> None:
        from .trace import _atomic_write_text
        _atomic_write_text(
            path, json.dumps(self.snapshot(), sort_keys=True))


# ----------------------------------------------------------------------
# module-level enable/disable (mirrors repro_torch.obs.trace)
# ----------------------------------------------------------------------
def enable_request_tracing(*, capacity: int = 4096, sample_every: int = 16,
                           salt: int = 0,
                           exemplars_per_bucket: int = 2) -> RequestTracer:
    """Install a fresh global :class:`RequestTracer` and return it."""
    global _REQTRACER
    _REQTRACER = RequestTracer(capacity=capacity,
                               sample_every=sample_every, salt=salt,
                               exemplars_per_bucket=exemplars_per_bucket)
    return _REQTRACER


def disable_request_tracing() -> Optional[RequestTracer]:
    """Remove the global tracer; returns it for final export."""
    global _REQTRACER
    rt, _REQTRACER = _REQTRACER, None
    return rt


def get_request_tracer() -> Optional[RequestTracer]:
    return _REQTRACER


def enable_reqtrace_from_env() -> Optional[RequestTracer]:
    """``REPRO_OBS_REQTRACE=<path>`` → trace and save on exit.

    ``REPRO_OBS_REQTRACE_SAMPLE`` overrides ``sample_every``.
    """
    path = os.environ.get("REPRO_OBS_REQTRACE")
    if not path or _REQTRACER is not None:
        return _REQTRACER
    sample = int(os.environ.get("REPRO_OBS_REQTRACE_SAMPLE", "16"))
    rt = enable_request_tracing(sample_every=sample)

    def _save() -> None:
        if get_request_tracer() is rt:
            rt.save(path)

    atexit.register(_save)
    return rt


# ----------------------------------------------------------------------
# offline readers (CLI `explain`)
# ----------------------------------------------------------------------
def load_reqtrace(path: str) -> Dict[str, Any]:
    """Load a request-trace artifact — either a :meth:`snapshot` JSON
    document or a stream file carrying ``reqtrace`` frames."""
    with open(path, "r", encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            first = json.loads(f.readline())
            if "reqtrace_schema" in first:
                have = first["reqtrace_schema"]
                if have != REQTRACE_SCHEMA_VERSION:
                    raise ValueError(
                        f"unreadable reqtrace schema v{have} "
                        f"(this reader understands "
                        f"v{REQTRACE_SCHEMA_VERSION})")
                return first
            # else: fall through to stream parsing (first line was a
            # stream frame, also a JSON object)
        records: List[Dict[str, Any]] = []
        epochs: Dict[str, Any] = {}
        seed = None
        f.seek(0)
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                frame = json.loads(line)
            except json.JSONDecodeError:
                continue
            if frame.get("type") == "reqtrace":
                records.append(frame["payload"])
            elif frame.get("type") == "ledger":
                pass  # ledger frames live in repro_torch.obs.ledger
            elif frame.get("type") == "hello":
                seed = frame.get("payload", {}).get("seed", seed)
    return {"reqtrace_schema": REQTRACE_SCHEMA_VERSION, "seed": seed,
            "records": records, "epochs": epochs}


def explain_uid(doc: Dict[str, Any], uid: int,
                tick: Optional[int] = None) -> str:
    """Render the full causal chain of one sampled uid as text."""
    recs = [r for r in doc.get("records", []) if r.get("uid") == uid]
    if tick is not None:
        recs = [r for r in recs if r.get("tick") == tick]
    if not recs:
        where = f"uid {uid}" + (f" tick {tick}" if tick is not None
                                else "")
        raise ValueError(
            f"no sampled trace for {where} — it may have been sampled "
            f"out (raise the keep rate with sample_every=1) or never "
            f"admitted")
    rec = recs[-1]
    order = {s: i for i, s in enumerate(STAGES)}
    events = sorted(rec.get("events", []),
                    key=lambda e: (e["t"], order.get(e["stage"], 99)))
    lines = [f"request uid={rec['uid']} tick={rec.get('tick')} "
             f"edge={rec.get('edge', '?')} "
             f"service={rec.get('service', '?')} "
             f"alpha={rec.get('alpha', float('nan')):.3f} "
             f"delta={rec.get('delta', float('nan')):.3f}s "
             f"[kept: {rec.get('keep_reason', '?')}]"]
    epoch = doc.get("epochs", {}).get(str(rec.get("tick")))
    if epoch:
        lines.append(
            f"  placement epoch t={rec.get('tick')}: "
            + " ".join(f"{k}={v}" for k, v in sorted(epoch.items())))
    t0 = events[0]["t"] if events else 0.0
    for ev in events:
        extra = {k: v for k, v in ev.items()
                 if k not in ("stage", "t")}
        parts = [f"  {ev['t']:12.6f}s  +{ev['t'] - t0:8.6f}s  "
                 f"{ev['stage']:<8}"]
        if ev["stage"] == "route" and "rejected" in extra:
            rej = extra.pop("rejected")
            parts.append(f"impl={extra.pop('impl')} "
                         f"q={extra.pop('q'):.4f} rejected=["
                         + ", ".join(f"impl {p} (q={v:.4f})"
                                     for p, v in rej) + "]")
        if extra:
            parts.append(" ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in sorted(extra.items())))
        lines.append(" ".join(parts))
    flags = [f for f in ("missed", "dropped", "requeued")
             if rec.get(f)]
    if flags:
        lines.append(f"  flags: {', '.join(flags)}")
    if "latency_s" in rec:
        lines.append(f"  latency: {rec['latency_s'] * 1e3:.3f} ms "
                     f"(deadline {rec.get('delta', 0.0) * 1e3:.1f} ms)")
    return "\n".join(lines)
