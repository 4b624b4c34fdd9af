"""Worker telemetry: heartbeat-published throughput files (the port of
:mod:`repro.fleet.telemetry`, the same records).

Each worker publishes one JSON file at
``<fleet_root>/telemetry/<owner>.json`` (atomic tempfile-rename, same
primitive as the store) and rewrites it after every completed task. The
record is observational only — nothing in the queue, the merge, or the
determinism contract reads it; it exists so ``repro_torch.fleet status``
and ``python -m repro_torch.obs tail`` can show live per-worker rates and a
fleet ETA without touching worker stores or replaying manifests.

Record fields (``telemetry_schema`` = :data:`TELEMETRY_SCHEMA_VERSION`):

``owner``              worker name
``state``              ``running`` or the worker's stop reason
``started_at``         wall-clock epoch seconds of the worker's first task
``updated_at``         epoch seconds of the last rewrite (staleness gate)
``tasks_done``         completed task count
``items_done``         completed item count
``items_per_s``        lifetime items/s (items_done over active wall time)
``last_task``          name of the most recently completed task
``last_task_wall_s``   wall seconds of that task
``pid``                the worker process id
``anchor_mono_ns``     ``time.perf_counter_ns()`` sampled at the same
                       instant as ``updated_at`` — a wall/monotonic
                       anchor pair used by :mod:`repro_torch.obs.aggregate`
                       to align per-worker trace clocks when stitching

A worker that is SIGKILLed simply stops updating its file; readers treat
records older than their staleness window as dead and exclude them from
the live rate (the file is evidence of past throughput, not liveness —
liveness is the lease's job).
"""
from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.sweeps.store import atomic_write

__all__ = ["TELEMETRY_SCHEMA_VERSION", "DEFAULT_STALE_S", "WorkerTelemetry",
           "read_telemetry", "telemetry_dir"]

TELEMETRY_SCHEMA_VERSION = 1

#: Records not rewritten within this window count as dead for rate/ETA.
DEFAULT_STALE_S = 30.0

_TELEMETRY_DIR = "telemetry"


def telemetry_dir(fleet_root: "os.PathLike | str") -> Path:
    return Path(fleet_root) / _TELEMETRY_DIR


class WorkerTelemetry:
    """One worker's publisher. Failures to publish never fail the worker —
    telemetry is strictly best-effort."""

    def __init__(self, fleet_root: "os.PathLike | str", owner: str, *,
                 clock=time.time):
        self.owner = owner
        self.path = telemetry_dir(fleet_root) / f"{owner}.json"
        self._clock = clock
        self._started_at: Optional[float] = None
        self._t0: Optional[float] = None  # perf_counter anchor for rate
        self.tasks_done = 0
        self.items_done = 0
        self._last_task: Optional[str] = None
        self._last_task_wall_s: Optional[float] = None

    def start(self) -> None:
        self._started_at = self._clock()
        self._t0 = time.perf_counter()
        self._publish("running")

    def task_done(self, name: str, n_items: int, wall_s: float) -> None:
        if self._t0 is None:  # start() failed or was skipped
            self.start()
        self.tasks_done += 1
        self.items_done += int(n_items)
        self._last_task = name
        self._last_task_wall_s = float(wall_s)
        self._publish("running")

    def stop(self, reason: str) -> None:
        self._publish(str(reason))

    def _rate(self) -> float:
        if self._t0 is None:
            return 0.0
        elapsed = time.perf_counter() - self._t0
        return self.items_done / elapsed if elapsed > 0 else 0.0

    def record(self, state: str) -> Dict[str, Any]:
        return {
            "telemetry_schema": TELEMETRY_SCHEMA_VERSION,
            "owner": self.owner,
            "state": state,
            "started_at": self._started_at,
            "updated_at": self._clock(),
            "tasks_done": self.tasks_done,
            "items_done": self.items_done,
            "items_per_s": round(self._rate(), 6),
            "last_task": self._last_task,
            "last_task_wall_s": None if self._last_task_wall_s is None
            else round(self._last_task_wall_s, 6),
            "pid": os.getpid(),
            "anchor_mono_ns": time.perf_counter_ns(),
        }

    def _publish(self, state: str) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write(self.path, json.dumps(
                self.record(state), separators=(",", ":")).encode())
        except OSError:
            pass  # telemetry must never take a worker down


def read_telemetry(fleet_root: "os.PathLike | str", *,
                   now: Optional[float] = None,
                   stale_s: float = DEFAULT_STALE_S) -> Dict[str, Any]:
    """All worker records plus the fleet-wide live rate.

    Returns ``{"workers": {owner: record}, "rate_items_per_s": float}``
    where the rate sums ``items_per_s`` over workers whose record is in
    state ``running`` and was rewritten within ``stale_s`` seconds — a
    killed worker's frozen file stops counting once the window passes.
    """
    now = time.time() if now is None else float(now)
    workers: Dict[str, Dict[str, Any]] = {}
    d = telemetry_dir(fleet_root)
    if d.is_dir():
        for p in sorted(d.glob("*.json")):
            try:
                rec = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                continue  # mid-rename race or torn external write
            if rec.get("telemetry_schema") != TELEMETRY_SCHEMA_VERSION:
                continue
            workers[rec.get("owner", p.stem)] = rec
    rate = 0.0
    for rec in workers.values():
        fresh = (now - float(rec.get("updated_at") or 0.0)) <= stale_s
        rec["live"] = bool(fresh and rec.get("state") == "running")
        if rec["live"]:
            r = float(rec.get("items_per_s") or 0.0)
            if math.isfinite(r):
                rate += r
    return {"workers": workers, "rate_items_per_s": round(rate, 6)}
