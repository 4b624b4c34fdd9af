"""Fleet-wide trace stitching and cross-worker metric rollups (the port
of :mod:`repro.obs.aggregate`).

These are file readers: they read the fleet layout that
:mod:`repro_torch.fleet` (or the reference's ``repro.fleet``) writes, and
any set of obs artifacts. A fleet run leaves one obs artifact per worker
process (``REPRO_OBS=1 REPRO_OBS_DIR=<fleet_root>/obs`` — each worker's
atexit save). Each artifact's timestamps come from that process's *own*
monotonic clock (``time.perf_counter_ns``), whose zero point is
arbitrary per process — concatenating them naively would overlay every
worker at t=0. This module merges them into **one** coherent
Chrome/Perfetto trace:

- **worker → pid mapping**: every artifact keeps its recording process's
  pid as the Chrome-trace ``pid`` (collisions — pid reuse across hosts —
  are remapped deterministically), with a ``process_name`` metadata event
  carrying the worker label, so Perfetto shows one swimlane group per
  worker;
- **monotonic-clock alignment**: artifacts are shifted onto a common
  wall-clock timeline using each artifact's ``anchor`` (a wall/monotonic
  pair sampled at snapshot time, obs schema v2); artifacts that predate
  the anchor fall back to the fleet telemetry heartbeats
  (the fleet's ``<root>/telemetry/*.json`` records carry the same pair,
  keyed by pid), and failing both are aligned at their start;
- **metric rollup**: counters sum, histograms merge bucket-wise
  (:meth:`~repro_torch.obs.metrics.Histogram.merge` — exact bucket arithmetic,
  so the fleet rollup equals the single-process run's histograms), and
  gauges keep the last writer in label order.

``python -m repro_torch.obs stitch`` wraps :func:`stitch_fleet` for the CLI.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .metrics import MetricsRegistry
from .trace import load_artifact, validate_chrome_trace

__all__ = [
    "stitch_traces",
    "rollup_metrics",
    "rollup_counters",
    "load_fleet_artifacts",
    "telemetry_anchors",
    "stitch_fleet",
]

#: Subdirectory of a fleet root where worker obs artifacts land
#: (``REPRO_OBS_DIR`` — see :func:`repro_torch.obs.trace.enable_from_env`).
FLEET_OBS_DIR = "obs"


def _doc_offset_ns(doc: Mapping[str, Any],
                   anchors_by_pid: Mapping[int, Tuple[int, int]]
                   ) -> Optional[int]:
    """monotonic → wall offset (ns) for one artifact, or None."""
    anchor = doc.get("anchor")
    if anchor and "wall_ns" in anchor and "mono_ns" in anchor:
        return int(anchor["wall_ns"]) - int(anchor["mono_ns"])
    tele = anchors_by_pid.get(int(doc.get("pid", -1)))
    if tele is not None:
        wall_ns, mono_ns = tele
        return int(wall_ns) - int(mono_ns)
    return None


def _cat_of(name: str) -> str:
    return name.split(".", 1)[0]


def stitch_traces(docs: Sequence[Mapping[str, Any]],
                  labels: Optional[Sequence[str]] = None,
                  anchors_by_pid: Optional[Mapping[int, Tuple[int, int]]]
                  = None) -> Dict[str, Any]:
    """Merge raw obs artifacts into one Chrome-trace document.

    ``labels`` names each artifact's process swimlane (worker owner, file
    stem, ...). ``anchors_by_pid`` supplies telemetry-heartbeat fallback
    anchors ``{pid: (wall_ns, mono_ns)}`` for pre-v2 artifacts. The
    earliest aligned record sits at ts=0 µs.
    """
    if not docs:
        raise ValueError("no artifacts to stitch")
    labels = list(labels) if labels is not None else \
        [f"pid {doc.get('pid', i)}" for i, doc in enumerate(docs)]
    if len(labels) != len(docs):
        raise ValueError(f"{len(docs)} artifact(s) but {len(labels)} "
                         f"label(s)")
    anchors_by_pid = anchors_by_pid or {}

    # Anchored docs share a wall timeline; unanchored docs are aligned at
    # their start (their own min lands at the stitched t=0).
    offsets: List[Optional[int]] = [
        _doc_offset_ns(doc, anchors_by_pid) for doc in docs]
    mins: List[int] = []
    for doc in docs:
        t0 = doc.get("spans", {}).get("t0_ns", [])
        gt = doc.get("gauges", {}).get("t_ns", [])
        mins.append(min([*t0, *gt], default=0))
    anchored = [m + off for m, off in zip(mins, offsets) if off is not None]
    base = min(anchored) if anchored else 0
    for i, off in enumerate(offsets):
        if off is None:
            offsets[i] = base - mins[i]  # start-aligned fallback

    # worker → pid: keep the recording pid, remap collisions
    pids: List[int] = []
    used: set = set()
    for i, doc in enumerate(docs):
        pid = int(doc.get("pid", 0))
        while pid in used:
            pid += 100000
        used.add(pid)
        pids.append(pid)

    events: List[Dict[str, Any]] = []
    dropped: Dict[str, int] = {}
    for doc, label, pid, off in zip(docs, labels, pids, offsets):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": label}})
        names = list(doc.get("names", []))
        spans = doc.get("spans", {})
        span_args = doc.get("span_args", {})
        for row, (nid, t0, t1, tid, _depth) in enumerate(zip(
                spans.get("name", []), spans.get("t0_ns", []),
                spans.get("t1_ns", []), spans.get("tid", []),
                spans.get("depth", []))):
            name = names[nid]
            ev: Dict[str, Any] = {
                "ph": "X", "name": name, "cat": _cat_of(name), "pid": pid,
                "tid": int(tid), "ts": (t0 + off - base) / 1e3,
                "dur": (t1 - t0) / 1e3,
            }
            args = span_args.get(str(row))
            if args:
                ev["args"] = args
            events.append(ev)
        gauges = doc.get("gauges", {})
        for nid, t, v in zip(gauges.get("name", []),
                             gauges.get("t_ns", []),
                             gauges.get("value", [])):
            name = names[nid]
            events.append({"ph": "C", "name": name, "cat": _cat_of(name),
                           "pid": pid, "tid": 0,
                           "ts": (t + off - base) / 1e3,
                           "args": {"value": v}})
        if doc.get("dropped_spans"):
            dropped[label] = int(doc["dropped_spans"])

    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "stitched_from": {label: pid
                              for label, pid in zip(labels, pids)},
            "dropped_spans": dropped,
            "counters": rollup_counters(docs),
        },
        "traceEvents": events,
    }


def rollup_counters(docs: Sequence[Mapping[str, Any]]) -> Dict[str, float]:
    """Sum the plain tracer counters across artifacts."""
    out: Dict[str, float] = {}
    for doc in docs:
        for name, v in doc.get("counters", {}).items():
            out[name] = out.get(name, 0) + v
    return out


def rollup_metrics(docs: Sequence[Mapping[str, Any]]) -> MetricsRegistry:
    """Merge the ``metrics`` sections of artifacts into one registry —
    counters add, histograms merge bucket-exactly, gauges last-write-win
    in artifact order."""
    reg = MetricsRegistry()
    for doc in docs:
        reg.merge(MetricsRegistry.from_snapshot(doc.get("metrics", [])))
    return reg


def load_fleet_artifacts(fleet_root
                         ) -> Tuple[List[str], List[Dict[str, Any]]]:
    """Every worker obs artifact under ``<fleet_root>/obs/``, sorted by
    filename (labels are the file stems, e.g. ``obs_12345``)."""
    d = Path(fleet_root) / FLEET_OBS_DIR
    labels, docs = [], []
    if d.is_dir():
        for p in sorted(d.glob("*.json")):
            try:
                docs.append(load_artifact(p))
            except (ValueError, OSError):
                continue  # torn write or foreign file; skip, don't fail
            labels.append(p.stem)
    return labels, docs


def telemetry_anchors(fleet_root) -> Dict[int, Tuple[int, int]]:
    """Heartbeat fallback anchors ``{pid: (wall_ns, mono_ns)}`` from the
    fleet telemetry records (v2 records publish the pair)."""
    from repro_torch.fleet.telemetry import read_telemetry  # deferred

    out: Dict[int, Tuple[int, int]] = {}
    for rec in read_telemetry(fleet_root).get("workers", {}).values():
        pid, mono = rec.get("pid"), rec.get("anchor_mono_ns")
        wall = rec.get("updated_at")
        if pid is not None and mono is not None and wall is not None:
            out[int(pid)] = (int(float(wall) * 1e9), int(mono))
    return out


def stitch_fleet(fleet_root, out: Optional[Path] = None) -> Dict[str, Any]:
    """Stitch every worker artifact of a fleet run; returns a summary.

    Writes the stitched Chrome trace to ``out`` when given. The summary
    carries the validated event count, per-worker pids, and the rolled-up
    metric snapshot (exact bucket arithmetic across workers).
    """
    labels, docs = load_fleet_artifacts(fleet_root)
    if not docs:
        raise ValueError(f"no obs artifacts under "
                         f"{Path(fleet_root) / FLEET_OBS_DIR} — run the "
                         f"fleet with REPRO_OBS=1 REPRO_OBS_DIR set")
    chrome = stitch_traces(docs, labels,
                           anchors_by_pid=telemetry_anchors(fleet_root))
    n_events = validate_chrome_trace(chrome)
    if out is not None:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(chrome))
    reg = rollup_metrics(docs)
    return {
        "workers": chrome["otherData"]["stitched_from"],
        "n_artifacts": len(docs),
        "n_events": n_events,
        "counters": chrome["otherData"]["counters"],
        "metrics": reg.snapshot(),
        "chrome_trace": chrome,
    }
