"""Fleet coordinator: plan, status, reap, and the crash-safe merge (the
port of :mod:`repro.fleet.coordinator`: the same task names, the same
``spec.json``).

``plan`` turns a :class:`~repro_torch.sweeps.spec.SweepSpec` into the fleet's
on-disk layout::

    <fleet_root>/
        spec.json        # SweepSpec.to_json() — version-checked by workers
        queue/           # the lease queue (tasks/ leases/ done/)
        workers/<owner>/ # each worker's private SweepStore

One task is one (scenario, overrides, algo) group's slice of
``seeds_per_task`` seeds over the group's full resolved horizon — the
smallest unit the serving executor can compute (a seed's horizon is
atomic) that still expands to exactly the parent spec's item keys.
Seeds whose items are already complete in the target store are not
enqueued (fleet resume is seed-granular; the final ``run_sweep`` pass
stays item-granular).

``merge`` drains every worker store into the target
:class:`~repro_torch.sweeps.store.SweepStore`, chunk by chunk in deterministic
order (sorted worker names, manifest order). Items the target already
holds — from a previous merge, a partial single-process run, or a
*re-executed* chunk whose first executor was presumed dead but had
already appended — are **verified bit-for-bit** (float64 value and
metric bytes must match exactly; wall-clock ``times`` are measurements
and exempt) before being dropped as duplicates; any mismatch raises
:class:`FleetMergeConflict`, because two byte-different results for one
item hash mean the determinism contract broke (code skew between
workers, a corrupted store) and silently keeping either would poison
the aggregate.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.sweeps.spec import SweepSpec
from repro_torch.sweeps.store import SweepStore, atomic_write

from .queue import DEFAULT_TTL_S, LeaseQueue, Task
from .telemetry import DEFAULT_STALE_S, read_telemetry
from .worker import _QUEUE_DIR, _WORKERS_DIR, load_fleet_spec

__all__ = ["FleetMergeConflict", "plan", "status", "merge", "reap",
           "worker_stores"]


class FleetMergeConflict(ValueError):
    """Two byte-different stored results for the same item hash."""


def _chunked(seq: Sequence, n: int) -> List[Sequence]:
    n = max(int(n), 1)
    return [seq[i:i + n] for i in range(0, len(seq), n)]


def plan(spec: SweepSpec, fleet_root, *,
         target_store=None, seeds_per_task: int = 1) -> Dict[str, Any]:
    """Write the fleet layout and enqueue one task per pending seed slice.

    Idempotent: task names are pure content hashes of (scenario,
    overrides, algo, seed slice), so re-planning the same spec — even
    after some tasks completed and their seeds dropped out of the
    pending set — regenerates identical names and skips everything that
    already exists in any queue state. (With ``seeds_per_task > 1`` a
    partially completed grid can re-slice the *remaining* seeds into new
    combinations; the re-executed overlap is wasted, never wrong — the
    merge dedups bit-for-bit.) Planning a *different* spec into an
    existing fleet root is rejected (one fleet per spec — fingerprints
    must match).
    """
    fleet_root = Path(fleet_root)
    fleet_root.mkdir(parents=True, exist_ok=True)
    spec_path = fleet_root / "spec.json"
    doc = spec.to_json()
    have = None
    if spec_path.exists():
        try:
            have = json.loads(spec_path.read_text())
        except json.JSONDecodeError:
            have = None  # torn by a killed pre-atomic-write coordinator
    if have is not None and have.get("fingerprint") != doc["fingerprint"]:
        raise ValueError(
            f"fleet root {fleet_root} was planned for spec "
            f"{have.get('fingerprint')!r}, got {doc['fingerprint']!r} "
            f"— one fleet root serves one spec")
    if have is None:
        atomic_write(spec_path, json.dumps(doc, indent=1).encode())

    target = SweepStore(target_store) if target_store is not None else None
    # NB: no TTL here — lease TTL is a *worker* property (each worker
    # stamps and renews its own leases); the planner only enqueues
    queue = LeaseQueue(fleet_root / _QUEUE_DIR)

    n_tasks = n_items = n_skipped_items = skipped_tasks = 0
    for (scenario, overrides, algo), items in spec.groups():
        T = spec.ticks_for(scenario, overrides)
        by_seed: Dict[int, List] = {}
        for it in items:
            by_seed.setdefault(it.seed, []).append(it)
        pending_seeds = []
        for seed in spec.seeds:
            seed_items = by_seed.get(seed, [])
            done = target is not None and \
                all(it.key() in target for it in seed_items)
            if done:
                n_skipped_items += len(seed_items)
            else:
                pending_seeds.append(seed)
        for seeds in _chunked(pending_seeds, seeds_per_task):
            keys = tuple(it.key() for s in seeds for it in by_seed[s])
            # the name is a pure content hash — no running index, which
            # would shift when completed seeds drop out of pending and
            # re-enqueue surviving tasks under new names
            h = hashlib.sha256(json.dumps(
                [scenario, list(map(list, overrides)), algo, list(seeds)],
                separators=(",", ":")).encode()).hexdigest()[:16]
            task = Task(name=h, scenario=scenario,
                        overrides=overrides, algo=algo,
                        seeds=tuple(seeds), n_ticks=T, keys=keys)
            if queue.put(task):
                n_tasks += 1
                n_items += len(keys)
            else:
                skipped_tasks += 1
    return {"fleet_root": str(fleet_root), "n_tasks": n_tasks,
            "n_items": n_items, "skipped_tasks": skipped_tasks,
            "skipped_items": n_skipped_items,
            "fingerprint": doc["fingerprint"]}


def worker_stores(fleet_root) -> List[Path]:
    """Every worker store directory under the fleet root, sorted (the
    deterministic merge order)."""
    root = Path(fleet_root) / _WORKERS_DIR
    if not root.is_dir():
        return []
    return sorted(d for d in root.iterdir() if (d / "manifest.jsonl").exists()
                  or (d / "shards").is_dir())


def status(fleet_root, *, target_store=None,
           stale_s: float = DEFAULT_STALE_S) -> Dict[str, Any]:
    """Queue counts, per-worker completed items, target completeness —
    plus live throughput: ``remaining_items`` (summed over pending and
    leased task keys), per-worker ``telemetry`` records,
    ``rate_items_per_s`` (live workers only — telemetry fresher than
    ``stale_s``), and ``eta_s`` (remaining over rate, ``None`` when no
    worker is live)."""
    fleet_root = Path(fleet_root)
    queue = LeaseQueue(fleet_root / _QUEUE_DIR, create=False)
    out: Dict[str, Any] = {"queue": queue.status(), "workers": {}}
    for wdir in worker_stores(fleet_root):
        out["workers"][wdir.name] = len(SweepStore(wdir))
    remaining = 0
    for name in queue.pending() + queue.leased():
        task = queue.read_task(name)
        if task is not None:
            remaining += len(task.keys)
    out["remaining_items"] = remaining
    tele = read_telemetry(fleet_root, stale_s=stale_s)
    out["telemetry"] = tele["workers"]
    out["rate_items_per_s"] = tele["rate_items_per_s"]
    # Live-stream awareness: workers launched with REPRO_OBS_STREAM leave
    # one JSONL stream each under <root>/stream/ — `status --watch` and
    # the dashboard tail these instead of polling heartbeats.
    stream_dir = fleet_root / "stream"
    out["stream_files"] = sorted(
        p.name for p in stream_dir.glob("*.jsonl")) \
        if stream_dir.is_dir() else []
    out["eta_s"] = (round(remaining / out["rate_items_per_s"], 3)
                    if remaining and out["rate_items_per_s"] > 0 else None)
    try:
        spec = load_fleet_spec(fleet_root)
        out["n_spec_items"] = len(spec.expand())
    except ValueError:
        out["n_spec_items"] = None
    if target_store is not None:
        target = SweepStore(target_store)
        out["target_items"] = len(target)
        if out["n_spec_items"] is not None:
            spec = load_fleet_spec(fleet_root)
            out["target_missing"] = sum(
                1 for it in spec.expand() if it.key() not in target)
    return out


def reap(fleet_root, *, ttl: Optional[float] = None) -> List[str]:
    """Requeue expired leases; returns the requeued task names."""
    queue = LeaseQueue(Path(fleet_root) / _QUEUE_DIR,
                       ttl=ttl if ttl is not None else DEFAULT_TTL_S,
                       create=False)
    return queue.reap()


def _verify_duplicate(key: str, target: SweepStore,
                      data: Mapping[str, np.ndarray], row: int,
                      worker: str) -> None:
    """A duplicate item must match the target bit-for-bit (values and
    metrics; ``times`` are wall-clock measurements and exempt)."""
    mine = np.float64(data["values"][row])
    have = np.float64(target.value(key))
    conflicts = []
    if mine.tobytes() != have.tobytes():
        conflicts.append(f"value {have!r} != {mine!r}")
    have_metrics = target.metrics(key)
    for name, arr in data.items():
        if not name.startswith("metric_"):
            continue
        short = name[len("metric_"):]
        if short not in have_metrics:
            continue  # target row predates metrics; value check governs
        a = np.float64(have_metrics[short])
        b = np.float64(arr[row])
        # NaN is a legitimate stored metric (a tick that served nothing)
        # and NaN != NaN, so compare representations, not floats
        if a.tobytes() != b.tobytes():
            conflicts.append(f"metric {short} {a!r} != {b!r}")
    if conflicts:
        raise FleetMergeConflict(
            f"item {key} from worker store {worker!r} disagrees with the "
            f"target bit-for-bit: {'; '.join(conflicts)} — determinism "
            f"contract broken (code skew between workers?); refusing to "
            f"merge")


def merge(fleet_root, target_store, *, workers=None) -> Dict[str, Any]:
    """Merge every worker store into ``target_store``; returns stats.

    Dedup is by item hash; duplicate items are verified bit-for-bit
    before being dropped (see module docstring). New items are appended
    chunk-wise, preserving each chunk's meta plus a ``fleet_worker``
    provenance tag.
    """
    fleet_root = Path(fleet_root)
    target = SweepStore(target_store)
    try:
        spec = load_fleet_spec(fleet_root)
        target.write_spec(spec.to_json())
    except ValueError:
        spec = None
    stores = worker_stores(fleet_root)
    if spec is None and not stores:
        raise ValueError(f"no fleet at {fleet_root} (no spec.json, no "
                         f"worker stores) — nothing to merge")
    if workers is not None:
        want = set(workers)
        stores = [d for d in stores if d.name in want]
    merged = duplicates = 0
    for wdir in stores:
        wstore = SweepStore(wdir)
        for rec in wstore.chunks():
            keys = rec["keys"]
            data = wstore.chunk_data(rec["shard"])
            fresh = [i for i, k in enumerate(keys) if k not in target]
            for i, k in enumerate(keys):
                if i in fresh:
                    continue
                _verify_duplicate(k, target, data, i, wdir.name)
                duplicates += 1
            if not fresh:
                continue
            meta = dict(rec.get("meta", {}))
            meta["fleet_worker"] = wdir.name
            metrics = {name[len("metric_"):]: arr[fresh]
                       for name, arr in data.items()
                       if name.startswith("metric_")}
            target.add_chunk([keys[i] for i in fresh],
                             data["values"][fresh], data["times"][fresh],
                             meta=meta, metrics=metrics or None)
            merged += len(fresh)
    out = {"merged_items": merged, "duplicate_items": duplicates,
           "workers": [d.name for d in stores],
           "target_items": len(target)}
    if spec is not None:
        out["missing_items"] = sum(
            1 for it in spec.expand() if it.key() not in target)
    return out
