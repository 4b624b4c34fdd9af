"""Fit placer knobs from serving sweeps — the sweep-driven auto-tuner.

A ``kind="serving"`` sweep (:mod:`repro_torch.sweeps`) grids the
:class:`~repro_torch.core.dynamic.DynamicPlacer` knobs — ``switching_cost`` ×
``stickiness`` — per scenario and stores one *realized* mean-QoS value per
``(seed, tick)`` item. This module reduces such a store to a per-scenario
**lookup table** of recommended settings:

* :func:`read_serving_records` walks the (possibly partial) store via its
  manifest metadata — no spec reconstruction — and yields one record per
  stored item, labelled with scenario, explicit knob values, policy, seed;
* :func:`fit_table` groups records per scenario × (switching_cost,
  stickiness), and picks the knob pair that **maximizes mean realized
  QoS**, with a **95%-CI tie-break**: every grid point whose upper
  confidence bound reaches the best mean is statistically
  indistinguishable from the winner, and among those the *smallest*
  knob pair wins (switching cost is realized cold-start latency — never
  pay real stalls for CI noise; knob pairs are unique, so the pick is
  fully deterministic);
* :func:`save_table` / :func:`load_table` serialize the result as a
  versioned JSON document (``table_version`` + the sweep engine's schema
  version), shipped under ``src/repro_torch/tuning/tables/``;
* :func:`recommend` is the runtime face: ``HorizonConfig.from_overrides``
  consults it for any knob the caller left unset, so sweep rows and CLI
  runs that don't pin the knobs get the fitted per-scenario settings
  instead of one-size-fits-all defaults.

The shipped ``tables/default.json`` is a byte copy of the reference's
(``src/repro/tuning/tables/default.json``, fitted there from a small
serving sweep): the table decides the knobs baked into serving item keys,
so the two packages give equal keys only while the two files are equal.
Like any code change, refreshing it changes the values of runs that rely
on the recommendation (runs that pin their knobs are unaffected).
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.sweeps.aggregate import basic_stats
from repro_torch.sweeps.spec import SCHEMA_VERSION
from repro_torch.sweeps.store import SweepStore

__all__ = [
    "TABLE_VERSION",
    "DEFAULT_TABLE_PATH",
    "TABLE_ENV_VAR",
    "ServingRecord",
    "read_serving_records",
    "fit_table",
    "save_table",
    "load_table",
    "recommend",
]

#: Bump when the table document layout changes (loader rejects mismatches).
TABLE_VERSION = 1

#: The packaged lookup table consulted by :func:`recommend`.
DEFAULT_TABLE_PATH = Path(__file__).resolve().parent / "tables" / \
    "default.json"

#: Point :func:`recommend` at a different table without touching code
#: (the reference's variable: one setting moves both packages' keys alike).
TABLE_ENV_VAR = "REPRO_TUNING_TABLE"



@dataclasses.dataclass(frozen=True)
class ServingRecord:
    """One stored serving item, labelled with its grid coordinates."""

    scenario: str
    switching_cost: float
    stickiness: float
    policy: str
    seed: int
    value: float               # per-(seed, tick) mean realized QoS
    overrides: Tuple[Tuple[str, Any], ...] = ()   # full stored override set
    horizon: int = 0           # run's tick count (0: unknown, older store)
    key: str = ""              # the item's store key (metrics lookup)


def read_serving_records(store: "SweepStore | os.PathLike | str"
                         ) -> List[ServingRecord]:
    """Every serving item in the store whose grid point pins *both* knobs.

    Items whose overrides leave a knob unset are skipped: their realized
    values depend on whatever default (or previously shipped table) was in
    effect when they were computed, so they are not attributable to a grid
    point. Raises ``ValueError`` if the store holds no serving items at
    all (e.g. a sigma store was passed by mistake).
    """
    if not isinstance(store, SweepStore):
        store = SweepStore(store)
    records: List[ServingRecord] = []
    n_serving = 0
    for key in store.keys():
        meta = store.meta(key)
        if meta.get("executor") != "serving":
            continue
        n_serving += 1
        ov = dict(meta.get("overrides", {}))
        if "switching_cost" not in ov or "stickiness" not in ov:
            continue
        records.append(ServingRecord(
            scenario=str(meta["scenario"]),
            switching_cost=float(ov["switching_cost"]),
            stickiness=float(ov["stickiness"]),
            policy=str(meta["algo"]),
            seed=int(meta.get("seed", -1)),
            value=store.value(key),
            overrides=tuple(sorted(ov.items())),
            horizon=int(meta.get("horizon", 0)),
            key=key,
        ))
    if n_serving == 0:
        raise ValueError(
            f"store {store.root} holds no kind='serving' items — the "
            f"auto-tuner fits from realized-QoS serving sweeps "
            f"(python -m repro_torch.sweeps --kind serving ...)")
    return records


def fit_table(store: "SweepStore | os.PathLike | str", *,
              policy: str = "edf",
              source: Optional[str] = None) -> Dict[str, Any]:
    """Reduce a serving store to a per-scenario recommended-knob table.

    ``policy`` selects which queue policy's realized values the fit uses
    (default the QoS-aware ``edf``); scenarios where that policy was not
    swept fall back to pooling every stored policy. Selection per
    scenario: highest mean realized QoS, 95%-CI tie-break (see module
    docstring).
    """
    records = read_serving_records(store)
    if not records:
        raise ValueError(
            "no serving items with explicit (switching_cost, stickiness) "
            "overrides — sweep the knobs as grid axes, e.g. "
            "--override switching_cost=0 --override switching_cost=2 "
            "--override stickiness=0 --override stickiness=3")

    by_scenario: Dict[str, List[ServingRecord]] = {}
    for r in records:
        by_scenario.setdefault(r.scenario, []).append(r)

    scenarios: Dict[str, Dict[str, Any]] = {}
    for scenario in sorted(by_scenario):
        recs = by_scenario[scenario]
        policies = {r.policy for r in recs}
        fit_policy = policy if policy in policies else None
        if fit_policy is not None:
            recs = [r for r in recs if r.policy == fit_policy]
        cells: Dict[Tuple[float, float], List[float]] = {}
        for r in recs:
            cells.setdefault((r.switching_cost, r.stickiness),
                             []).append(r.value)
        stats = {knobs: basic_stats(vals) for knobs, vals in cells.items()}
        # all-NaN cells (a horizon that served nothing) carry no signal
        stats = {k: s for k, s in stats.items() if s["n"] > 0}
        if not stats:
            raise ValueError(
                f"scenario {scenario!r}: every stored realized-QoS value "
                f"is NaN (no grid point served any request) — nothing to "
                f"fit; check the scenario/load overrides of the sweep")
        best_mean = max(s["mean"] for s in stats.values())
        # 95%-CI tie-break: among the candidates statistically
        # indistinguishable from the best, the smallest (switching_cost,
        # stickiness) pair wins — switching_cost is also the engine's
        # realized cold-start latency, so a recommendation must not pay
        # real stalls for CI noise. Knob pairs are unique per cell, so no
        # further criterion is needed (fully deterministic).
        cand = [k for k, s in stats.items()
                if s["mean"] + s["ci95"] >= best_mean]
        pick = min(cand)
        s = stats[pick]
        scenarios[scenario] = {
            "switching_cost": pick[0],
            "stickiness": pick[1],
            "policy": fit_policy or "pooled:" + ",".join(sorted(policies)),
            "mean_qos": round(s["mean"], 6),
            "ci95": round(s["ci95"], 6),
            "n": s["n"],
            "grid_points": len(cells),
        }

    root = store.root if isinstance(store, SweepStore) else Path(store)
    return {
        "table_version": TABLE_VERSION,
        "sweep_schema_version": SCHEMA_VERSION,
        "source": source or str(root),
        "scenarios": scenarios,
    }


# ===========================================================================
# Serialization + the runtime lookup
# ===========================================================================

def save_table(table: Mapping[str, Any], path: "os.PathLike | str") -> Path:
    """Write the table JSON (stable key order) and drop the load cache."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    _TABLE_CACHE.clear()
    return path


#: resolved path -> (mtime_ns, parsed table) — recommend() runs on the
#: serving hot path (every HorizonConfig.from_overrides), so the JSON is
#: parsed once per file version, not once per call.
_TABLE_CACHE: Dict[str, Tuple[int, Optional[Dict[str, Any]]]] = {}


def load_table(path: "os.PathLike | str | None" = None
               ) -> Optional[Dict[str, Any]]:
    """Load a lookup table; None when absent (callers fall back to
    defaults). Resolution: explicit ``path`` → ``$REPRO_TUNING_TABLE`` →
    the packaged :data:`DEFAULT_TABLE_PATH`."""
    if path is None:
        path = os.environ.get(TABLE_ENV_VAR) or DEFAULT_TABLE_PATH
    path = Path(path)
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return None
    cached = _TABLE_CACHE.get(str(path))
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        table = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        table = None
    if table is not None and table.get("table_version") != TABLE_VERSION:
        table = None   # future/foreign layout: ignore, don't crash serving
    _TABLE_CACHE[str(path)] = (mtime, table)
    return table


def recommend(scenario: str, *,
              table: Optional[Mapping[str, Any]] = None,
              path: "os.PathLike | str | None" = None
              ) -> Optional[Dict[str, float]]:
    """Fitted ``{"switching_cost": ..., "stickiness": ...}`` for a
    scenario, or None when no table (or no row) exists. This is what
    ``HorizonConfig.from_overrides`` consults for knobs the caller left
    unset; explicit overrides always win."""
    if table is None:
        table = load_table(path)
    if not table:
        return None
    row = table.get("scenarios", {}).get(scenario)
    if not row:
        return None
    return {"switching_cost": float(row["switching_cost"]),
            "stickiness": float(row["stickiness"])}
