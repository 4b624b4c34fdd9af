"""Sweep-driven Pareto frontiers — the accuracy/latency trade-off view
(the port of :mod:`repro.tuning.pareto`).

The paper's core premise is that every service ships *multiple
implementations* trading accuracy against latency; Hosseinzadeh et al.
(arXiv:2011.08381) make the same trade-off explicit as accuracy/time
Pareto frontiers. This module extracts those frontiers from a
``kind="serving"`` sweep store: every stored grid point — a
``(switching_cost, stickiness, policy)`` operating point of one scenario —
becomes a point in two metric planes,

* **(realized QoS ↑, deadline-miss-rate ↓)** — the serving-quality plane;
* **(mean served accuracy ↑, mean realized latency ↓)** — the
  accuracy/time plane of the multi-implementation trade-off;

and the non-dominated set in each plane is the menu an operator actually
chooses from.

The dominance check itself is a batched ``O(N²·M)`` tensor comparison:

* :func:`pareto_mask_np` — NumPy float64 reference (the reference's,
  copied);
* :func:`pareto_mask_torch` — the same computation in PyTorch on a CUDA
  device (the reference's ``pareto_mask_jax``), fully batched over the
  grid (one ``[N, N, M]`` comparison tensor, no Python loop), so frontier
  extraction over large sweep grids runs on the card next to the sweep
  itself. The two paths agree exactly on the same inputs, in float32 and
  float64 (pure comparisons — no floating-point accumulation to
  reassociate).

Point metrics beyond the stored mean QoS (miss rate, latency, served
accuracy) come **straight from the store**: schema-v3 serving sweeps
persist per-item ``submitted``/``served``/``misses``/``latency``/
``accuracy`` arrays at sweep time (see
:data:`repro_torch.sweeps.shard.SERVING_METRIC_NAMES`), and
:func:`frontier_points` reconstructs the horizon-level metrics from them
as a pure store read — zero horizon replays. Only *legacy* stores
(written before schema v3, or with partially stored seeds) fall back to
replaying each grid point's horizon — ``run_horizon`` is a pure function
of ``(config, seed)``, so the replay is byte-identical to the run that
filled the store.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.horizon import (HorizonConfig, run_horizon,
                                   split_serving_overrides)
from repro_torch.sweeps.store import SweepStore

from .fit import ServingRecord, read_serving_records

__all__ = [
    "pareto_mask_np",
    "pareto_mask_torch",
    "FrontierPoint",
    "frontier_points",
    "frontier_rows",
]


# ===========================================================================
# Dominance check — NumPy reference + batched device path
# ===========================================================================

def _signs(maximize: Sequence[bool], m: int) -> np.ndarray:
    maximize = list(maximize)
    if len(maximize) != m:
        raise ValueError(f"maximize has {len(maximize)} entries for "
                         f"{m} metric column(s)")
    return np.where(np.asarray(maximize, bool), 1.0, -1.0)


def pareto_mask_np(points: np.ndarray,
                   maximize: Sequence[bool]) -> np.ndarray:
    """[N] bool keep-mask of the non-dominated points (NumPy reference).

    ``points`` is ``[N, M]``; ``maximize[j]`` orients metric column ``j``
    (False = smaller is better). Point *i* is dominated iff some *j* is at
    least as good on every metric and strictly better on one; duplicates
    never dominate each other, so tied optima are all kept.
    """
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2:
        raise ValueError(f"points must be [N, M], got shape {pts.shape}")
    if pts.shape[0] == 0:
        return np.zeros(0, bool)
    s = pts * _signs(maximize, pts.shape[1])[None, :]
    ge = (s[None, :, :] >= s[:, None, :]).all(-1)   # [i, j]: j ≥ i everywhere
    gt = (s[None, :, :] > s[:, None, :]).any(-1)    # [i, j]: j > i somewhere
    return ~(ge & gt).any(axis=1)


def pareto_mask_torch(points, maximize: Sequence[bool],
                      device=None) -> np.ndarray:
    """The on-device twin of :func:`pareto_mask_np` (the port of the
    reference's ``pareto_mask_jax``): one batched ``[N, N, M]`` comparison
    on ``device`` (``None`` means CUDA, which raises without a card;
    ``"cpu"`` runs it on the host). Returns a NumPy bool [N] for drop-in
    parity with the reference path.

    It compares in the points' own floating dtype, float64 included: a
    cast to float32 could merge points that differ below float32
    resolution and disagree with the reference mask. Integer points are
    compared in float64, as :func:`pareto_mask_np` does.
    """
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    pts = points if isinstance(points, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(points))
    if pts.ndim != 2:
        raise ValueError(f"points must be [N, M], got shape "
                         f"{tuple(pts.shape)}")
    if not pts.is_floating_point():
        pts = pts.to(torch.float64)
    if pts.shape[0] == 0:
        return np.zeros(0, bool)
    sign = torch.from_numpy(_signs(maximize, pts.shape[1]))
    # orientation by sign flip, applied on the device in the input dtype
    # (exact), so the comparisons see exactly the reference path's values
    signed = pts.to(dev) * sign.to(dev, pts.dtype)[None, :]
    ge = (signed[None, :, :] >= signed[:, None, :]).all(-1)
    gt = (signed[None, :, :] > signed[:, None, :]).any(-1)
    return (~(ge & gt).any(dim=1)).cpu().numpy()


# ===========================================================================
# Frontier extraction from a serving store
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One (scenario, knob, policy) operating point with replay metrics."""

    scenario: str
    switching_cost: float
    stickiness: float
    policy: str
    n_seeds: int
    mean_qos: float          # mean realized QoS (over seeds)
    miss_rate: float         # deadline-miss rate (over seeds)
    mean_latency_s: float    # mean realized latency of served requests
    mean_accuracy: float     # mean A_sm of the implementations that served
    qos_frontier: bool = False      # non-dominated in (QoS ↑, miss ↓)
    acc_lat_frontier: bool = False  # non-dominated in (acc ↑, latency ↓)


#: Per-item metric names a schema-v3 cell must hold for the pure-store
#: path; anything less falls back to horizon replay.
_REQUIRED_METRICS = frozenset(
    {"submitted", "served", "misses", "latency", "accuracy"})


def _seed_reduce(qos, miss, lat, acc) -> Dict[str, float]:
    """Per-seed metric lists → the cell's FrontierPoint metric dict."""
    return {"mean_qos": float(np.mean(qos)),
            "miss_rate": float(np.mean(miss)),
            "mean_latency_s": float(np.mean(lat)) if lat else float("nan"),
            "mean_accuracy": float(np.mean(acc)) if acc else float("nan")}


def _accumulate_seed(a: Dict[str, np.ndarray],
                     qos: list, miss: list, lat: list, acc: list) -> None:
    """Fold one seed's per-tick arrays into the per-seed metric lists.

    The *single* reduction both metric sources share: the store path feeds
    it the persisted per-item arrays, the replay path feeds it the same
    numbers straight from the ``TickReport``\\ s — so the two paths are
    bit-identical, and frontier flags never flip between them on exact
    metric ties. Per seed: submission-weighted mean QoS, misses over
    served, and served-weighted latency/accuracy means over the ticks
    that served anything (a seed that served nothing contributes to
    QoS/miss but not to latency/accuracy).
    """
    n_sub, n_served = a["submitted"].sum(), a["served"].sum()
    qos.append(float((a["values"] * a["submitted"]).sum() / n_sub)
               if n_sub else 0.0)
    miss.append(float(a["misses"].sum() / n_served) if n_served else 0.0)
    if n_served:
        hot = a["served"] > 0  # ticks that served nothing carry NaN means
        lat.append(float((a["latency"][hot] * a["served"][hot]).sum()
                         / n_served))
        acc.append(float((a["accuracy"][hot] * a["served"][hot]).sum()
                         / n_served))


def _replay_metrics(scenario: str, overrides: Tuple[Tuple[str, Any], ...],
                    policy: str, seeds: Sequence[int],
                    n_ticks: int) -> Dict[str, float]:
    """Legacy fallback: replay each seed's horizon for the metrics a
    pre-v3 store does not hold, reduced through the same arithmetic as
    the store path (replay is byte-identical to the original run, so the
    two paths agree bit-for-bit on complete stores)."""
    qos, miss, lat, acc = [], [], [], []
    for seed in seeds:
        cfg = HorizonConfig.from_overrides(scenario, dict(overrides), policy,
                                           seed, n_ticks=n_ticks)
        res = run_horizon(cfg)
        pt = res.per_tick
        _accumulate_seed({
            "values": res.tick_values(),
            "submitted": np.array([t.submitted for t in pt], np.float64),
            "served": np.array([t.served for t in pt], np.float64),
            "misses": np.array([t.deadline_misses for t in pt], np.float64),
            "latency": np.array([t.mean_latency_s for t in pt], np.float64),
            "accuracy": np.array([t.mean_accuracy for t in pt], np.float64),
        }, qos, miss, lat, acc)
    return _seed_reduce(qos, miss, lat, acc)


def _store_metrics(store: SweepStore, records: Sequence[ServingRecord],
                   n_ticks: int) -> Optional[Dict[str, float]]:
    """Horizon-level metrics reconstructed purely from stored per-item
    arrays — or None when the cell cannot support it (pre-v3 chunks
    without metrics, unknown horizon, or a seed with missing ticks) and
    the caller must replay.

    Mirrors :func:`_replay_metrics` exactly: per seed, mean QoS is the
    submission-weighted mean of per-tick values, miss rate is total
    misses over total served, and latency/accuracy are served-weighted
    means over the ticks that served anything (seeds that served nothing
    contribute to QoS/miss but not to latency/accuracy, like a replay
    with an empty ``res.requests``).
    """
    if n_ticks <= 0:
        return None
    by_seed: Dict[int, List[ServingRecord]] = {}
    for r in records:
        by_seed.setdefault(r.seed, []).append(r)
    qos, miss, lat, acc = [], [], [], []
    for seed in sorted(by_seed):
        recs = by_seed[seed]
        if len(recs) != n_ticks:
            return None  # partially stored seed: not reconstructible
        a = {name: np.zeros(len(recs))
             for name in ("values", "submitted", "served", "misses",
                          "latency", "accuracy")}
        for i, r in enumerate(recs):
            if not r.key:
                return None
            m = store.metrics(r.key)
            if not _REQUIRED_METRICS <= m.keys():
                return None  # legacy chunk without per-item metrics
            a["values"][i] = r.value
            for name in _REQUIRED_METRICS:
                a[name][i] = m[name]
        _accumulate_seed(a, qos, miss, lat, acc)
    return _seed_reduce(qos, miss, lat, acc)


def _resolve_horizon(store_root: Path, scenario: str,
                     overrides: Tuple[Tuple[str, Any], ...]) -> int:
    """Tick count for stores whose chunk meta predates the ``horizon``
    field: the stored spec's ``n_ticks``, else the scenario default."""
    try:
        spec = json.loads((store_root / "spec.json").read_text())
        if spec.get("n_ticks"):
            return int(spec["n_ticks"])
    except (OSError, json.JSONDecodeError):
        pass
    from repro_torch.workloads import get_scenario
    scen_ov, _ = split_serving_overrides(dict(overrides))
    return int(get_scenario(scenario, **scen_ov).n_ticks)


def frontier_points(store: "SweepStore | str", *,
                    scenarios: Optional[Sequence[str]] = None,
                    use_device: bool = False, device=None
                    ) -> Dict[str, List[FrontierPoint]]:
    """Per-scenario operating points with both frontier flags set.

    Walks every stored serving grid point (explicit knobs), reconstructs
    its miss-rate/latency/accuracy metrics **from the stored per-item
    metric arrays** (schema v3 — a pure store read, zero horizon
    replays), and marks non-domination in the (QoS, miss-rate) and
    (accuracy, latency) planes — ``use_device=True`` routes the dominance
    check through :func:`pareto_mask_torch` on ``device`` (``None`` means
    CUDA), the reference's ``use_jax=True``. Cells a legacy (pre-v3)
    store cannot reconstruct fall back to deterministic horizon replay.
    """
    if use_device:
        from repro_torch.device import resolve_device

        device = resolve_device(device)   # no card: raise before any work

        def mask_fn(plane, maximize):
            return pareto_mask_torch(plane, maximize, device=device)
    else:
        mask_fn = pareto_mask_np
    if not isinstance(store, SweepStore):
        store = SweepStore(store)
    records = read_serving_records(store)

    #: (scenario, overrides, policy) -> that cell's records
    cells: Dict[Tuple[str, Tuple, str], List[ServingRecord]] = {}
    for r in records:
        if scenarios is not None and r.scenario not in scenarios:
            continue
        cells.setdefault((r.scenario, r.overrides, r.policy), []).append(r)

    out: Dict[str, List[FrontierPoint]] = {}
    for (scenario, overrides, policy), recs in sorted(
            cells.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])):
        T = max(r.horizon for r in recs) or \
            _resolve_horizon(Path(store.root), scenario, overrides)
        seeds = sorted({r.seed for r in recs})
        m = _store_metrics(store, recs, T)
        if m is None:  # legacy store without per-item metrics
            m = _replay_metrics(scenario, overrides, policy, seeds, T)
        out.setdefault(scenario, []).append(FrontierPoint(
            scenario=scenario, switching_cost=recs[0].switching_cost,
            stickiness=recs[0].stickiness, policy=policy,
            n_seeds=len(seeds), **m))

    def _keep(plane: np.ndarray) -> np.ndarray:
        # a point with NaN metrics (a grid point that served nothing) is
        # not an operating point: NaN comparisons are all-False, so it
        # could never be dominated and would fraudulently star itself —
        # exclude it from the plane and never flag it
        keep = np.zeros(plane.shape[0], bool)
        finite = ~np.isnan(plane).any(axis=1)
        if finite.any():
            keep[finite] = mask_fn(plane[finite], maximize=(True, False))
        return keep

    for scenario, pts in out.items():
        qos_keep = _keep(np.array([[p.mean_qos, p.miss_rate]
                                   for p in pts]))
        acc_keep = _keep(np.array([[p.mean_accuracy, p.mean_latency_s]
                                   for p in pts]))
        out[scenario] = [
            dataclasses.replace(p, qos_frontier=bool(qk),
                                acc_lat_frontier=bool(ak))
            for p, qk, ak in zip(pts, qos_keep, acc_keep)]
    return out


def frontier_rows(frontiers: Dict[str, List[FrontierPoint]]
                  ) -> Dict[str, List[Dict[str, Any]]]:
    """Plain-dict view of :func:`frontier_points` output — the shape
    :func:`repro_torch.sweeps.aggregate.frontier_table` renders."""
    return {scenario: [dataclasses.asdict(p) for p in pts]
            for scenario, pts in frontiers.items()}
