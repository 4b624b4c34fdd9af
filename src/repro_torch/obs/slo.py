"""Declarative SLOs over live telemetry + the benchmark regression gate
(the port of :mod:`repro.obs.slo`: the same selectors, defaults, spec
file schema and verdicts, so either package judges the other's streams).

The paper's objective (Eq. 1) is a QoS target; this module makes targets
*explicit and enforceable*: an :class:`SLO` declares a bound on a metric
(deadline-miss rate, p99 latency, queue depth, obs overhead), and
:func:`evaluate_slos` checks it over a sliding window of live stream
frames (:mod:`repro_torch.obs.stream`), a saved metrics snapshot, or a
benchmark ``--json`` document (``{"rows": [...]}``) — emitting a **burn
rate** (the fraction of the error budget the observed value consumes;
> 1 means the SLO is burning) rather than a bare pass/fail, so dashboards
can show *how close* the system is running to its bounds.

Metric selectors (the ``metric`` field):

- ``tick.<field>`` — a field of ``tick`` stream frames (``miss_rate``,
  ``queue_depth``, ``window_qos``, ...), aggregated over the sliding
  ``window_s`` by ``agg`` (mean/max/min/last);
- ``gateway.<field>`` — same windowed aggregation over ``gateway``
  frames (the live control plane's per-tick operational stats:
  ``ingress_depth``, ``loop_lag_ms``, ``admitted``, ...);
- ``hist.<name>.<pXX|mean|count>`` — a digest of the named histogram,
  merged across label sets, from a ``metrics`` frame or snapshot records;
- ``counter.<name>`` — a tracer counter value;
- ``bench.<row>.<field>`` — a field of a benchmark row (``bench.
  obs_overhead.disabled_pct`` is the obs-overhead budget gate).

The second half is the regression gate: :func:`compare_bench` diffs two
benchmark ``--json`` documents row by row — quality fields (ratios, QoS,
miss rates; anything not timing-suffixed) within ``atol + rtol·|base|``,
timings within a ``max_slowdown`` factor — so a committed baseline closes
the regression loop over the accuracy/latency trade-off axis
(arXiv:2011.08381).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from .metrics import Histogram

__all__ = [
    "SLO_SCHEMA_VERSION",
    "SLO",
    "SLOReport",
    "DEFAULT_SLOS",
    "load_slos",
    "evaluate_slos",
    "compare_bench",
]

#: Version stamp of the SLO spec file format.
SLO_SCHEMA_VERSION = 1

#: Field-name suffixes treated as machine-dependent timings/throughputs in
#: :func:`compare_bench` — bounded by ``max_slowdown``, never by the tight
#: quality tolerance. Everything else in a row's ``fields`` is a quality
#: number (ratio, QoS, count) and must reproduce within tolerance.
TIMING_SUFFIXES = ("_us", "_ns", "_ms", "_per_s", "_pct")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective: a bound on a metric over a window."""

    name: str
    metric: str
    max_value: Optional[float] = None
    min_value: Optional[float] = None
    #: sliding window (seconds of frame wall time) for ``tick.*`` metrics
    window_s: float = 60.0
    #: aggregation over windowed samples: mean / max / min / last
    agg: str = "mean"

    def __post_init__(self):
        if (self.max_value is None) == (self.min_value is None):
            raise ValueError(f"SLO {self.name!r}: exactly one of "
                             f"max_value/min_value must be set")
        if self.agg not in ("mean", "max", "min", "last"):
            raise ValueError(f"SLO {self.name!r}: unknown agg {self.agg!r}")

    def to_json(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass
class SLOReport:
    """One evaluated SLO: observed value, verdict, burn rate."""

    slo: SLO
    value: float          # NaN when the metric had no samples
    n_samples: int
    ok: bool              # vacuously True on no data (reported as n=0)
    #: budget consumption: observed/bound for max-SLOs, bound/observed
    #: for min-SLOs — 1.0 is exactly at the objective, > 1 is violating
    burn_rate: float

    def line(self) -> str:
        state = "OK " if self.ok else "FAIL"
        val = "n/a" if math.isnan(self.value) else f"{self.value:.4g}"
        bound = (f"<= {self.slo.max_value:g}"
                 if self.slo.max_value is not None
                 else f">= {self.slo.min_value:g}")
        burn = "" if math.isnan(self.burn_rate) \
            else f"  burn {self.burn_rate:.2f}"
        return (f"[{state}] {self.slo.name:<24} {self.slo.metric:<32} "
                f"{val:>10} {bound:>12}{burn}  (n={self.n_samples})")


#: The serving defaults: explicit versions of what the README promises.
DEFAULT_SLOS = (
    SLO("deadline-miss-rate", "tick.miss_rate", max_value=0.75),
    SLO("queue-depth", "tick.queue_depth", max_value=4096, agg="max"),
    SLO("p99-latency", "hist.serving.latency_s.p99", max_value=30.0),
    SLO("obs-overhead", "bench.obs_overhead.disabled_pct", max_value=3.0),
    # Sparse-placement guarantees: the top-k candidate path must match the
    # float64 host evaluator on paper-scale instances, and the candidate
    # representation must actually buy its claimed memory headroom.
    SLO("placement-parity", "bench.placement_scale.rel_diff_paper",
        max_value=1e-4),
    SLO("placement-mem-ratio", "bench.placement_scale.mem_ratio_u1k",
        min_value=10.0),
    # Live control plane (the gateway): the event loop must hit its
    # tick deadlines, requests must clear ingest promptly, and the
    # ingress queue must stay bounded. Histogram selectors read the
    # gateway's periodic ``metrics`` frames; the depth bound reads the
    # per-tick ``gateway`` frames. All three are vacuously ok (n=0)
    # when no gateway is running.
    SLO("gateway-loop-lag-p99", "hist.gateway.loop_lag_ms.p99",
        max_value=250.0),
    SLO("gateway-admission-p99", "hist.gateway.admission_ms.p99",
        max_value=500.0),
    SLO("gateway-ingress-depth", "gateway.ingress_depth",
        max_value=4096, agg="max"),
)


def load_slos(path) -> List[SLO]:
    """Load a versioned SLO spec file: ``{"slo_schema": 1, "slos": [...]}``."""
    doc = json.loads(Path(path).read_text())
    have = int(doc.get("slo_schema", -1))
    if have != SLO_SCHEMA_VERSION:
        raise ValueError(f"{path}: slo spec schema v{have}, this code "
                         f"reads v{SLO_SCHEMA_VERSION}")
    return [SLO(**spec) for spec in doc.get("slos", [])]


def _windowed(frames: Sequence[Mapping[str, Any]], field: str,
              window_s: float, type_: str = "tick") -> List[float]:
    ticks = [f for f in frames if f.get("type") == type_
             and field in f.get("payload", {})]
    if not ticks:
        return []
    latest = max(float(f.get("t", 0.0)) for f in ticks)
    out = []
    for f in ticks:
        if latest - float(f.get("t", 0.0)) <= window_s:
            v = f["payload"][field]
            if v is not None and not (isinstance(v, float) and math.isnan(v)):
                out.append(float(v))
    return out


def _merged_histogram(metrics_records: Iterable[Mapping[str, Any]],
                      name: str) -> Optional[Histogram]:
    merged: Optional[Histogram] = None
    for rec in metrics_records:
        if rec.get("kind") != "histogram" or rec.get("name") != name:
            continue
        h = Histogram.from_record(rec)
        merged = h if merged is None else merged.merge(h)
    return merged


def _latest_metrics(frames: Sequence[Mapping[str, Any]]
                    ) -> Mapping[str, Any]:
    for f in reversed(frames):
        if f.get("type") == "metrics":
            return f.get("payload", {})
    return {}


def _resolve(slo: SLO, frames: Sequence[Mapping[str, Any]],
             metrics: Iterable[Mapping[str, Any]],
             counters: Mapping[str, float],
             bench: Optional[Mapping[str, Any]]
             ) -> tuple:
    """(value, n_samples) for one SLO against the supplied sources."""
    metric = slo.metric
    for prefix in ("tick.", "gateway."):
        if metric.startswith(prefix):
            samples = _windowed(frames, metric[len(prefix):],
                                slo.window_s, type_=prefix[:-1])
            if not samples:
                return float("nan"), 0
            agg = {"mean": lambda s: sum(s) / len(s), "max": max,
                   "min": min, "last": lambda s: s[-1]}[slo.agg]
            return float(agg(samples)), len(samples)
    if metric.startswith("hist."):
        name, _, digest = metric[len("hist."):].rpartition(".")
        h = _merged_histogram(metrics, name)
        if h is None or h.count == 0:
            return float("nan"), 0
        if digest.startswith("p"):
            return h.quantile(int(digest[1:]) / 100.0), h.count
        return float(getattr(h, digest)), h.count
    if metric.startswith("counter."):
        name = metric[len("counter."):]
        if name not in counters:
            return float("nan"), 0
        return float(counters[name]), 1
    if metric.startswith("bench."):
        if bench is None:
            return float("nan"), 0
        row_name, _, field = metric[len("bench."):].rpartition(".")
        for row in bench.get("rows", []):
            if row.get("name") == row_name:
                v = row["fields"].get(field) if field != "us_per_call" \
                    else row.get("us_per_call")
                if isinstance(v, (int, float)):
                    return float(v), 1
                return float("nan"), 0
        return float("nan"), 0
    raise ValueError(f"SLO {slo.name!r}: unknown metric selector "
                     f"{metric!r}")


def evaluate_slos(slos: Iterable[SLO], *,
                  frames: Sequence[Mapping[str, Any]] = (),
                  metrics: Optional[Iterable[Mapping[str, Any]]] = None,
                  counters: Optional[Mapping[str, float]] = None,
                  bench: Optional[Mapping[str, Any]] = None
                  ) -> List[SLOReport]:
    """Evaluate SLOs against stream frames / metric records / bench JSON.

    When ``metrics``/``counters`` aren't passed explicitly they are taken
    from the latest ``metrics`` frame in ``frames`` — the live-stream
    path. An SLO whose metric has no data reports ``n_samples == 0`` and
    stays ``ok`` (absence of traffic is not a violation; the dashboard
    shows the n=0 so it is never silent).
    """
    frames = list(frames)
    latest = _latest_metrics(frames)
    metric_records = list(metrics) if metrics is not None \
        else list(latest.get("metrics", []))
    counter_map = dict(counters) if counters is not None \
        else dict(latest.get("counters", {}))
    out: List[SLOReport] = []
    for slo in slos:
        value, n = _resolve(slo, frames, metric_records, counter_map,
                            bench)
        if n == 0 or math.isnan(value):
            out.append(SLOReport(slo, float("nan"), 0, True, float("nan")))
            continue
        if slo.max_value is not None:
            ok = value <= slo.max_value
            burn = value / slo.max_value if slo.max_value != 0 \
                else math.inf * (1 if value > 0 else 0)
        else:
            ok = value >= slo.min_value
            burn = slo.min_value / value if value != 0 else math.inf
        out.append(SLOReport(slo, value, n, bool(ok), float(burn)))
    return out


# ===========================================================================
# Benchmark regression gate
# ===========================================================================

def _is_timing_field(name: str) -> bool:
    return name.endswith(TIMING_SUFFIXES)


def compare_bench(new: Mapping[str, Any], base: Mapping[str, Any], *,
                  max_slowdown: float = 4.0, rtol: float = 0.12,
                  atol: float = 0.02,
                  rows: Optional[Iterable[str]] = None) -> Dict[str, Any]:
    """Diff two benchmark ``--json`` documents row by row.

    For every row name present in both documents (restricted to ``rows``
    when given): ``us_per_call`` and timing-suffixed fields may not exceed
    ``max_slowdown ×`` the baseline (machine variance is expected; an
    order-of-magnitude cliff is not); every other shared numeric field is
    a quality number and must satisfy ``|new − base| ≤ atol + rtol·|base|``
    in *both* directions — a "better" ratio that moved outside tolerance
    still fails, because it means the benchmark no longer measures the
    same thing. Returns ``{"violations": [...], "rows_checked": [...],
    "fields_checked": n}``; an empty violation list is a pass.
    """
    want = set(rows) if rows is not None else None
    base_rows = {r["name"]: r for r in base.get("rows", [])}
    violations: List[str] = []
    checked_rows: List[str] = []
    n_fields = 0
    for row in new.get("rows", []):
        name = row["name"]
        if want is not None and name not in want:
            continue
        ref = base_rows.get(name)
        if ref is None:
            continue
        checked_rows.append(name)
        b_us, n_us = float(ref["us_per_call"]), float(row["us_per_call"])
        n_fields += 1
        if b_us > 0 and n_us > b_us * max_slowdown:
            violations.append(
                f"{name}: us_per_call {n_us:.1f} > {max_slowdown:g}x "
                f"baseline {b_us:.1f}")
        ref_fields = ref.get("fields", {})
        for field, new_v in row.get("fields", {}).items():
            base_v = ref_fields.get(field)
            if not isinstance(new_v, (int, float)) or \
                    not isinstance(base_v, (int, float)):
                continue
            n_fields += 1
            if _is_timing_field(field):
                if base_v > 0 and new_v > base_v * max_slowdown:
                    violations.append(
                        f"{name}.{field}: {new_v:.4g} > {max_slowdown:g}x "
                        f"baseline {base_v:.4g}")
                continue
            if abs(new_v - base_v) > atol + rtol * abs(base_v):
                violations.append(
                    f"{name}.{field}: {new_v:.4g} vs baseline "
                    f"{base_v:.4g} (tol {atol + rtol * abs(base_v):.4g})")
    if want is not None:
        missing = sorted(want - set(checked_rows))
        for name in missing:
            violations.append(f"row {name}: requested for comparison but "
                              f"missing from new run or baseline")
    return {"violations": violations, "rows_checked": checked_rows,
            "fields_checked": n_fields}
