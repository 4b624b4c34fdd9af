"""Metrics registry: counters, gauges, log-bucketed latency histograms.

The aggregate half of :mod:`repro_torch.obs` (the tracer is the timeline half).
A :class:`MetricsRegistry` hands out labeled series —

    reg.counter("sweep.items", scenario="steady").inc(64)
    reg.gauge("serving.queue_depth", scenario="steady").set(12)
    reg.histogram("serving.latency_s", scenario="steady").observe(0.031)

— keyed by ``(name, sorted labels)``, so the same call site yields the
same series object every time. Histograms are **log-bucketed**: bucket
``i`` covers ``(growth^(i-1)·min_value, growth^i·min_value]`` with the
default growth of ``2**(1/8)`` ≈ 9.05 % per bucket, which bounds any
quantile estimate's relative error by ``sqrt(growth) − 1`` ≈ 4.4 % while
storing a 9-decade latency range in ~240 sparse buckets. Quantiles
(p50/p95/p99) come straight from the cumulative bucket counts — no raw
samples are kept, so memory is O(buckets), not O(observations).

Snapshots serialize to a versioned JSONL format
(:data:`METRICS_SCHEMA_VERSION`): one self-describing JSON object per
line, ``kind`` ∈ {counter, gauge, histogram} — the same records as
:mod:`repro.obs.metrics`, so either package reads the other's.

Like everything in :mod:`repro_torch.obs`, metrics are observational only:
nothing reads them back into placement or scheduling decisions.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "METRICS_SCHEMA_VERSION",
    "DEFAULT_GROWTH",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

#: Version stamp of the JSONL snapshot records.
METRICS_SCHEMA_VERSION = 1

#: Default histogram bucket growth factor: 2**(1/8) per bucket ⇒ 8
#: buckets per octave, ≤ ~4.4 % relative quantile error.
DEFAULT_GROWTH = 2.0 ** 0.125

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def record(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def record(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    """Sparse log-bucketed histogram with quantile estimation.

    Values ≤ ``min_value`` collapse into one underflow bucket (index
    ``None`` conceptually; stored as the smallest index − 1) whose
    representative value is ``min_value`` — fine for latencies, where
    anything below a nanosecond is measurement noise anyway.
    """

    __slots__ = ("growth", "min_value", "_log_growth", "_buckets",
                 "count", "sum", "min", "max", "exemplar_cap",
                 "_exemplars")

    def __init__(self, growth: float = DEFAULT_GROWTH,
                 min_value: float = 1e-9, exemplar_cap: int = 2):
        if not growth > 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_growth = math.log(self.growth)
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # bucket index -> up to exemplar_cap concrete exemplars (e.g.
        # {"uid", "tick"} request-trace links). First-N retention keeps
        # the exemplar set deterministic under identical input order.
        self.exemplar_cap = int(exemplar_cap)
        self._exemplars: Dict[int, List[Any]] = {}

    def _index(self, v: float) -> int:
        """Smallest ``i`` with ``min_value * growth**i >= v``."""
        if v <= self.min_value:
            return 0
        return max(0, math.ceil(
            math.log(v / self.min_value) / self._log_growth - 1e-12))

    def _upper_edge(self, i: int) -> float:
        return self.min_value * self.growth ** i

    def observe(self, v: float, exemplar: Any = None) -> None:
        v = float(v)
        if math.isnan(v):
            return  # a tick that served nothing has NaN mean latency
        i = self._index(v)
        self._buckets[i] = self._buckets.get(i, 0) + 1
        self.count += 1
        self.sum += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        if exemplar is not None:
            ex = self._exemplars.setdefault(i, [])
            if len(ex) < self.exemplar_cap:
                ex.append(exemplar)

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 ≤ q ≤ 1): the geometric midpoint of
        the bucket holding the q·count-th observation, clamped to the
        exact observed [min, max]."""
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        seen = 0
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if seen >= rank:
                hi = self._upper_edge(i)
                lo = hi / self.growth
                mid = math.sqrt(lo * hi) if lo > 0 else hi
                return min(max(mid, self.min), self.max)
        return self.max  # pragma: no cover - guarded by count above

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def summary(self) -> Dict[str, float]:
        """The p50/p95/p99 digest the benchmarks and reports print."""
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": float("nan") if empty else self.min,
            "max": float("nan") if empty else self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def record(self) -> Dict[str, Any]:
        rec = {
            "growth": self.growth,
            "min_value": self.min_value,
            "buckets": {str(i): n for i, n in sorted(self._buckets.items())},
            **self.summary(),
        }
        # additive-optional field: absent when no exemplars were ever
        # attached, so METRICS_SCHEMA_VERSION stays 1 and old readers
        # (which ignore unknown keys) keep working
        if self._exemplars:
            rec["exemplars"] = {str(i): ex for i, ex
                                in sorted(self._exemplars.items())}
        return rec

    @classmethod
    def from_record(cls, rec: Mapping[str, Any]) -> "Histogram":
        """Rebuild a histogram from its :meth:`record` dict — the inverse
        the cross-worker rollup needs (bucket counts are exact; ``sum`` is
        the stored float)."""
        h = cls(growth=float(rec.get("growth", DEFAULT_GROWTH)),
                min_value=float(rec.get("min_value", 1e-9)))
        h._buckets = {int(i): int(n)
                      for i, n in rec.get("buckets", {}).items()}
        h.count = int(rec.get("count", sum(h._buckets.values())))
        h.sum = float(rec.get("sum", 0.0))
        if h.count:
            h.min = float(rec["min"])
            h.max = float(rec["max"])
        h._exemplars = {int(i): list(ex)
                        for i, ex in rec.get("exemplars", {}).items()}
        return h

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise sum of ``other`` into ``self`` (min/max union).

        Exact in bucket arithmetic: merging per-worker histograms yields
        byte-identical bucket counts, count, min, and max to histogramming
        the concatenated samples in one process (``sum`` is float addition
        and may differ in the last ulp). Bucket layouts must match.
        """
        if (other.growth, other.min_value) != (self.growth, self.min_value):
            raise ValueError(
                f"cannot merge histograms with different bucket layouts: "
                f"(growth={self.growth}, min_value={self.min_value}) vs "
                f"(growth={other.growth}, min_value={other.min_value})")
        for i, n in other._buckets.items():
            self._buckets[i] = self._buckets.get(i, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for i, ex in other._exemplars.items():
            mine = self._exemplars.setdefault(i, [])
            mine.extend(ex[: max(0, self.exemplar_cap - len(mine))])
        return self


class MetricsRegistry:
    """Labeled series factory + versioned snapshot/JSONL export."""

    def __init__(self):
        self._series: Dict[Tuple[str, str, _LabelKey], Any] = {}

    def _get(self, kind: str, name: str, labels: Mapping[str, Any],
             factory) -> Any:
        key = (kind, str(name), _label_key(labels))
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = factory()
        return series

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, growth: float = DEFAULT_GROWTH,
                  min_value: float = 1e-9, **labels: Any) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(growth, min_value))

    def __len__(self) -> int:
        return len(self._series)

    def snapshot(self) -> List[Dict[str, Any]]:
        """One self-describing record per series, stably ordered."""
        out = []
        for (kind, name, labels), series in sorted(
                self._series.items(), key=lambda kv: kv[0]):
            out.append({
                "metrics_schema": METRICS_SCHEMA_VERSION,
                "kind": kind,
                "name": name,
                "labels": dict(labels),
                **series.record(),
            })
        return out

    def to_jsonl(self) -> str:
        return "".join(json.dumps(rec, separators=(",", ":")) + "\n"
                       for rec in self.snapshot())

    @classmethod
    def from_snapshot(cls, records: Iterable[Mapping[str, Any]]
                      ) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`snapshot` records (version-checked
        per record), e.g. the ``metrics`` section of a saved obs
        artifact."""
        reg = cls()
        for rec in records:
            have = int(rec.get("metrics_schema", -1))
            if have != METRICS_SCHEMA_VERSION:
                raise ValueError(f"metrics record schema v{have}, this "
                                 f"code reads v{METRICS_SCHEMA_VERSION}")
            kind, name = rec["kind"], rec["name"]
            labels = dict(rec.get("labels", {}))
            if kind == "counter":
                reg.counter(name, **labels).inc(float(rec["value"]))
            elif kind == "gauge":
                reg.gauge(name, **labels).set(float(rec["value"]))
            elif kind == "histogram":
                key = ("histogram", str(name), _label_key(labels))
                reg._series[key] = Histogram.from_record(rec)
            else:
                raise ValueError(f"unknown metrics record kind {kind!r}")
        return reg

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Roll ``other`` into ``self``: counters add, histograms merge
        bucket-wise (exact — see :meth:`Histogram.merge`), gauges keep
        ``other``'s value when it is set (last-writer-wins across the
        merge order the caller chooses)."""
        for key, series in other._series.items():
            kind = key[0]
            mine = self._series.get(key)
            if mine is None:
                if kind == "counter":
                    mine = self._series[key] = Counter()
                elif kind == "gauge":
                    mine = self._series[key] = Gauge()
                else:
                    mine = self._series[key] = Histogram(
                        series.growth, series.min_value)
            if kind == "counter":
                mine.inc(series.value)
            elif kind == "gauge":
                if not math.isnan(series.value):
                    mine.set(series.value)
            else:
                mine.merge(series)
        return self

    def histograms(self, name: Optional[str] = None
                   ) -> Dict[str, Dict[str, float]]:
        """``{"name{labels}": summary}`` for every (matching) histogram."""
        out = {}
        for (kind, nm, labels), series in sorted(
                self._series.items(), key=lambda kv: kv[0]):
            if kind != "histogram" or (name is not None and nm != name):
                continue
            suffix = ",".join(f"{k}={v}" for k, v in labels)
            out[nm + ("{" + suffix + "}" if suffix else "")] = \
                series.summary()
        return out
