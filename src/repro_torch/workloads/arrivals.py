"""Arrival processes — deterministic, seekable by ``(seed, tick)``.

Every process answers two questions as *pure functions* of ``(seed, tick)``
(the same contract as :class:`repro_torch.data.TokenPipeline`): how many requests
arrive during a control tick (:meth:`ArrivalProcess.count_at`) and at what
wall-clock offsets within the tick (:meth:`ArrivalProcess.times_in_tick`).
A replacement worker that joins mid-horizon reproduces the stream without
replaying it, and two policies evaluated on the same seed see byte-identical
traffic.

* :class:`PoissonArrivals` — homogeneous Poisson (the steady baseline).
* :class:`MMPPArrivals` — Markov-modulated Poisson in block-renewal form:
  the modulating quiet/burst chain is resampled per ``block`` of ticks from
  a per-block hash, which keeps O(1) seeking (a literal 2-state chain would
  need the full history) while preserving the bursty, flash-crowd marginal
  statistics — geometric-ish burst episodes of mean length ``block``.
* :class:`DiurnalArrivals` — sinusoidal rate modulation (day/night cycle).
* :class:`TraceArrivals` — replay of a recorded per-tick request-count
  trace (cyclic), for real-world workload traces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "MMPPArrivals",
    "DiurnalArrivals",
    "TraceArrivals",
]

# Stream tags namespace the per-purpose RNG draws so e.g. the burst-state
# stream never collides with the count stream at the same (seed, tick).
_TAG_COUNT = 0x0A1
_TAG_TIMES = 0x0A2
_TAG_BURST = 0x0A3


def _rng(seed: int, tag: int, *idx: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), int(tag), *map(int, idx)]))


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base: Poisson counts around a (possibly tick-varying) rate."""

    def rate_at(self, seed: int, tick: int) -> float:
        raise NotImplementedError

    def count_at(self, seed: int, tick: int) -> int:
        """Number of requests arriving during ``tick`` (Poisson draw)."""
        lam = max(float(self.rate_at(seed, tick)), 0.0)
        return int(_rng(seed, _TAG_COUNT, tick).poisson(lam))

    def times_in_tick(self, seed: int, tick: int,
                      tick_duration: float = 1.0) -> np.ndarray:
        """Sorted arrival offsets (seconds from horizon start) within
        ``[tick·T, (tick+1)·T)`` — conditional-uniform given the count,
        which is exact for a Poisson process."""
        n = self.count_at(seed, tick)
        u = np.sort(_rng(seed, _TAG_TIMES, tick).random(n))
        return (tick + u) * float(tick_duration)


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson: constant expected ``rate`` requests per tick."""

    rate: float = 64.0

    def rate_at(self, seed: int, tick: int) -> float:
        return self.rate


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """Flash-crowd bursts: block-renewal Markov-modulated Poisson.

    Ticks are grouped into blocks of ``block`` ticks; block ``b`` is in the
    burst state with probability ``p_burst`` (independent per-block hash of
    ``(seed, b)``), during which the rate jumps from ``base_rate`` to
    ``burst_rate``. Seekable in O(1) by construction.
    """

    base_rate: float = 40.0
    burst_rate: float = 128.0
    p_burst: float = 0.3
    block: int = 2

    def is_burst(self, seed: int, tick: int) -> bool:
        b = int(tick) // max(int(self.block), 1)
        return bool(_rng(seed, _TAG_BURST, b).random() < self.p_burst)

    def rate_at(self, seed: int, tick: int) -> float:
        return self.burst_rate if self.is_burst(seed, tick) else self.base_rate


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal day/night modulation:
    ``rate(t) = base · (1 + amplitude · sin(2π (t + phase) / period))``."""

    base_rate: float = 64.0
    amplitude: float = 0.6
    period: int = 8
    phase: float = 0.0

    def rate_at(self, seed: int, tick: int) -> float:
        ang = 2.0 * np.pi * (tick + self.phase) / float(self.period)
        return self.base_rate * (1.0 + self.amplitude * float(np.sin(ang)))


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay a recorded per-tick count trace (cyclic beyond its length).

    Counts are exact (no Poisson resampling) so a recorded trace reproduces
    itself; arrival offsets within the tick remain hash-derived.
    """

    counts: Tuple[int, ...] = (32, 64, 96, 64)

    @classmethod
    def from_sequence(cls, counts: Sequence[int]) -> "TraceArrivals":
        return cls(counts=tuple(int(c) for c in counts))

    @classmethod
    def from_file(cls, path) -> "TraceArrivals":
        """Load a per-tick count trace from a text file.

        Accepts one count per line or several per line, separated by
        whitespace and/or commas (plain CSV). Lines starting with ``#`` and
        blank lines are skipped; floats are truncated to ints (some traces
        record average rates).
        """
        import os

        counts = []
        with open(os.fspath(path)) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                for tok in line.replace(",", " ").split():
                    counts.append(int(float(tok)))
        if not counts:
            raise ValueError(f"trace file {path!r} contains no counts")
        return cls.from_sequence(counts)

    @classmethod
    def from_azure_csv(cls, path, *, minutes_per_tick: int = 60,
                       target_mean: Optional[float] = None
                       ) -> "TraceArrivals":
        """Load an Azure-Functions-style per-interval invocation trace.

        Expects a CSV whose data rows are
        ``<interval start, minutes>,<invocation count>`` (header line and
        extra trailing columns tolerated; ``#`` comments and blank lines
        skipped) — the shape of the per-interval aggregates derived from
        the Azure Functions 2019 dataset. Two unit normalizations map the
        platform-scale log onto one edge deployment's control loop:

        * **time**: counts are summed into buckets of ``minutes_per_tick``
          minutes — one bucket per control tick;
        * **scale**: with ``target_mean``, counts are linearly rescaled so
          the *mean per-tick count* equals it (platform logs record
          millions of invocations; an edge cell serves a slot pool), then
          rounded. Relative structure — diurnal swing, burst ratios — is
          preserved exactly; absolute scale becomes deployment-sized.
        """
        import os

        per_minute: dict = {}
        with open(os.fspath(path)) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                cells = [c.strip() for c in line.split(",")]
                try:
                    minute, count = float(cells[0]), float(cells[1])
                except (IndexError, ValueError):
                    continue  # header or malformed row
                if minute < 0.0:
                    # a clock-skewed export would otherwise fold into the
                    # *last* tick via negative indexing — corrupt quietly
                    raise ValueError(
                        f"azure trace {path!r}: negative interval start "
                        f"{minute} (row {line!r})")
                per_minute[minute] = per_minute.get(minute, 0.0) + count
        if not per_minute:
            raise ValueError(
                f"azure trace {path!r} contains no (minute, count) rows")
        mpt = max(int(minutes_per_tick), 1)
        n_ticks = int(max(per_minute) // mpt) + 1
        buckets = np.zeros(n_ticks, np.float64)
        for minute, count in per_minute.items():
            buckets[int(minute // mpt)] += count
        if target_mean is not None:
            mean = float(buckets.mean())
            if mean <= 0.0:
                raise ValueError(
                    f"azure trace {path!r} has zero total invocations — "
                    f"cannot normalize to target_mean={target_mean}")
            buckets = buckets * (float(target_mean) / mean)
        return cls.from_sequence(np.rint(buckets).astype(int))

    def rate_at(self, seed: int, tick: int) -> float:
        return float(self.counts[int(tick) % len(self.counts)])

    def count_at(self, seed: int, tick: int) -> int:
        return int(self.counts[int(tick) % len(self.counts)])
