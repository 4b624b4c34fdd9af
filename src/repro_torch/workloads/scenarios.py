"""Scenario registry: named end-to-end workloads over the PIES model.

A :class:`Scenario` composes an arrival process, popularity/churn/mobility
dynamics, and an optional edge-failure schedule into a pure generator of
:class:`~repro_torch.core.instance.PIESInstance` sequences:

* infrastructure (edge capacities) and the service-model catalog are drawn
  **once per seed** and held fixed over the horizon, so per-tick placements
  are comparable and switching costs are meaningful;
* the *population* breathes per tick: the active user count follows the
  arrival process, user attributes follow churn generations, coverage
  follows the mobility walk;
* ``edge_failure`` composes with :mod:`repro_torch.distributed.elastic` —
  dead hosts map to dead edge clouds via :func:`recovery_plan`, whose
  storage is zeroed (nothing placeable) and whose users are re-homed to the
  nearest surviving edge on the ring, exactly the paper's service-level
  recovery.

Registered scenarios (``list_scenarios()``): ``steady``, ``diurnal``,
``flash_crowd``, ``mobility_churn``, ``edge_failure``, ``trace_replay``,
``trace_replay_bursty`` (the bundled real-world-style day and bursty
weekend traces under ``examples/data/``) and ``trace_replay_azure`` (a
genuinely external trace: an Azure-Functions-style per-interval
invocation excerpt, unit-normalized onto the edge slot pool).
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.instance import (PIESInstance,
                                       draw_edge_capacities,
                                       draw_service_catalog)
from repro_torch.distributed.elastic import (ClusterState,
                                             plan_survivor_mesh,
                                             recovery_plan)

from .arrivals import (ArrivalProcess, DiurnalArrivals, MMPPArrivals,
                       PoissonArrivals, TraceArrivals)
from .population import ChurnModel, MarkovMobility, ZipfPopularity

__all__ = [
    "Scenario",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "horizon",
]

_TAG_INFRA = 0x0C1
_TAG_CATALOG = 0x0C2


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seedable workload over a fixed infrastructure."""

    name: str
    arrivals: ArrivalProcess
    popularity_factory: Callable[[int], ZipfPopularity]
    churn: ChurnModel = ChurnModel()
    mobility_p_move: float = 0.0
    n_edges: int = 6
    n_services: int = 24
    max_impls: int = 4
    n_user_slots: int = 96
    n_ticks: int = 8
    delta_max: float = 10.0
    #: (tick, host) pairs: host (= edge group) dies at the start of `tick`
    #: and stays dead for the rest of the horizon.
    failure_schedule: Tuple[Tuple[int, int], ...] = ()
    devices_per_host: int = 8
    model_parallel: int = 4
    description: str = ""

    # -- static-per-seed draws (memoized: identical across the horizon) ---
    def infrastructure(self, seed: int):
        """Edge capacities ``(K, W, R)`` — §VI-B ranges, fixed per seed."""
        return tuple(a.copy() for a in _infrastructure_cached(self, int(seed)))

    def catalog(self, seed: int):
        """Service-model catalog — §VI-B ranges, fixed per seed."""
        return tuple(a.copy() for a in _catalog_cached(self, int(seed)))

    # -- failure handling -------------------------------------------------
    def dead_edges_at(self, tick: int) -> List[int]:
        """Edges dead at ``tick`` per the elastic recovery plan."""
        failed = frozenset(h for t, h in self.failure_schedule if t <= tick)
        if not failed:
            return []
        return list(_dead_edges_cached(self, failed))

    @staticmethod
    def _rehome(u_edge: np.ndarray, dead: List[int],
                n_edges: int) -> np.ndarray:
        """Move users on dead edges to the nearest surviving ring edge."""
        if not dead:
            return u_edge
        alive = np.array([e for e in range(n_edges) if e not in dead])
        if alive.size == 0:
            raise RuntimeError("all edge clouds failed; nothing to re-home to")
        # ring distance from every edge to every surviving edge
        d = np.abs(np.arange(n_edges)[:, None] - alive[None, :])
        d = np.minimum(d, n_edges - d)
        nearest = alive[np.argmin(d, axis=1)]  # [E] — identity on survivors
        return nearest[u_edge]

    # -- the generator ----------------------------------------------------
    def active_users_at(self, seed: int, tick: int) -> int:
        """Active population size: arrivals clipped to the slot pool."""
        return int(np.clip(self.arrivals.count_at(seed, tick), 1,
                           self.n_user_slots))

    def instance_at(self, seed: int, tick: int,
                    mobility_cache: Optional[np.ndarray] = None
                    ) -> PIESInstance:
        """Materialize the PIES instance at ``(seed, tick)`` — pure.

        ``mobility_cache`` optionally passes a precomputed
        ``MarkovMobility.trajectory`` ([≥tick+1, n_user_slots]) so horizon
        generation is O(T·U) instead of O(T²·U).
        """
        K, W, R = self.infrastructure(seed)
        sm_service, sm_acc, sm_k, sm_w, sm_r = self.catalog(seed)
        pop = self.popularity_factory(self.n_services)

        n_active = self.active_users_at(seed, tick)
        service, alpha, delta = self.churn.attributes_at(
            seed, tick, n_active, pop)

        mob = MarkovMobility(self.n_edges, self.mobility_p_move)
        if mobility_cache is not None:
            u_edge = mobility_cache[tick, :n_active].copy()
        elif self.mobility_p_move > 0.0:
            u_edge = mob.edges_at(seed, tick, n_active)
        else:
            u_edge = mob.home_edges(seed, n_active)

        dead = self.dead_edges_at(tick)
        u_edge = self._rehome(u_edge, dead, self.n_edges)
        R = R.copy()
        if dead:
            R[np.asarray(dead)] = 0.0  # dead edge groups place nothing

        inst = PIESInstance(
            K=K, W=W, R=R,
            sm_service=sm_service, sm_acc=sm_acc,
            sm_k=sm_k, sm_w=sm_w, sm_r=sm_r,
            u_edge=u_edge, u_service=service,
            u_alpha=alpha, u_delta=delta,
            delta_max=self.delta_max,
        )
        inst.validate()
        return inst

    def mobility_trajectory(self, seed: int,
                            n_ticks: int) -> Optional[np.ndarray]:
        """Precomputed ``instance_at`` mobility cache covering ``n_ticks``
        (None for static-coverage scenarios) — the shared helper that keeps
        horizon generation O(T·U) for every horizon consumer (``horizon``,
        sweep materialization, the serving horizon)."""
        if self.mobility_p_move <= 0.0:
            return None
        mob = MarkovMobility(self.n_edges, self.mobility_p_move)
        return mob.trajectory(seed, int(n_ticks), self.n_user_slots)

    def horizon(self, seed: int,
                n_ticks: Optional[int] = None) -> List[PIESInstance]:
        """The full per-tick instance sequence for one seed."""
        T = int(n_ticks or self.n_ticks)
        cache = self.mobility_trajectory(seed, T)
        return [self.instance_at(seed, t, mobility_cache=cache)
                for t in range(T)]


# Memoized per-(scenario, seed) draws — Scenario is a frozen (hashable)
# dataclass, so a horizon of T ticks draws infrastructure/catalog once and
# re-derives the elastic recovery plan only per distinct failed-host set.

@functools.lru_cache(maxsize=512)
def _infrastructure_cached(scenario: Scenario, seed: int):
    return draw_edge_capacities(_rng(seed, _TAG_INFRA), scenario.n_edges)


@functools.lru_cache(maxsize=512)
def _catalog_cached(scenario: Scenario, seed: int):
    return draw_service_catalog(_rng(seed, _TAG_CATALOG),
                                scenario.n_services, scenario.max_impls)


@functools.lru_cache(maxsize=512)
def _dead_edges_cached(scenario: Scenario, failed: frozenset):
    healthy = ClusterState(n_hosts=scenario.n_edges,
                           devices_per_host=scenario.devices_per_host)
    data0, _ = plan_survivor_mesh(healthy, scenario.model_parallel)
    state = dataclasses.replace(healthy, failed_hosts=failed)
    plan = recovery_plan(
        state, model_parallel=scenario.model_parallel,
        global_batch=data0 * scenario.model_parallel, old_data=data0,
        edge_of_host={h: h for h in range(scenario.n_edges)})
    return tuple(plan["dead_edges"])


# ===========================================================================
# Registry
# ===========================================================================

_REGISTRY: Dict[str, Callable[[], Scenario]] = {}


def register_scenario(factory: Callable[[], Scenario]):
    """Decorator: register a zero-arg scenario factory under its name."""
    scenario = factory()
    _REGISTRY[scenario.name] = factory
    return factory


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


def get_scenario(name: str, **overrides) -> Scenario:
    try:
        scenario = _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {list_scenarios()}") from None
    return dataclasses.replace(scenario, **overrides) if overrides \
        else scenario


def horizon(name: str, seed: int = 0,
            n_ticks: Optional[int] = None, **overrides) -> List[PIESInstance]:
    """Convenience: ``get_scenario(name).horizon(seed, n_ticks)``."""
    return get_scenario(name, **overrides).horizon(seed, n_ticks)


# ===========================================================================
# The catalog
# ===========================================================================

@register_scenario
def steady() -> Scenario:
    """Stationary i.i.d. traffic — the paper's §VI-B setting over time."""
    return Scenario(
        name="steady",
        arrivals=PoissonArrivals(rate=64.0),
        popularity_factory=lambda s: ZipfPopularity(s, exponent=0.8),
        churn=ChurnModel(lifetime=64),
        description="Homogeneous Poisson arrivals, static Zipf popularity, "
                    "negligible churn — the stationary baseline.",
    )


@register_scenario
def diurnal() -> Scenario:
    """Day/night sinusoidal load with slow popularity drift."""
    return Scenario(
        name="diurnal",
        arrivals=DiurnalArrivals(base_rate=56.0, amplitude=0.7, period=8),
        popularity_factory=lambda s: ZipfPopularity(
            s, exponent=1.0, drift_period=4),
        churn=ChurnModel(lifetime=24),
        description="Sinusoidal arrival rate (period 8 ticks) with the "
                    "popularity hot spot rotating every 4 ticks.",
    )


@register_scenario
def flash_crowd() -> Scenario:
    """Bursty MMPP traffic with a fast-moving hot service."""
    return Scenario(
        name="flash_crowd",
        arrivals=MMPPArrivals(base_rate=36.0, burst_rate=92.0,
                              p_burst=0.4, block=2),
        popularity_factory=lambda s: ZipfPopularity(
            s, exponent=1.4, drift_period=2, drift_step=5),
        churn=ChurnModel(lifetime=8),
        description="Block-renewal MMPP bursts (2.5× base rate) while the "
                    "Zipf head jumps 5 services every 2 ticks — the "
                    "placement-churn stress test.",
    )


@register_scenario
def mobility_churn() -> Scenario:
    """Users migrate across edge clouds while the population turns over."""
    return Scenario(
        name="mobility_churn",
        arrivals=PoissonArrivals(rate=64.0),
        popularity_factory=lambda s: ZipfPopularity(s, exponent=1.0),
        churn=ChurnModel(lifetime=6),
        mobility_p_move=0.3,
        description="Ring random-walk mobility (p_move=0.3) plus fast churn "
                    "(mean lifetime 6 ticks): coverage sets mutate while "
                    "demand stays stationary in aggregate.",
    )


#: Fallback day trace (hourly counts) if examples/data/ is not shipped.
_FALLBACK_DAY_TRACE = (18, 14, 11, 9, 8, 10, 16, 27, 44, 58, 66, 72,
                       78, 74, 69, 63, 60, 65, 74, 86, 92, 81, 55, 31)

#: Fallback weekend trace (48 hourly counts, bursty: flash events jump
#: ≥ 30 requests hour-over-hour) if examples/data/ is not shipped.
_FALLBACK_WEEKEND_TRACE = (
    30, 24, 18, 13, 10, 9, 11, 15, 22, 31, 42, 55,
    90, 58, 52, 49, 53, 64, 95, 92, 88, 72, 55, 42,
    33, 26, 19, 14, 10, 8, 9, 13, 20, 30, 44, 58,
    66, 91, 93, 76, 60, 57, 84, 70, 64, 48, 33, 24)


def _bundled_trace(filename: str, fallback: Tuple[int, ...]
                   ) -> TraceArrivals:
    # registration happens at import time, so a missing/corrupt trace file
    # (partial checkout, installed package without examples/) must degrade
    # to the identical built-in counts, never break `import repro_torch.workloads`
    path = Path(__file__).resolve().parents[3] / "examples" / "data" / \
        filename
    try:
        return TraceArrivals.from_file(path)
    except (OSError, ValueError):
        return TraceArrivals(counts=fallback)


def _bundled_day_trace() -> TraceArrivals:
    return _bundled_trace("diurnal_trace.csv", _FALLBACK_DAY_TRACE)


def _bundled_weekend_trace() -> TraceArrivals:
    return _bundled_trace("bursty_weekend_trace.csv",
                          _FALLBACK_WEEKEND_TRACE)


#: The Azure excerpt's per-tick counts after the loader's unit
#: normalization (60-minute buckets, mean 42/tick) — the fallback must
#: equal the processed file exactly so a partial checkout degrades to
#: identical counts (see _bundled_trace).
_AZURE_TARGET_MEAN = 42.0
_FALLBACK_AZURE_TRACE = (
    14, 11, 10, 11, 14, 18, 24, 33, 39, 47, 53, 59,
    55, 63, 67, 69, 66, 61, 55, 48, 40, 33, 25, 19,
    15, 12, 11, 11, 15, 20, 27, 34, 42, 51, 59, 60,
    59, 67, 75, 74, 72, 68, 71, 94, 59, 36, 28, 21)


def _bundled_azure_trace() -> TraceArrivals:
    path = Path(__file__).resolve().parents[3] / "examples" / "data" / \
        "azure_function_excerpt.csv"
    try:
        return TraceArrivals.from_azure_csv(
            path, minutes_per_tick=60, target_mean=_AZURE_TARGET_MEAN)
    except (OSError, ValueError):
        return TraceArrivals(counts=_FALLBACK_AZURE_TRACE)


@register_scenario
def trace_replay() -> Scenario:
    """Replay the bundled real-world-style day trace, tick = one hour."""
    return Scenario(
        name="trace_replay",
        arrivals=_bundled_day_trace(),
        popularity_factory=lambda s: ZipfPopularity(
            s, exponent=1.0, drift_period=12),
        churn=ChurnModel(lifetime=16),
        n_ticks=24,
        description="Exact replay of the bundled 24-hour request-count "
                    "trace (examples/data/diurnal_trace.csv): overnight "
                    "trough, lunchtime plateau, evening peak — the first "
                    "real-world-trace workload.",
    )


@register_scenario
def trace_replay_bursty() -> Scenario:
    """Replay the bundled bursty weekend trace, tick = one hour."""
    return Scenario(
        name="trace_replay_bursty",
        arrivals=_bundled_weekend_trace(),
        popularity_factory=lambda s: ZipfPopularity(
            s, exponent=1.2, drift_period=6, drift_step=3),
        churn=ChurnModel(lifetime=10),
        n_ticks=48,
        description="Exact replay of the bundled 48-hour weekend trace "
                    "(examples/data/bursty_weekend_trace.csv): flash "
                    "events jump ≥30 requests hour-over-hour while the "
                    "popularity head drifts — the second real trace, and "
                    "the bursty counterpoint the auto-tuner fits against.",
    )


@register_scenario
def trace_replay_azure() -> Scenario:
    """Replay the Azure-Functions-style excerpt, tick = one hour."""
    return Scenario(
        name="trace_replay_azure",
        arrivals=_bundled_azure_trace(),
        popularity_factory=lambda s: ZipfPopularity(
            s, exponent=1.1, drift_period=8, drift_step=2),
        churn=ChurnModel(lifetime=12),
        n_ticks=48,
        description="48-hour replay of an external Azure-Functions-style "
                    "per-interval invocation trace (examples/data/"
                    "azure_function_excerpt.csv), aggregated into hourly "
                    "ticks and mean-normalized onto the slot pool: "
                    "workday diurnal cycle, lunchtime dip, and a day-2 "
                    "evening flash event — the first genuinely external "
                    "public-trace workload, for fleet-scale sweeps.",
    )


@register_scenario
def edge_failure() -> Scenario:
    """Edge groups die mid-horizon; survivors absorb their users."""
    return Scenario(
        name="edge_failure",
        arrivals=PoissonArrivals(rate=64.0),
        popularity_factory=lambda s: ZipfPopularity(s, exponent=1.0),
        churn=ChurnModel(lifetime=32),
        failure_schedule=((3, 1), (5, 4)),
        description="Hosts 1 and 4 fail at ticks 3 and 5 (via "
                    "repro_torch.distributed.elastic recovery_plan); their "
                    "users re-home to the nearest surviving ring edge.",
    )
