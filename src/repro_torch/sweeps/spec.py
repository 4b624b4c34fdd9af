"""Declarative sweep specifications.

A :class:`SweepSpec` describes a Monte-Carlo experiment grid — scenarios ×
instance-size overrides × algorithms × seeds × ticks — and expands it into a
deterministic, stably-ordered list of :class:`WorkItem`\\ s. Every item hashes
to a stable key (:meth:`WorkItem.key`) derived from exactly the inputs that
determine its value (scenario + overrides + seed + tick + algorithm +
executor + engine schema version), which is what makes sweeps resumable:
the on-disk store skips items whose key it has already seen, and re-running
an identical spec is a no-op.

Two instance sources are supported per grid row:

* any scenario registered in :mod:`repro_torch.workloads.scenarios`
  (``steady``,
  ``flash_crowd``, …), with arbitrary field overrides
  (``n_user_slots=64``, ``mobility_p_move=0.5``, …);
* the pseudo-scenario ``"synthetic"`` — the paper's §VI-B numerical setup
  via :func:`repro_torch.core.instance.synthetic_instance`, with overrides
  (``n_users``, ``n_edges``, ``n_services``, ``max_impls``, …), which is
  how the Fig-3/Fig-4 instance streams run through the engine.

The padding envelope of every grid row is *derived statically* from the
scenario configuration (:func:`envelope_for`) — not from materialized
instances — so chunk boundaries never affect results.

Item keys, fingerprints and store keys are the reference's
(:mod:`repro.sweeps.spec`) string for string, so a store either package
wrote resumes in the other. ``kind="serving"`` (realized QoS through the
serving engine) waits for the port's serving tick and raises
:class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.instance import PIESInstance, synthetic_instance

__all__ = [
    "SCHEMA_VERSION",
    "ACCEL_ALGOS",
    "HOST_ALGOS",
    "SERVING_POLICIES",
    "KINDS",
    "SYNTHETIC",
    "WorkItem",
    "SweepSpec",
    "variant_key",
    "envelope_for",
    "materialize",
]

#: The reference engine's schema version (v3: serving items carry per-item
#: metric arrays); it enters every key, so it moves only with the
#: reference's.
SCHEMA_VERSION = 3

#: Algorithms with a batched accelerator implementation (evaluate_batch).
ACCEL_ALGOS = ("egp", "agp")

#: Host-only algorithms (NumPy reference implementations in
#: repro_torch.core).
HOST_ALGOS = ("egp", "agp", "agp_literal", "opt", "sck", "rnd")

#: The ``algos`` axis of a serving-kind sweep in the reference: the
#: continuous-batching queue policies plus ``"feedback"`` (closed-loop
#: placement).
SERVING_POLICIES = ("edf", "fcfs", "feedback")

#: Sweep kinds: ``"sigma"`` scores placements with the analytic objective
#: σ; ``"serving"`` drives scenario traffic through the full serving
#: engine and scores *realized* QoS (not in the port yet: it raises).
KINDS = ("sigma", "serving")

#: The pseudo-scenario name backed by ``synthetic_instance`` (§VI-B setup).
SYNTHETIC = "synthetic"

_SYNTH_DEFAULTS: Dict[str, Any] = dict(
    n_users=100, n_edges=10, n_services=100, max_impls=10,
    delta_max=10.0, alpha_scale=0.125, delta_scale=1.5,
)
#: Tick mixing stride for synthetic instance seeds (distinct instances per
#: tick while tick 0 reproduces ``synthetic_instance(seed=seed)`` exactly).
_SYNTH_TICK_STRIDE = 1_000_003


def _canon_overrides(overrides: Mapping[str, Any] | Sequence[Tuple[str, Any]]
                     ) -> Tuple[Tuple[str, Any], ...]:
    items = overrides.items() if isinstance(overrides, Mapping) else overrides
    out = []
    for k, v in items:
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        out.append((str(k), v))
    return tuple(sorted(out))


def variant_key(scenario: str,
                overrides: Tuple[Tuple[str, Any], ...]) -> str:
    """Human-readable key for a (scenario, overrides) grid row."""
    if not overrides:
        return scenario
    return scenario + "[" + ",".join(f"{k}={v}" for k, v in overrides) + "]"


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One evaluation: σ(algo placement) on instance(scenario, seed, tick).

    ``max_iters`` is the accelerator greedy-loop cap (0 for host items,
    whose reference implementations always run to completion).
    """

    scenario: str
    overrides: Tuple[Tuple[str, Any], ...]
    algo: str
    executor: str          # "accel" | "host"
    seed: int
    tick: int
    max_iters: int = 0

    def key(self) -> str:
        """Stable content hash — the resume/store key.

        Depends on everything that determines the value — including the
        accelerator iteration cap — and nothing else (in particular not on
        ``n_ticks``, chunk boundaries, or the device count), so extending
        a sweep or re-sharding it reuses results, while a store written
        under a different ``max_iters`` is never silently reused.
        """
        payload = json.dumps(
            [SCHEMA_VERSION, self.scenario, list(map(list, self.overrides)),
             self.algo, self.executor, self.seed, self.tick,
             self.max_iters],
            separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:24]

    @property
    def variant(self) -> str:
        return variant_key(self.scenario, self.overrides)


@dataclasses.dataclass
class SweepSpec:
    """The declarative grid: scenarios × overrides × algos × seeds × ticks.

    ``override_grid`` is an axis of override *sets* — each entry yields one
    grid row per scenario (e.g. sweeping ``n_user_slots`` over sizes).
    ``force_host`` routes accelerator-capable algorithms through the NumPy
    host path instead (float64 reference semantics).
    """

    scenarios: Tuple[str, ...] = ("steady",)
    seeds: Tuple[int, ...] = (0,)
    n_ticks: Optional[int] = None
    algos: Tuple[str, ...] = ("egp",)
    override_grid: Tuple[Tuple[Tuple[str, Any], ...], ...] = ((),)
    force_host: Tuple[str, ...] = ()
    #: accelerator greedy-loop iteration cap (part of every accel item key)
    max_iters: int = 512
    #: "sigma" (analytic σ objective); "serving" raises until the port has
    #: its serving tick
    kind: str = "sigma"

    def __post_init__(self):
        # order-preserving dedup on every axis: duplicates would collapse
        # into one (scenario, overrides, algo) group and break the
        # [n_seeds, n_ticks] result shapes
        self.scenarios = tuple(dict.fromkeys(str(s) for s in self.scenarios))
        self.seeds = tuple(dict.fromkeys(int(s) for s in self.seeds))
        self.algos = tuple(dict.fromkeys(str(a) for a in self.algos))
        self.force_host = tuple(dict.fromkeys(str(a)
                                              for a in self.force_host))
        self.override_grid = tuple(dict.fromkeys(
            _canon_overrides(ov) for ov in (self.override_grid or ((),))))
        self.max_iters = int(self.max_iters)
        self.kind = str(self.kind)
        if self.kind not in KINDS:
            raise ValueError(f"unknown sweep kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.kind == "serving":
            raise NotImplementedError(
                "kind='serving' (realized QoS through the serving engine) "
                "needs the serving tick and the tuning table, ROADMAP "
                "queue A items 3 and 8; the port runs kind='sigma'")
        for algo in self.algos:
            if algo not in set(ACCEL_ALGOS) | set(HOST_ALGOS):
                raise ValueError(
                    f"unknown algorithm {algo!r}; accelerator algos: "
                    f"{ACCEL_ALGOS}, host algos: {HOST_ALGOS}")

    # ------------------------------------------------------------------
    def executor_of(self, algo: str) -> str:
        if algo in ACCEL_ALGOS and algo not in self.force_host:
            return "accel"
        return "host"

    def ticks_for(self, scenario: str,
                  overrides: Tuple[Tuple[str, Any], ...] = ()) -> int:
        if self.n_ticks is not None:
            return int(self.n_ticks)
        if scenario == SYNTHETIC:
            return 1
        from repro_torch.workloads import get_scenario
        return int(get_scenario(scenario, **dict(overrides)).n_ticks)

    def expand(self) -> List[WorkItem]:
        """The full, stably-ordered work list (the resume unit is one item)."""
        items: List[WorkItem] = []
        for scenario in self.scenarios:
            for overrides in self.override_grid:
                T = self.ticks_for(scenario, overrides)
                for algo in self.algos:
                    ex = self.executor_of(algo)
                    mi = self.max_iters if ex == "accel" else 0
                    for seed in self.seeds:
                        for tick in range(T):
                            items.append(WorkItem(scenario, overrides, algo,
                                                  ex, seed, tick, mi))
        return items

    def groups(self) -> "List[Tuple[Tuple[str, Tuple, str], List[WorkItem]]]":
        """Work list grouped by (scenario, overrides, algo) — the unit that
        shares an envelope and an executor."""
        grouped: Dict[Tuple[str, Tuple, str], List[WorkItem]] = {}
        for item in self.expand():
            grouped.setdefault(
                (item.scenario, item.overrides, item.algo), []).append(item)
        return list(grouped.items())

    def fingerprint(self) -> str:
        """Hash of the whole spec (recorded in the store's spec.json)."""
        payload = json.dumps(
            [SCHEMA_VERSION, list(self.scenarios), list(self.seeds),
             self.n_ticks, list(self.algos),
             [list(map(list, ov)) for ov in self.override_grid],
             sorted(self.force_host), self.max_iters],
            separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def store_key(self) -> str:
        """Hash over the *reuse-stable* axes only (no seeds, no ticks) —
        the default store-directory name, so extending a sweep to more
        seeds or a longer horizon lands in the same store and resumes
        item-granularly instead of recomputing from scratch."""
        payload = json.dumps(
            [SCHEMA_VERSION, list(self.scenarios), list(self.algos),
             [list(map(list, ov)) for ov in self.override_grid],
             sorted(self.force_host)],
            separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "scenarios": list(self.scenarios),
            "seeds": list(self.seeds),
            "n_ticks": self.n_ticks,
            "algos": list(self.algos),
            "override_grid": [dict(ov) for ov in self.override_grid],
            "force_host": list(self.force_host),
            "max_iters": self.max_iters,
            "schema_version": SCHEMA_VERSION,
            "fingerprint": self.fingerprint(),
        }

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "SweepSpec":
        """Reconstruct a spec from :meth:`to_json` output (either
        package's). A document written under a different engine schema
        version is rejected: its item keys would silently never match this
        engine's."""
        have = int(doc.get("schema_version", SCHEMA_VERSION))
        if have != SCHEMA_VERSION:
            raise ValueError(
                f"spec document has sweep schema v{have}, this engine is "
                f"v{SCHEMA_VERSION} (item keys are schema-versioned)")
        return cls(
            scenarios=tuple(doc.get("scenarios", ("steady",))),
            seeds=tuple(doc.get("seeds", (0,))),
            n_ticks=doc.get("n_ticks"),
            algos=tuple(doc.get("algos", ("egp",))),
            override_grid=tuple(_canon_overrides(ov)
                                for ov in doc.get("override_grid", [{}])),
            force_host=tuple(doc.get("force_host", ())),
            max_iters=doc.get("max_iters", 512),
            kind=doc.get("kind", "sigma"),
        )


# ===========================================================================
# Static envelopes + instance materialization
# ===========================================================================

def _synth_params(overrides: Tuple[Tuple[str, Any], ...]) -> Dict[str, Any]:
    params = dict(_SYNTH_DEFAULTS)
    unknown = [k for k, _ in overrides if k not in params]
    if unknown:
        raise ValueError(f"unknown synthetic override(s) {unknown}; "
                         f"have {sorted(params)}")
    params.update(dict(overrides))
    return params


def envelope_for(scenario: str,
                 overrides: Tuple[Tuple[str, Any], ...] = ()
                 ) -> Tuple[int, int, int]:
    """Static padding envelope ``(U_pad, P_pad, E_pad)`` for a grid row.

    Derived from the scenario *configuration* (slot pool, catalog bounds),
    never from materialized instances, so it is identical across chunks,
    runs, and device counts. ``E_pad`` includes the +1 padded edge that
    hosts padded users (see :mod:`repro_torch.workloads.batched`).
    """
    if scenario == SYNTHETIC:
        p = _synth_params(overrides)
        return (int(p["n_users"]), int(p["n_services"]) * int(p["max_impls"]),
                int(p["n_edges"]) + 1)
    from repro_torch.workloads import get_scenario
    sc = get_scenario(scenario, **dict(overrides))
    return (int(sc.n_user_slots), int(sc.n_services) * int(sc.max_impls),
            int(sc.n_edges) + 1)


def materialize(scenario: str, overrides: Tuple[Tuple[str, Any], ...],
                pairs: Iterable[Tuple[int, int]]) -> List[PIESInstance]:
    """Instances for ``(seed, tick)`` pairs of one grid row, in order.

    Mobility trajectories are cached per seed so a chunk of T ticks costs
    O(T·U) rather than O(T²·U).
    """
    pairs = list(pairs)
    if scenario == SYNTHETIC:
        p = _synth_params(overrides)
        return [synthetic_instance(seed=int(s) + _SYNTH_TICK_STRIDE * int(t),
                                   **p) for s, t in pairs]

    from repro_torch.workloads import get_scenario

    sc = get_scenario(scenario, **dict(overrides))
    caches: Dict[int, np.ndarray] = {}
    if sc.mobility_p_move > 0.0:
        max_tick: Dict[int, int] = {}
        for s, t in pairs:
            max_tick[int(s)] = max(max_tick.get(int(s), 0), int(t))
        for s, mt in max_tick.items():
            caches[s] = sc.mobility_trajectory(s, mt + 1)
    return [sc.instance_at(int(s), int(t),
                           mobility_cache=caches.get(int(s)))
            for s, t in pairs]
