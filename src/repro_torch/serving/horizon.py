"""Multi-tick serving loop: scenario traffic through the full engine.

The analytic pipeline (``repro_torch.sweeps`` kind ``"sigma"``) scores
placements with the closed-form objective σ — *expected* QoS under the
paper's delay model. This module instead drives every registered
:mod:`repro_torch.workloads` scenario end-to-end through the serving
engine and scores **realized** QoS from simulated serving latency, the
way the paper's real-world experiment (§VI-C) does with measured latency:

per control tick, :func:`run_horizon`

1. materializes the tick's :class:`~repro_torch.core.instance
   .PIESInstance` from the scenario (arrival counts + population
   dynamics);
2. re-places via :class:`~repro_torch.core.dynamic.DynamicPlacer` (EGP
   with hysteresis — switching costs and a stickiness bonus for resident
   implementations); switching cost is *realized*, not just booked:
   a newly placed implementation spends ``switching_cost`` seconds
   loading and serves nothing until then, so placement churn costs
   real latency (cold starts) and hysteresis pays off measurably;
3. routes each request with OMS (Alg. 1) under the tick's placement;
4. submits the tick's requests — timestamped by the scenario's arrival
   process *within* the tick window — into one **stateful**
   :class:`~repro_torch.serving.scheduler.ContinuousScheduler` whose
   queues and in-flight batches survive tick boundaries (backlog from a
   flash crowd spills into the next tick, exactly like a real engine).

Each tick emits a :class:`TickReport` (realized QoS, deadline misses,
queue depth, in-flight count, model loads, requeued backlog); requests
are *attributed to their arrival tick* even when they finish later, and
dropped requests (OMS returns −1: no placed implementation of the
requested service) score 0 QoS — so ``per_tick[t].mean_realized_qos`` is
an unconditional per-tick service-quality number and conservation holds
exactly (``served + dropped == submitted``). Backlog queued on an
implementation that a re-placement *evicts* never executes on the evicted
model: it is pulled off the executor and re-routed through OMS against
the new placement (:func:`_requeue_evicted`), or dropped when the new
placement no longer serves it.

Two closed data paths feed placement from measurement
(:mod:`repro_torch.tuning`): ``HorizonConfig.from_overrides`` consults
the fitted per-scenario knob lookup table for unset placer knobs, and
``policy="feedback"`` swaps the open-loop ``DynamicPlacer`` for the
:class:`~repro_torch.tuning.controller.FeedbackPlacer`, which adapts the
stickiness bonus online from each tick's realized completions.

Everything is a pure function of ``(config, seed)``: same seed →
byte-identical per-request finish times, which is what lets
``repro_torch.sweeps`` (kind ``"serving"``) resume killed sweeps
item-granularly by replaying a seed's horizon.

The per-tick body lives in :class:`TickController` so two callers can
share it bit-for-bit: :func:`run_horizon` (offline — materializes each
tick's instance from the scenario and loops as fast as the CPU allows)
and a live gateway (the reference's :mod:`repro.gateway`; not ported
yet), which rebuilds each tick's instance from requests that arrived
over a socket, paced by a wall or virtual clock. On a virtual clock with
a seeded load generator a gateway performs the same controller calls in
the same order, so its ``TickReport``\\ s are byte-identical to the
offline horizon's.

The tick is host NumPy in float64 and takes no device: every
``TickReport`` and per-request finish time is byte-identical to the
reference's (:mod:`repro.serving.horizon`) for the same config.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.obs import ledger as _obs_ledger
from repro_torch.obs import reqtrace as _reqtrace
from repro_torch.core.dynamic import DynamicPlacer
from repro_torch.core.instance import PIESInstance
from repro_torch.core.qos import qos_matrix_np
from repro_torch.core.scheduling import oms_np

from .scheduler import (ArrivingRequest, ContinuousScheduler,
                        ExecutorProfile, realized_qos_np)

__all__ = ["SERVING_PARAM_KEYS", "HorizonConfig", "TickReport",
           "HorizonResult", "TickController", "run_horizon",
           "split_serving_overrides"]

#: Override keys consumed by the serving loop (everything else is a
#: scenario/instance override). The sweep spec routes a flat override
#: mapping through :func:`split_serving_overrides` so one ``--override``
#: grammar covers both layers.
SERVING_PARAM_KEYS = ("switching_cost", "stickiness", "tick_duration",
                      "prompt_tokens", "new_tokens", "max_batch",
                      "feedback_gain", "feedback_ewma",
                      "feedback_target_miss")


def split_serving_overrides(
        overrides: Mapping[str, Any] | Tuple[Tuple[str, Any], ...]
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split a flat override mapping into (scenario, serving) key sets."""
    items = dict(overrides)
    serving = {k: v for k, v in items.items() if k in SERVING_PARAM_KEYS}
    scenario = {k: v for k, v in items.items() if k not in SERVING_PARAM_KEYS}
    return scenario, serving


@dataclasses.dataclass(frozen=True)
class HorizonConfig:
    """One serving-horizon run = (scenario, policy, placer knobs, seed)."""

    scenario: str = "steady"
    overrides: Tuple[Tuple[str, Any], ...] = ()   # scenario-level overrides
    #: ``"edf"`` / ``"fcfs"`` — continuous-batching queue policy — or
    #: ``"feedback"``: EDF queueing with the closed-loop
    #: :class:`~repro_torch.tuning.controller.FeedbackPlacer` adapting the
    #: stickiness bonus online from realized per-tick QoS/miss-rate.
    policy: str = "edf"
    #: DynamicPlacer's QoS-units switching cost — and, *realized*, the
    #: model-load latency in seconds: a newly placed implementation cannot
    #: serve until ``switching_cost`` seconds into its tick (arrivals
    #: queue meanwhile), so churny placements pay a cold-start penalty in
    #: realized QoS and the (switching_cost × stickiness) sweep grid
    #: measures a real trade-off, not a bookkeeping discount.
    switching_cost: float = 2.0
    stickiness: float = 3.0         # DynamicPlacer: resident benefit bonus
    seed: int = 0
    n_ticks: Optional[int] = None   # default: the scenario's horizon
    tick_duration: float = 1.0      # seconds of serving time per tick
    prompt_tokens: int = 128
    new_tokens: int = 32
    max_batch: int = 8
    # policy="feedback" controller knobs (see repro_torch.tuning.controller)
    feedback_gain: float = 1.5
    feedback_ewma: float = 0.5
    feedback_target_miss: float = 0.05

    @classmethod
    def from_overrides(cls, scenario: str, overrides, policy: str,
                       seed: int, n_ticks: Optional[int] = None
                       ) -> "HorizonConfig":
        """Build a config from a flat sweep-style override mapping.

        Placer knobs the mapping leaves unset are looked up in the fitted
        per-scenario table (:func:`repro_torch.tuning.fit.recommend`)
        when one ships for this scenario — the auto-tuner's closed data
        path from sweep grids back into the serving engine. Explicit overrides
        always win, and direct ``HorizonConfig(...)`` construction keeps
        the plain dataclass defaults.
        """
        scen_ov, serving = split_serving_overrides(overrides)
        missing = [k for k in ("switching_cost", "stickiness")
                   if k not in serving]
        if missing:
            from repro_torch.tuning.fit import recommend  # no cycle
            rec = recommend(scenario)
            if rec:
                for k in missing:
                    serving[k] = rec[k]
        return cls(scenario=scenario,
                   overrides=tuple(sorted(scen_ov.items())),
                   policy=policy, seed=int(seed), n_ticks=n_ticks,
                   **serving)


@dataclasses.dataclass
class TickReport:
    """Realized serving statistics of one control tick (arrival-attributed)."""

    tick: int
    submitted: int            # requests arriving this tick (inst.U)
    served: int               # submitted − dropped (all eventually finish)
    dropped: int              # OMS −1: no placed impl of the service
    mean_realized_qos: float  # over ALL submitted (dropped score 0)
    deadline_misses: int
    mean_latency_s: float     # over served requests (NaN if none)
    queue_depth: int          # backlog queued at the tick boundary
    in_flight: int            # sequences still running at the boundary
    model_loads: int          # newly loaded implementations this tick
    placement_value: float    # DynamicPlacer value (σ − switching·loads)
    #: backlog requests pulled off implementations this tick's re-placement
    #: evicted and pushed back through OMS re-routing (they never execute
    #: on an evicted model; unroutable ones count as dropped at their
    #: arrival tick)
    requeued: int = 0
    #: stickiness bonus the placer applied this tick (config value for
    #: open-loop policies; the adapted value under policy="feedback")
    stickiness: float = float("nan")
    #: mean A_sm of the implementations that served this tick's requests
    #: (NaN if none served) — persisted per item by the sweep engine so
    #: accuracy/latency frontiers are a pure store read
    mean_accuracy: float = float("nan")


@dataclasses.dataclass
class HorizonResult:
    config: HorizonConfig
    per_tick: List[TickReport]
    requests: List[ArrivingRequest]   # every served request, finish set

    # -- horizon-level aggregates -----------------------------------------
    @property
    def submitted(self) -> int:
        return sum(t.submitted for t in self.per_tick)

    @property
    def served(self) -> int:
        return sum(t.served for t in self.per_tick)

    @property
    def dropped(self) -> int:
        return sum(t.dropped for t in self.per_tick)

    @property
    def deadline_misses(self) -> int:
        return sum(t.deadline_misses for t in self.per_tick)

    @property
    def mean_realized_qos(self) -> float:
        """Submission-weighted mean over the whole horizon."""
        n = self.submitted
        return float(sum(t.mean_realized_qos * t.submitted
                         for t in self.per_tick) / n) if n else 0.0

    @property
    def miss_rate(self) -> float:
        return self.deadline_misses / self.served if self.served else 0.0

    def tick_values(self) -> np.ndarray:
        """[T] per-tick mean realized QoS — the sweep-item values."""
        return np.array([t.mean_realized_qos for t in self.per_tick],
                        np.float64)


def _arrival_times(scenario, seed: int, tick: int, n: int,
                   tick_duration: float) -> np.ndarray:
    """``n`` arrival timestamps inside tick ``tick``'s window.

    The scenario's arrival process supplies the offsets; the active
    population is its count clipped to the slot pool, so surplus arrivals
    are truncated and a shortfall (count 0 → the 1-user floor) is padded
    with deterministic mid-tick timestamps.
    """
    times = np.asarray(scenario.arrivals.times_in_tick(
        seed, tick, tick_duration), np.float64)
    if times.size < n:
        pad = (tick + (np.arange(times.size, n) + 0.5) / n) * tick_duration
        times = np.sort(np.concatenate([times, pad]))
    return times[:n]


def _requeue_evicted(sched: ContinuousScheduler, evicted: np.ndarray,
                     inst: PIESInstance, x: np.ndarray,
                     config: HorizonConfig,
                     tick_reqs: List[List[ArrivingRequest]],
                     meta: List[Dict[str, Any]]) -> int:
    """Pull backlog off evicted implementations, re-route it through OMS.

    A re-placement that drops a resident implementation mid-horizon must
    not leave queued (not in-flight) requests to execute on the evicted
    model. They are pulled off the executor and pushed through OMS (Alg. 1)
    against the *new* placement, as a mini-instance whose user set is
    exactly the displaced requests (their real edge/service/α/δ attributes
    against the tick's infrastructure and catalog). Re-routed requests keep
    their true arrival time (latency still counts the wait so far) but
    cannot be admitted in the past; unroutable ones (−1: the new placement
    holds no implementation of their service on their edge) are dropped
    and re-attributed as such to their arrival tick. Returns the number of
    requests pulled.
    """
    pulled: List[ArrivingRequest] = []
    for e, p in np.argwhere(evicted):
        pulled.extend(sched.evict_queued((int(e), int(p))))
    if not pulled:
        return 0
    bad = [r.uid for r in pulled if r.service < 0]
    if bad:
        # a silently-vanishing request would break conservation; every
        # horizon-submitted request carries its service, so this only
        # fires on a foreign caller that must opt into re-routing
        raise ValueError(f"cannot re-route requests with no service "
                         f"attribute (uids {bad[:5]}...)")
    mini = PIESInstance(
        K=inst.K, W=inst.W, R=inst.R,
        sm_service=inst.sm_service, sm_acc=inst.sm_acc,
        sm_k=inst.sm_k, sm_w=inst.sm_w, sm_r=inst.sm_r,
        u_edge=np.array([r.edge for r in pulled], dtype=inst.u_edge.dtype),
        u_service=np.array([r.service for r in pulled],
                           dtype=inst.u_service.dtype),
        u_alpha=np.array([r.alpha for r in pulled], np.float64),
        u_delta=np.array([r.delta for r in pulled], np.float64),
        delta_max=inst.delta_max)
    y, _ = oms_np(mini, x, qos_matrix_np(mini))
    rt = _reqtrace._REQTRACER
    # re-routing happens at the current tick's placement epoch; one meta
    # entry exists per already-completed tick, so this *is* tick len(meta)
    t_now = len(meta) * config.tick_duration
    for r, p2 in zip(pulled, y):
        p2 = int(p2)
        if p2 < 0:
            t0 = int(r.arrival // config.tick_duration)
            tick_reqs[t0] = [q for q in tick_reqs[t0] if q.uid != r.uid]
            meta[t0]["dropped"] += 1
            sched.unsubmit(r)   # keeps backlog() exact: it never completes
            if rt is not None:
                rt.drop(r.uid, t_now, reason="evicted_unroutable")
            continue
        if rt is not None:
            rt.requeue(r.uid, t_now, impl=p2)
        r.impl = p2
        r.accuracy = float(inst.sm_acc[p2])
        key = (r.edge, p2)
        if key not in sched.executors:
            sched.add_executor(key, ExecutorProfile.from_comp_cost(
                float(inst.sm_w[p2]), config.max_batch))
        sched.requeue([r])
    return len(pulled)


def run_horizon(config: HorizonConfig) -> HorizonResult:
    """Drive one scenario horizon through placement → routing → serving.

    Instrumented with :mod:`repro_torch.obs` (off by default, observational
    only — a traced run produces byte-identical ``TickReport``\\ s and
    per-request finish times): per-tick ``tick.materialize`` /
    ``tick.place`` / ``tick.route`` / ``tick.execute`` spans, a
    ``kernel.qos_matrix_np`` span inside placement, queue-depth and
    in-flight gauge samples at every tick boundary, realized-QoS gauge
    samples, and per-request latency histograms labeled by (scenario,
    policy). When a live stream publisher is installed
    (:mod:`repro_torch.obs.stream`, ``REPRO_OBS_STREAM``),
    each tick also emits a ``tick`` frame (provisional completed-window
    QoS/miss rate, queue depth) and the run ends with a ``horizon``
    summary frame — same invariant: stream-on runs are byte-identical to
    stream-off.
    """
    with obs.span("horizon.run", scenario=config.scenario,
                  policy=config.policy, seed=config.seed):
        return _run_horizon(config)


class TickController:
    """The stateful per-tick serving control loop, caller-agnostic.

    One instance owns everything a control plane carries across ticks:
    the placer (open-loop
    :class:`~repro_torch.core.dynamic.DynamicPlacer` or closed-loop
    feedback), the stateful
    :class:`~repro_torch.serving.scheduler.ContinuousScheduler`, per-tick
    request/meta bookkeeping, and the live-stream / feedback completion
    pointers. Callers differ only in *where each tick's instance comes
    from* and *when* :meth:`step` runs:

    * the offline horizon calls :meth:`materialize` (scenario-derived
      instance) and steps in a tight loop;
    * a live gateway (the reference's :mod:`repro.gateway`) rebuilds the
      instance from requests that arrived over its ingest socket and steps
      at clock-paced tick boundaries, passing the requests' carried arrival
      timestamps via ``times``.

    Identical call sequences produce byte-identical results — the
    gateway's virtual-clock parity guarantee rests on this class.
    """

    def __init__(self, config: HorizonConfig):
        from repro_torch.workloads import get_scenario  # uses core

        self.config = config
        self.scenario = get_scenario(config.scenario,
                                     **dict(config.overrides))
        self.n_ticks = int(config.n_ticks or self.scenario.n_ticks)
        self.feedback = config.policy == "feedback"
        if self.feedback:
            # deferred import: repro_torch.tuning imports the sweeps
            from repro_torch.tuning.controller import FeedbackPlacer
            self.placer = FeedbackPlacer(
                config.switching_cost, config.stickiness,
                gain=config.feedback_gain, ewma=config.feedback_ewma,
                target_miss=config.feedback_target_miss)
        else:
            self.placer = DynamicPlacer(config.switching_cost,
                                        config.stickiness)
        # the feedback policy adapts the *placer*; queue stays QoS-aware
        self.sched = ContinuousScheduler(
            policy="edf" if self.feedback else config.policy)
        self.mobility_cache = self.scenario.mobility_trajectory(
            config.seed, self.n_ticks)

        self.tick_reqs: List[List[ArrivingRequest]] = []
        self.meta: List[Dict[str, Any]] = []
        #: (queue_depth, in_flight) at each tick boundary
        self.boundary: List[Tuple[int, int]] = []
        self.uid = 0
        self._done_ptr = 0    # completions already fed to the controller
        self._stream_ptr = 0  # completions already published to the stream

    # -- tick inputs -------------------------------------------------------
    def materialize(self, t: int) -> PIESInstance:
        """The offline path: tick ``t``'s instance from the scenario."""
        with obs.span("tick.materialize", tick=t):
            return self.scenario.instance_at(
                self.config.seed, t, mobility_cache=self.mobility_cache)

    # -- the control step --------------------------------------------------
    def step(self, t: int, inst: PIESInstance,
             times: Optional[np.ndarray] = None) -> None:
        """Place → route → execute one control tick.

        ``times`` (sorted [U] arrival timestamps) defaults to the
        scenario's arrival process — the offline path; the gateway passes
        the timestamps its admitted requests actually carried.
        """
        config, sc, placer, sched = (self.config, self.scenario,
                                     self.placer, self.sched)
        # request tracing + decision ledger: off by default, one global
        # load + None check each; observational only (byte-identity of
        # TickReports / digests is tested per policy)
        rt = _reqtrace._REQTRACER
        led = _obs_ledger._LEDGER
        if rt is not None:
            rt.set_context(config.seed)
        with obs.span("tick.place", tick=t):
            with obs.kernel_span("qos_matrix_np", U=inst.U, P=inst.P):
                Q = qos_matrix_np(inst)
            if led is not None:
                led.begin(tick=t, seed=config.seed,
                          algo="egp_feedback" if self.feedback
                          else "egp_hysteresis")
            x, value, loads = placer.step(inst, Q)
            applied_stickiness = placer.current_stickiness \
                if self.feedback else config.stickiness
            if rt is not None:
                rt.epoch(t, value=float(value), loads=int(loads),
                         n_placed=int(x.sum()),
                         stickiness=float(applied_stickiness))
            # cold starts: every implementation the placer just loaded
            # spends the first switching_cost seconds of the tick loading
            # and serves nothing until then — gated up front, so an impl
            # placed now but first routed to next tick still queues
            # through its load window
            if config.switching_cost > 0.0:
                ready_at = t * config.tick_duration + config.switching_cost
                for e, p in np.argwhere(placer.new_loads):
                    key = (int(e), int(p))
                    sched.add_executor(key, ExecutorProfile.from_comp_cost(
                        float(inst.sm_w[p]), config.max_batch))
                    sched.delay_executor(key, ready_at)
        with obs.span("tick.route", tick=t):
            # backlog queued on implementations this re-placement evicted
            # is re-routed (or dropped) before any of it can execute
            n_requeued = 0
            if placer.evicted is not None and placer.evicted.any():
                n_requeued = _requeue_evicted(sched, placer.evicted, inst,
                                              x, config, self.tick_reqs,
                                              self.meta)
            y, _ = oms_np(inst, x, Q)

            if times is None:
                times = _arrival_times(sc, config.seed, t, inst.U,
                                       config.tick_duration)
            reqs: List[ArrivingRequest] = []
            for u in range(inst.U):
                p = int(y[u])
                e = int(inst.u_edge[u])
                if rt is not None:
                    rt.admit(self.uid + u, t, edge=e,
                             service=int(inst.u_service[u]),
                             alpha=float(inst.u_alpha[u]),
                             delta=float(inst.u_delta[u]),
                             arrival=float(times[u]))
                if p < 0:
                    if rt is not None:
                        rt.drop(self.uid + u, float(times[u]),
                                reason="no_placed_impl")
                    continue
                if rt is not None:
                    # chosen vs rejected: the other *placed* impls OMS
                    # could have routed this user to (Q > 0 ⇔ eligible)
                    opts = np.nonzero(x[e] & (Q[u] > 0.0))[0]
                    rej = sorted(((int(pp), float(Q[u, pp]))
                                  for pp in opts if int(pp) != p),
                                 key=lambda z: -z[1])[:4]
                    rt.route(self.uid + u, float(times[u]), impl=p,
                             q=float(Q[u, p]), candidates=rej)
                if (e, p) not in sched.executors:
                    sched.add_executor(
                        (e, p), ExecutorProfile.from_comp_cost(
                            float(inst.sm_w[p]), config.max_batch))
                reqs.append(ArrivingRequest(
                    uid=self.uid + u, impl=p, edge=e,
                    arrival=float(times[u]),
                    prompt_tokens=config.prompt_tokens,
                    new_tokens=config.new_tokens,
                    alpha=float(inst.u_alpha[u]),
                    delta=float(inst.u_delta[u]),
                    accuracy=float(inst.sm_acc[p]),
                    service=int(inst.u_service[u])))
            self.uid += inst.U
        with obs.span("tick.execute", tick=t):
            sched.submit(reqs)
            sched.run_until((t + 1) * config.tick_duration)

        self.tick_reqs.append(reqs)
        self.boundary.append((sched.queue_depth(), sched.in_flight()))
        obs.sample("serving.queue_depth", self.boundary[-1][0])
        obs.sample("serving.in_flight", self.boundary[-1][1])
        self.meta.append({"submitted": inst.U,
                          "dropped": int((y < 0).sum()),
                          "loads": loads, "value": float(value),
                          "delta_max": float(inst.delta_max),
                          "requeued": n_requeued,
                          "stickiness": float(applied_stickiness)})

        pub = obs.get_publisher()
        if pub is not None:
            # live tick frame: provisional stats over what *completed*
            # this tick (final arrival-attributed reports only exist
            # after the drain) — a pure read of scheduler state, so the
            # stream-on run stays byte-identical to stream-off
            window = sched.completed[self._stream_ptr:]
            self._stream_ptr = len(sched.completed)
            window_qos = window_miss = None
            if window:
                w_lats = np.maximum(np.array(
                    [r.finish - r.arrival for r in window]), 0.0)
                w_qos, w_miss = realized_qos_np(
                    w_lats, np.array([r.delta for r in window]),
                    np.array([r.accuracy for r in window]),
                    np.array([r.alpha for r in window]),
                    float(inst.delta_max))
                window_qos = float(w_qos.mean())
                window_miss = float(w_miss.mean())
            pub.emit("tick", {
                "scenario": config.scenario, "seed": config.seed,
                "policy": config.policy, "tick": t,
                "submitted": int(inst.U),
                "dropped": self.meta[-1]["dropped"],
                "queue_depth": self.boundary[-1][0],
                "in_flight": self.boundary[-1][1],
                "completed": len(window), "window_qos": window_qos,
                "miss_rate": window_miss, "requeued": n_requeued,
                "model_loads": loads})
            # kept request traces + the tick's decision-ledger record
            # ride the same wire (unknown types are ignored by old
            # readers, so the stream schema version stays put)
            if rt is not None:
                for rec in rt.drain_emits():
                    pub.emit("reqtrace", rec)
            if led is not None:
                for rec in led.drain_emits():
                    pub.emit("ledger", rec)

        if self.feedback:
            # close the loop on what actually *completed* this tick — the
            # only signal a real controller has mid-run
            window = sched.completed[self._done_ptr:]
            self._done_ptr = len(sched.completed)
            if window:
                w_lats = np.maximum(
                    np.array([r.finish - r.arrival for r in window]), 0.0)
                w_qos, w_miss = realized_qos_np(
                    w_lats, np.array([r.delta for r in window]),
                    np.array([r.accuracy for r in window]),
                    np.array([r.alpha for r in window]),
                    float(inst.delta_max))
                placer.observe(float(w_qos.mean()), float(w_miss.mean()),
                               len(window))

    def step_idle(self, t: int) -> None:
        """Advance one tick boundary with no admitted requests.

        Gateway-only resilience path: a wall-clock gateway can hit a
        tick boundary before any of the tick's requests physically
        arrived (a stalled load generator). The offline horizon never
        produces an empty tick (the population floor is one user), so
        the placement is simply left untouched, the scheduler still runs
        to the boundary (in-flight work completes), and the tick reports
        zero submissions.
        """
        config, sched = self.config, self.sched
        with obs.span("tick.execute", tick=t):
            sched.run_until((t + 1) * config.tick_duration)
        self.tick_reqs.append([])
        self.boundary.append((sched.queue_depth(), sched.in_flight()))
        obs.sample("serving.queue_depth", self.boundary[-1][0])
        obs.sample("serving.in_flight", self.boundary[-1][1])
        self.meta.append({"submitted": 0, "dropped": 0, "loads": 0,
                          "value": 0.0, "delta_max": 0.0, "requeued": 0,
                          "stickiness": float(config.stickiness)})
        pub = obs.get_publisher()
        if pub is not None:
            window = sched.completed[self._stream_ptr:]
            self._stream_ptr = len(sched.completed)
            pub.emit("tick", {
                "scenario": config.scenario, "seed": config.seed,
                "policy": config.policy, "tick": t, "submitted": 0,
                "dropped": 0, "queue_depth": self.boundary[-1][0],
                "in_flight": self.boundary[-1][1],
                "completed": len(window), "window_qos": None,
                "miss_rate": None, "requeued": 0, "model_loads": 0})

    # -- shutdown ----------------------------------------------------------
    def finalize(self) -> HorizonResult:
        """Drain the backlog and build the arrival-attributed result."""
        config, sched = self.config, self.sched
        tick_reqs, meta, boundary = self.tick_reqs, self.meta, self.boundary
        T = len(tick_reqs)
        # Backlog left at the horizon end drains to completion (graceful
        # shutdown); its requests stay attributed to their arrival ticks.
        with obs.span("horizon.drain"):
            sched.drain()

        tracer = obs.get_tracer()
        rt = _reqtrace._REQTRACER
        # exemplars must point at traces `obs explain` can resolve —
        # only kept (sampled-in) uids qualify
        kept_uids = set(rt.kept_uids()) if rt is not None else set()
        lat_hist = tracer.metrics.histogram(
            "serving.latency_s", scenario=config.scenario,
            policy=config.policy) if tracer is not None else None
        per_tick: List[TickReport] = []
        for t in range(T):
            reqs, m = tick_reqs[t], meta[t]
            if reqs:
                lats = np.maximum(
                    np.array([r.finish - r.arrival for r in reqs]), 0.0)
                qos, missed = realized_qos_np(
                    lats, np.array([r.delta for r in reqs]),
                    np.array([r.accuracy for r in reqs]),
                    np.array([r.alpha for r in reqs]), m["delta_max"])
            else:
                lats, qos, missed = (np.zeros(0), np.zeros(0),
                                     np.zeros(0, bool))
            if lat_hist is not None:
                if rt is not None:
                    # exemplars: each latency bucket links up to N
                    # concrete request traces (bucket counts are
                    # identical to the observe_many path)
                    for r, lat in zip(reqs, lats):
                        lat_hist.observe(
                            float(lat),
                            exemplar=rt.exemplar(r.uid, t)
                            if r.uid in kept_uids else None)
                else:
                    lat_hist.observe_many(lats)
            per_tick.append(TickReport(
                tick=t, submitted=m["submitted"], served=len(reqs),
                dropped=m["dropped"],
                # dropped requests contribute 0 — divide by ALL submitted
                mean_realized_qos=float(qos.sum() / m["submitted"])
                if m["submitted"] else 0.0,
                deadline_misses=int(missed.sum()),
                mean_latency_s=float(lats.mean()) if reqs
                else float("nan"),
                queue_depth=boundary[t][0], in_flight=boundary[t][1],
                model_loads=m["loads"], placement_value=m["value"],
                requeued=m["requeued"], stickiness=m["stickiness"],
                mean_accuracy=float(np.mean([r.accuracy for r in reqs]))
                if reqs else float("nan")))

        if tracer is not None:
            for rep in per_tick:
                obs.sample("serving.realized_qos", rep.mean_realized_qos)
            tracer.metrics.gauge(
                "serving.realized_qos", scenario=config.scenario,
                policy=config.policy).set(
                    float(sum(r.mean_realized_qos * r.submitted
                              for r in per_tick) /
                          max(sum(r.submitted for r in per_tick), 1)))
            obs.count("serving.submitted",
                      sum(r.submitted for r in per_tick))
            obs.count("serving.deadline_misses",
                      sum(r.deadline_misses for r in per_tick))
            obs.count("serving.requeued",
                      sum(r.requeued for r in per_tick))

        result = HorizonResult(
            config=config, per_tick=per_tick,
            requests=[r for reqs in tick_reqs for r in reqs])
        pub = obs.get_publisher()
        if pub is not None:
            # end-of-run summary: the *final* arrival-attributed numbers
            # the provisional tick frames converged toward
            pub.emit("horizon", {
                "scenario": config.scenario, "seed": config.seed,
                "policy": config.policy, "n_ticks": T,
                "submitted": result.submitted, "served": result.served,
                "dropped": result.dropped,
                "deadline_misses": result.deadline_misses,
                "mean_realized_qos": result.mean_realized_qos,
                "miss_rate": result.miss_rate})
            if rt is not None:
                for rec in rt.drain_emits():
                    pub.emit("reqtrace", rec)
            led = _obs_ledger._LEDGER
            if led is not None:
                for rec in led.drain_emits():
                    pub.emit("ledger", rec)
            if tracer is not None:
                pub.emit_metrics(tracer)
        return result


def _run_horizon(config: HorizonConfig) -> HorizonResult:
    """The offline path: a tight loop over :class:`TickController`."""
    ctl = TickController(config)
    for t in range(ctl.n_ticks):
        ctl.step(t, ctl.materialize(t))
    return ctl.finalize()
