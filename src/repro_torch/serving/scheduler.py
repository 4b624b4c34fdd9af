"""Continuous batching with QoS-aware admission — the serving fast path.

The paper schedules each request once (OMS); a production engine must also
decide *when* requests run: they arrive over time, batch slots free up as
sequences finish, and delay satisfaction (Eq. 3) decays while a request
queues. This module adds an event-driven continuous-batching simulator on
top of the PIES assignment:

* requests are routed to an implementation by OMS (the paper's Alg. 1);
* each (edge, implementation) executor runs a rolling batch: finished
  sequences release their slot immediately (continuous batching, vLLM
  style) instead of waiting for the whole batch (static batching);
* the queue is ordered by an **earliest-deadline-first** key derived from
  the request's delay threshold δ_u — the QoS-aware policy — or FCFS for
  the baseline;
* per-implementation latency comes from the catalog profile
  (prefill ∝ prompt tokens, decode ∝ steps, both scaled by comp_cost).

The simulation is a **single global event heap** over all executors:
arrivals and request completions are explicit events ordered by
``(time, seq)`` where ``seq`` is a monotone submission counter, so equal
timestamps resolve deterministically and request objects are never
compared. Executors only hold state (a policy-ordered queue plus the
in-flight set); all timing flows through the scheduler's heap. This is
what makes the scheduler *incremental*: :meth:`ContinuousScheduler
.run_until` advances the clock to a tick boundary and returns with queues
and in-flight batches intact, so a multi-tick loop
(:mod:`repro_torch.serving.horizon`) can interleave re-placement and
routing with serving without losing backlog. Everything is a deterministic
discrete-event simulation (no wall clock), so policies are comparable,
resumable sweeps get byte-identical replays, and unit tests can pin exact
finish times.

Host NumPy in float64, event for event the reference's
:mod:`repro.serving.scheduler`: the same heap keys, contention factor and
latency model, so finish times are byte-identical.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.instance import PIESInstance
from repro_torch.core.qos import (accuracy_satisfaction_elem_np,
                                  delay_satisfaction_elem_np)
# request-lifecycle tracing hook: the hot loop reads one module global
# (reqtrace._REQTRACER) per run_until/_admit call — disabled cost is a
# load + None check; enabled hooks are observational only
from repro_torch.obs import reqtrace as _reqtrace

__all__ = ["ArrivingRequest", "ExecutorProfile", "ContinuousScheduler",
           "realized_qos_np", "simulate"]


def realized_qos_np(latency, delta, accuracy, alpha, delta_max: float):
    """Eq. (1) scored with *realized* latency, elementwise.

    The single source of the realized-QoS blend for every serving surface
    (``simulate``, the horizon loop, the edge-cluster harness): accuracy
    satisfaction (Eq. 2) against the request's α, delay satisfaction
    (Eq. 3) against measured latency, averaged. Returns ``(qos, missed)``
    where ``missed`` marks deadline overruns.
    """
    latency = np.maximum(np.asarray(latency, np.float64), 0.0)
    a_hat = accuracy_satisfaction_elem_np(accuracy, alpha)
    d_hat = delay_satisfaction_elem_np(latency, delta, delta_max)
    missed = latency > np.asarray(delta, np.float64)
    return 0.5 * (a_hat + d_hat), missed

#: Occupancy slowdown per already-running sequence in the batch.
_CONTENTION = 0.15

_ARRIVE, _FINISH, _KICK = 0, 1, 2


@dataclasses.dataclass
class ArrivingRequest:
    uid: int
    impl: int                 # service model index (from OMS routing)
    edge: int
    arrival: float            # seconds
    prompt_tokens: int
    new_tokens: int
    alpha: float
    delta: float              # delay threshold (seconds)
    accuracy: float           # A_sm of the scheduled implementation
    service: int = -1         # requested service (enables re-routing when
                              # the scheduled impl is evicted mid-horizon)

    # simulation state
    start: float = -1.0
    finish: float = -1.0


@dataclasses.dataclass(frozen=True)
class ExecutorProfile:
    """Latency model of one implementation on one edge group."""
    prefill_per_token_s: float    # seconds per prompt token (batched)
    decode_per_step_s: float      # seconds per generated token (batched)
    max_batch: int = 8

    @classmethod
    def from_comp_cost(cls, comp_cost: float, max_batch: int = 8):
        # comp_cost ≈ active GFLOPs/token at an effective 50 GFLOP/s per
        # request: the reference's latency model, a constant of the
        # simulation and no measurement of any device
        per_tok = comp_cost / 50.0 * 1e-3
        return cls(prefill_per_token_s=per_tok,
                   decode_per_step_s=per_tok * 3.0, max_batch=max_batch)


class _Executor:
    """Queue + in-flight set of one (edge, impl) pair.

    Pure state: admission computes start/finish times, but *when* a slot
    frees is decided by the scheduler's global event heap — the executor
    never filters or re-orders an implicit timing structure (the old
    design kept a per-executor `(finish, request)` heap and rebuilt it
    with a list comprehension, which silently broke the heap invariant
    and crashed on equal finish times).
    """

    def __init__(self, profile: ExecutorProfile, policy: str):
        self.profile = profile
        self.policy = policy
        self.queue: List[Tuple[float, int, ArrivingRequest]] = []
        self.running: Dict[int, ArrivingRequest] = {}   # uid -> in-flight
        self.available_from = 0.0   # model-load gate (see delay_executor)

    def _key(self, r: ArrivingRequest) -> float:
        if self.policy == "edf":
            return r.arrival + r.delta     # absolute deadline
        return r.arrival                   # FCFS

    def submit(self, r: ArrivingRequest) -> None:
        heapq.heappush(self.queue, (self._key(r), r.uid, r))

    def admit(self, now: float) -> List[ArrivingRequest]:
        """Start queued work in free slots; returns newly started requests."""
        if now < self.available_from:
            return []                # model still loading; work queues
        started = []
        while self.queue and len(self.running) < self.profile.max_batch:
            _, _, r = heapq.heappop(self.queue)
            dur = (r.prompt_tokens * self.profile.prefill_per_token_s
                   + r.new_tokens * self.profile.decode_per_step_s)
            # batch contention: effective slowdown grows with occupancy
            dur *= 1.0 + _CONTENTION * len(self.running)
            r.start = now
            r.finish = now + dur
            self.running[r.uid] = r
            started.append(r)
        return started

    def complete(self, r: ArrivingRequest) -> None:
        del self.running[r.uid]


class ContinuousScheduler:
    """Event-driven continuous batching over a set of executors.

    Stateful by design: ``submit`` + ``run_until(t)`` advance the event
    clock to ``t`` and leave queued/in-flight requests in place, so ticks
    of a control horizon share one scheduler. ``run`` keeps the one-shot
    batch interface (submit everything, drain, return).
    """

    def __init__(self,
                 profiles: Optional[Dict[Tuple[int, int],
                                         ExecutorProfile]] = None,
                 policy: str = "edf"):
        if policy not in ("edf", "fcfs"):
            raise ValueError(f"unknown policy {policy!r}; use 'edf'|'fcfs'")
        self.policy = policy
        self.executors: Dict[Tuple[int, int], _Executor] = {}
        #: (time, seq, kind, key, request|None) — the single global event
        #: heap; seq breaks timestamp ties so payloads are never compared
        self._events: List[Tuple[float, int, int, Tuple[int, int],
                                 Optional[ArrivingRequest]]] = []
        self._seq = 0
        self.now = 0.0
        self.n_submitted = 0
        self.completed: List[ArrivingRequest] = []
        for key, p in (profiles or {}).items():
            self.add_executor(key, p)

    # -- executor registry (placements appear mid-horizon) -----------------
    def add_executor(self, key: Tuple[int, int],
                     profile: ExecutorProfile) -> None:
        """Register (edge, impl); idempotent — live queues are kept."""
        if key not in self.executors:
            self.executors[key] = _Executor(profile, self.policy)

    def delay_executor(self, key: Tuple[int, int], until: float) -> None:
        """Gate (edge, impl) behind a model load finishing at ``until``:
        nothing is admitted before then (arrivals queue), and a kick event
        re-runs admission the moment the load completes."""
        ex = self.executors[key]
        ex.available_from = max(ex.available_from, float(until))
        self._push(ex.available_from, _KICK, key, None)

    def evict_queued(self, key: Tuple[int, int]) -> List[ArrivingRequest]:
        """Pull every *queued* (not in-flight) request off (edge, impl).

        Used when re-placement evicts a resident implementation
        mid-horizon: queued work must not execute on a model that is no
        longer placed. Requests are returned in the executor's policy
        order (deterministic); in-flight batches run to completion.
        """
        ex = self.executors.get(key)
        if ex is None:
            return []
        out = []
        while ex.queue:
            _, _, r = heapq.heappop(ex.queue)
            out.append(r)
        return out

    def unsubmit(self, r: ArrivingRequest) -> None:
        """Remove one previously submitted request from the conservation
        accounting — it will neither execute nor complete (the horizon
        drops evicted backlog OMS cannot re-route). Without this,
        ``backlog()`` would stay positive forever after a drain."""
        self.n_submitted -= 1

    def requeue(self, requests: Iterable[ArrivingRequest]) -> None:
        """Re-submit previously evicted requests to their (new) executors.

        Unlike :meth:`submit`, the arrival event fires no earlier than the
        current clock (``self.now``): the original arrival time stays on
        the request (latency is still measured from true arrival), but a
        request evicted at tick *t* cannot be admitted in the past.
        """
        for r in requests:
            key = (r.edge, r.impl)
            if key not in self.executors:
                raise KeyError(f"no executor registered for (edge, impl)="
                               f"{key}; call add_executor first")
            self._push(max(r.arrival, self.now), _ARRIVE, key, r)

    # -- observability -----------------------------------------------------
    def queue_depth(self) -> int:
        return sum(len(ex.queue) for ex in self.executors.values())

    def in_flight(self) -> int:
        return sum(len(ex.running) for ex in self.executors.values())

    def backlog(self) -> int:
        """Submitted but not yet finished (queued + in-flight)."""
        return self.n_submitted - len(self.completed)

    # -- event machinery ---------------------------------------------------
    def _push(self, time: float, kind: int, key: Tuple[int, int],
              r: Optional[ArrivingRequest]) -> None:
        self._seq += 1
        heapq.heappush(self._events, (time, self._seq, kind, key, r))

    def submit(self, requests: Iterable[ArrivingRequest]) -> None:
        for r in requests:
            key = (r.edge, r.impl)
            if key not in self.executors:
                raise KeyError(f"no executor registered for (edge, impl)="
                               f"{key}; call add_executor first")
            self.n_submitted += 1
            self._push(r.arrival, _ARRIVE, key, r)

    def _admit(self, key: Tuple[int, int], now: float) -> None:
        rt = _reqtrace._REQTRACER
        for started in self.executors[key].admit(now):
            self._push(started.finish, _FINISH, key, started)
            if rt is not None:
                rt.execute(started.uid, started.start,
                           wait_s=max(started.start - started.arrival,
                                      0.0))

    def run_until(self, t_end: float) -> None:
        """Process every event with ``time ≤ t_end``; keep the rest."""
        rt = _reqtrace._REQTRACER
        while self._events and self._events[0][0] <= t_end:
            now, _, kind, key, r = heapq.heappop(self._events)
            if kind == _ARRIVE:
                self.executors[key].submit(r)
                if rt is not None:
                    rt.event(r.uid, "queue", now, edge=key[0],
                             impl=key[1])
            elif kind == _FINISH:
                self.executors[key].complete(r)
                self.completed.append(r)
                if rt is not None:
                    lat = max(r.finish - r.arrival, 0.0)
                    rt.complete(r.uid, now, latency=lat,
                                missed=lat > r.delta)
            # _KICK carries no payload — it exists to re-run admission
            self._admit(key, now)
            self.now = max(self.now, now)
        if math.isfinite(t_end):  # drain(∞) leaves the last event time
            self.now = max(self.now, t_end)

    def drain(self) -> None:
        """Run to completion (no more events)."""
        self.run_until(float("inf"))

    def run(self, requests: List[ArrivingRequest]) -> List[ArrivingRequest]:
        """One-shot: submit everything, drain, return the requests."""
        self.submit(requests)
        self.drain()
        return requests


def simulate(inst: PIESInstance, assignment: np.ndarray, comp_cost,
             *, policy: str = "edf", arrival_rate: float = 20.0,
             prompt_tokens: int = 128, new_tokens: int = 32,
             max_batch: int = 8, seed: int = 0,
             delta_max: Optional[float] = None,
             arrivals=None, tick_duration: float = 1.0) -> Dict[str, float]:
    """Simulate serving the routed requests; return realized-QoS stats.

    assignment: [U] implementation index per user (−1 = dropped).
    comp_cost: [P] per-implementation compute cost (catalog w_sm).
    arrivals: optional :class:`repro_torch.workloads.ArrivalProcess` —
      when given, request timestamps follow the (seed, tick)-seekable
      process (bursty / diurnal traffic) instead of the i.i.d. exponential
      default; the first ``U`` arrivals of the stream are used, one per
      user in order.
    """
    rng = np.random.default_rng(seed)
    delta_max = delta_max or inst.delta_max
    if arrivals is not None:
        times: List[float] = []
        tick = 0
        while len(times) < inst.U:
            times.extend(arrivals.times_in_tick(seed, tick, tick_duration))
            tick += 1
            if tick > 100_000:
                raise RuntimeError("arrival process produced no requests")
        arrival_times = np.asarray(times[:inst.U])
    else:
        arrival_times = np.cumsum(
            rng.exponential(1.0 / arrival_rate, size=inst.U))
    sched = ContinuousScheduler(policy=policy)
    reqs: List[ArrivingRequest] = []
    for u in range(inst.U):
        t = float(arrival_times[u])
        p = int(assignment[u])
        if p < 0:
            continue
        e = int(inst.u_edge[u])
        if (e, p) not in sched.executors:
            sched.add_executor(
                (e, p), ExecutorProfile.from_comp_cost(float(comp_cost[p]),
                                                       max_batch))
        reqs.append(ArrivingRequest(
            uid=u, impl=p, edge=e, arrival=t,
            prompt_tokens=prompt_tokens, new_tokens=new_tokens,
            alpha=float(inst.u_alpha[u]), delta=float(inst.u_delta[u]),
            accuracy=float(inst.sm_acc[p])))

    sched.run(reqs)

    if reqs:
        qos, missed = realized_qos_np(
            np.array([r.finish - r.arrival for r in reqs]),
            np.array([r.delta for r in reqs]),
            np.array([r.accuracy for r in reqs]),
            np.array([r.alpha for r in reqs]), delta_max)
    else:
        qos, missed = np.zeros(0), np.zeros(0, bool)
    return {
        "mean_qos": float(qos.mean()) if reqs else 0.0,
        "p10_qos": float(np.percentile(qos, 10)) if reqs else 0.0,
        "deadline_misses": int(missed.sum()),
        "served": len(reqs),
    }
