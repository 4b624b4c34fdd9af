"""Dynamic (time-horizon) placement — the paper's stated future work.

The paper (§VII): "we plan to consider more dynamic extension of this work
where service placement decisions are made over a time horizon rather than
all at once." This module implements that extension:

* request populations arrive per control tick (the scenarios of
  :mod:`repro_torch.workloads`);
* re-placing a model that is already resident is free, placing a new one
  pays a *switching cost* (model load/transfer time expressed in QoS
  units) — so naive per-tick re-optimization churns;
* :class:`DynamicPlacer` runs EGP with **hysteresis**: resident
  implementations get a stickiness bonus in the benefit map, trading a
  little instantaneous QoS for amortized stability.

Host NumPy in float64, decision for decision the reference's
:mod:`repro.core.dynamic` (the same tie-breaks, sums and tolerances).

``evaluate_horizon`` compares three policies over a tick sequence:
``static`` (place once on tick 0), ``greedy`` (EGP from scratch every
tick, pays switching), ``hysteresis`` (ours).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np

from .instance import PIESInstance
from .qos import qos_matrix_np
from . import placement as _placement
from .placement import FEASIBILITY_TOL, egp_np, sigma_upper_bound_np
from .scheduling import sigma_np

__all__ = ["DynamicPlacer", "evaluate_horizon"]


def _egp_with_bias(inst: PIESInstance, Q: np.ndarray,
                   resident: np.ndarray, bonus: float) -> np.ndarray:
    """EGP (Alg. 3) with a per-(edge, model) additive benefit bonus for
    already-resident implementations (hysteresis)."""
    x = np.zeros((inst.E, inst.P), dtype=bool)
    # decision-ledger sink (installed by repro_torch.obs.ledger;
    # observational)
    sink = _placement._DECISION_SINK
    for e in range(inst.E):
        users = inst.users_of_edge(e)
        if users.size == 0:
            continue
        req = np.unique(inst.u_service[users])
        keys = np.nonzero(np.isin(inst.sm_service, req))[0]
        if keys.size == 0:
            continue
        Qe = Q[users]
        v = {int(p): float(Qe[:, p].sum())
             + (bonus if resident[e, p] else 0.0) for p in keys}
        considered: set = set()
        satisfied = np.zeros(users.size, dtype=bool)
        remaining = float(inst.R[e])
        if sink is not None:
            best = np.zeros(users.size)
        while True:
            cand = [p for p in v if p not in considered]
            if not cand:
                break
            p_star = max(cand, key=lambda p: (v[p], -p))
            benefit = v[p_star]
            rank = 0
            bias_star = 0.0
            if sink is not None:
                # rank of the chosen candidate by *unbiased* benefit,
                # against the v values the argmax actually saw (the
                # same-service marginal rewrite below must not leak in):
                # > 0 means the stickiness bonus overrode the pure-QoS
                # argmax — the hysteresis override made visible
                bias_star = bonus if resident[e, p_star] else 0.0
                u_star = v[p_star] - bias_star
                rank = sum(
                    1 for q in cand
                    if (v[q] - (bonus if resident[e, q] else 0.0), -q)
                    > (u_star, -p_star))
            placed = inst.sm_r[p_star] <= remaining + FEASIBILITY_TOL
            if placed:
                x[e, p_star] = True
                remaining -= float(inst.sm_r[p_star])
                s_star = inst.sm_service[p_star]
                unsat = ~satisfied
                for p in keys:
                    p = int(p)
                    if (inst.sm_service[p] == s_star and p != p_star
                            and p not in considered):
                        v[p] = float((Qe[unsat, p] - Qe[unsat, p_star]).sum()) \
                            + (bonus if resident[e, p] else 0.0)
                satisfied |= Qe[:, p_star] >= 1.0 - 1e-9
            considered.add(p_star)
            if sink is not None:
                gain = 0.0
                if placed:
                    gain = float(np.maximum(Qe[:, p_star] - best,
                                            0.0).sum())
                    best = np.maximum(best, Qe[:, p_star])
                sink.pick(edge=e, impl=p_star, benefit=benefit,
                          gain=gain, remaining=remaining,
                          n_candidates=len(cand), rank=rank,
                          placed=placed, bias=bias_star)
            if remaining <= FEASIBILITY_TOL or satisfied.all() \
                    or len(considered) == len(v):
                break
    return x


@dataclasses.dataclass
class DynamicPlacer:
    switching_cost: float = 2.0   # QoS units per newly-loaded model
    stickiness: float = 3.0       # benefit bonus for resident models

    def __post_init__(self):
        self._resident: Optional[np.ndarray] = None
        #: [E, P] bool — implementations newly loaded by the latest step()
        #: (the mask behind its n_loads); consumers that *realize* loads
        #: (the serving horizon's cold-start gating) read this instead of
        #: shadowing the resident-set bookkeeping.
        self.new_loads: Optional[np.ndarray] = None
        #: [E, P] bool — implementations the latest step() *evicted* (were
        #: resident, no longer placed); the serving horizon re-routes work
        #: still queued on these instead of executing it on an evicted model.
        self.evicted: Optional[np.ndarray] = None

    def step(self, inst: PIESInstance, Q: Optional[np.ndarray] = None):
        """One control tick: returns (x, value, n_loads).

        ``self.stickiness`` is read afresh every step, so a feedback
        controller (:class:`repro_torch.tuning.controller.FeedbackPlacer`)
        can adapt the hysteresis online between ticks.
        """
        if Q is None:
            Q = qos_matrix_np(inst)
        if self._resident is None:
            self._resident = np.zeros((inst.E, inst.P), dtype=bool)
        x = _egp_with_bias(inst, Q, self._resident, self.stickiness)
        self.new_loads = x & ~self._resident
        self.evicted = self._resident & ~x
        loads = int(self.new_loads.sum())
        sigma = sigma_np(inst, x, Q)
        value = sigma - self.switching_cost * loads
        sink = _placement._DECISION_SINK
        if sink is not None:
            # close the tick's ledger record with the certificate
            sink.end(sigma=sigma,
                     sigma_bound=sigma_upper_bound_np(inst, Q))
        self._resident = x
        return x, value, loads


def evaluate_horizon(instances: Union[str, List[PIESInstance]],
                     switching_cost: float = 2.0,
                     stickiness: float = 3.0, *,
                     seed: int = 0,
                     n_ticks: Optional[int] = None) -> Dict[str, float]:
    """Total (QoS − switching) over a tick sequence for three policies.

    ``instances`` is either an explicit tick sequence or the name of a
    registered :mod:`repro_torch.workloads` scenario (``"flash_crowd"``,
    ...),
    materialized with ``(seed, n_ticks)``.
    """
    if isinstance(instances, str):
        # deferred: workloads uses core
        from repro_torch.workloads import horizon
        instances = horizon(instances, seed=seed, n_ticks=n_ticks)
    Qs = [qos_matrix_np(i) for i in instances]

    # static: tick-0 placement forever
    x0 = egp_np(instances[0], Qs[0])
    static = sum(sigma_np(i, x0, q) for i, q in zip(instances, Qs)) \
        - switching_cost * int(x0.sum())

    # greedy: re-place from scratch each tick, pay for every change
    greedy, prev = 0.0, np.zeros_like(x0)
    for i, q in zip(instances, Qs):
        x = egp_np(i, q)
        greedy += sigma_np(i, x, q) - switching_cost * int((x & ~prev).sum())
        prev = x

    # hysteresis
    placer = DynamicPlacer(switching_cost, stickiness)
    hyst = 0.0
    for i, q in zip(instances, Qs):
        _, value, _ = placer.step(i, q)
        hyst += value

    return {"static": float(static), "greedy": float(greedy),
            "hysteresis": float(hyst)}
