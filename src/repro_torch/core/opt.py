"""Exact PIES solver ("OPT"), a copy of :mod:`repro.core.opt` for the
port (the same subsets, the same DP, the same picks).

The paper solves the ILP (Eq. 7) with PuLP + CBC (footnote 2: >20 hours on
larger instances). CBC is unavailable offline, and — more importantly — the
PIES objective *decomposes across edge clouds* (each user is covered by
exactly one edge and clouds do not collaborate, §III-A), and *within* an
edge it decomposes across services up to the shared storage budget. We
exploit this for an exact polynomial-×-2^{m_s} dynamic program that is
orders of magnitude faster than the MILP:

  per edge e:
    for every service s requested by a covered user:
        enumerate all subsets of its implementations (m_s ≤ 10 in the
        paper's setup ⇒ ≤ 1024 subsets), score each subset's exact value
        Σ_{u∈U_e} max_{p∈subset} Q[u, p] and weight Σ r; Pareto-prune.
    grouped knapsack DP over services with integer storage capacity R_e.

Requires integer storage costs (true in both paper setups: r ∈ {10..20}
and r = 1); :func:`opt_np` rescales fractional costs by ``resolution``.
Validated against :func:`brute_force_np` on small instances and used as
the denominator of every approximation ratio in EXPERIMENTS.md.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np

from .instance import PIESInstance
from .qos import qos_matrix_np
from .scheduling import sigma_np

__all__ = ["opt_np", "opt_edge_np", "brute_force_np", "MAX_SUBSET_IMPLS"]

MAX_SUBSET_IMPLS = 16  # 2^16 subsets per service is the enumeration guard


def _service_groups(inst: PIESInstance, e: int, Q: np.ndarray,
                    resolution: int):
    """Yield per-service (subset_values, subset_weights, subset_members)."""
    users = inst.users_of_edge(e)
    cap = int(np.floor(inst.R[e] * resolution))
    groups = []
    for s in np.unique(inst.u_service[users]):
        impls = inst.models_of_service(int(s))
        impls = impls[np.round(inst.sm_r[impls] * resolution) <= cap]
        if impls.size == 0:
            continue
        if impls.size > MAX_SUBSET_IMPLS:
            raise ValueError(
                f"service {s} has {impls.size} implementations; exact subset "
                f"enumeration capped at {MAX_SUBSET_IMPLS}")
        Qs = Q[np.ix_(users, impls)]  # [|U_e|, m_s]
        w = np.round(inst.sm_r[impls] * resolution).astype(np.int64)
        # enumerate subsets; Pareto-prune (higher value, lower weight wins)
        subsets: List[Tuple[float, int, Tuple[int, ...]]] = [(0.0, 0, ())]
        for k in range(1, impls.size + 1):
            for combo in itertools.combinations(range(impls.size), k):
                wt = int(w[list(combo)].sum())
                if wt > cap:
                    continue
                val = float(Qs[:, list(combo)].max(axis=1).sum())
                subsets.append((val, wt, combo))
        # Pareto prune: sort by weight then keep strictly increasing value
        subsets.sort(key=lambda t: (t[1], -t[0]))
        pruned: List[Tuple[float, int, Tuple[int, ...]]] = []
        best = -1.0
        for val, wt, combo in subsets:
            if val > best + 1e-12:
                pruned.append((val, wt, combo))
                best = val
        groups.append((pruned, impls))
    return groups, cap


def opt_edge_np(inst: PIESInstance, e: int, Q: np.ndarray,
                resolution: int = 1) -> Tuple[np.ndarray, float]:
    """Exact optimal placement for one edge cloud. Returns (x_e [P], value)."""
    x_e = np.zeros(inst.P, dtype=bool)
    users = inst.users_of_edge(e)
    if users.size == 0:
        return x_e, 0.0
    groups, cap = _service_groups(inst, e, Q, resolution)
    if not groups:
        return x_e, 0.0

    NEG = -np.inf
    f = np.zeros(cap + 1)
    # choices[g][c] = index of subset chosen for group g at capacity c
    choice_tables = []
    for pruned, _ in groups:
        f_new = np.full(cap + 1, NEG)
        pick = np.zeros(cap + 1, dtype=np.int32)
        for idx, (val, wt, _) in enumerate(pruned):
            cand = np.full(cap + 1, NEG)
            cand[wt:] = f[: cap + 1 - wt] + val
            upd = cand > f_new
            f_new = np.where(upd, cand, f_new)
            pick = np.where(upd, idx, pick)
        f = f_new
        choice_tables.append(pick)

    c = int(np.argmax(f))
    total = float(f[c])
    # backtrack
    for g in range(len(groups) - 1, -1, -1):
        pruned, impls = groups[g]
        idx = int(choice_tables[g][c])
        val, wt, combo = pruned[idx]
        for j in combo:
            x_e[impls[j]] = True
        c -= wt
    return x_e, total


def opt_np(inst: PIESInstance, Q: Optional[np.ndarray] = None,
           resolution: int = 1) -> np.ndarray:
    """Exact optimal placement for the whole instance (per-edge DP)."""
    if Q is None:
        Q = qos_matrix_np(inst)
    x = np.zeros((inst.E, inst.P), dtype=bool)
    for e in range(inst.E):
        x[e], _ = opt_edge_np(inst, e, Q, resolution)
    return x


def brute_force_np(inst: PIESInstance,
                   Q: Optional[np.ndarray] = None) -> Tuple[np.ndarray, float]:
    """Exhaustive search over all feasible placements (tests only).

    Enumerates, per edge, every subset of service models fitting in R_e and
    takes the per-edge best (valid because the objective decomposes across
    edges). Exponential — keep instances tiny.
    """
    if Q is None:
        Q = qos_matrix_np(inst)
    x = np.zeros((inst.E, inst.P), dtype=bool)
    total = 0.0
    for e in range(inst.E):
        users = inst.users_of_edge(e)
        if users.size == 0:
            continue
        # restrict to models some covered user requests (others add 0)
        cands = np.nonzero(Q[users].sum(axis=0) > 0.0)[0]
        cands = cands[inst.sm_r[cands] <= inst.R[e]]
        best_val, best_set = 0.0, ()
        for k in range(len(cands) + 1):
            for combo in itertools.combinations(cands, k):
                if inst.sm_r[list(combo)].sum() > inst.R[e] + 1e-12:
                    continue
                if combo:
                    val = float(Q[np.ix_(users, list(combo))].max(axis=1).sum())
                else:
                    val = 0.0
                if val > best_val + 1e-12:
                    best_val, best_set = val, combo
        for p in best_set:
            x[e, p] = True
        total += best_val
    assert abs(sigma_np(inst, x, Q) - total) < 1e-6
    return x, total
