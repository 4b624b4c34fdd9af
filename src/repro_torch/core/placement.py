"""Placement (§V of the paper).

Host (NumPy) implementations that follow the paper's pseudocode, kept
decision for decision equal to :mod:`repro.core.placement`:

* :func:`egp_np` — Efficient Greedy Placement (Algorithm 3).
* :func:`agp_np` — Approximate Greedy Placement (Algorithm 2) with the
  exact-marginal vectorization (σ(P∪{p}) − σ(P) = Σ_u max(0, Q[u,p] −
  best_u)), O(U·P) per pick.
* :func:`agp_literal_np` — Algorithm 2 as printed (OMS recomputed for
  every candidate at every pick), the paper's Fig. 3b runtime.
* :func:`sck_np` — the knapsack-DP baseline ("SCK"); :func:`rnd_np` —
  random placement and random eligible scheduling ("RND").
* :func:`sigma_upper_bound_np` — the per-user relaxation bound σ̄ ≥ OPT;
  :func:`place_and_schedule` — the host entry point over all of them.

Device (torch) implementations, every edge advanced in lock-step:

* :func:`egp_place_torch`, :func:`agp_place_torch` — the dense ``[U, P]``
  greedy loops of the reference's per-edge ``while_loop``; the per-edge
  pick of each iteration is the ``greedy_argmax`` kernel.
* :func:`egp_place_sparse_torch` — Algorithm 3 driven from a top-k
  ``(user, candidate)`` pair set; state is O(U·k + E·P), which is what
  makes a 10⁶-user tick fit. :func:`sigma_sparse_torch` — σ (Eq. 9, OMS
  folded in) over the pairs.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .instance import PIESInstance
from .qos import eligibility_np, qos_matrix_np
from .scheduling import oms_np, sigma_np

__all__ = [
    "FEASIBILITY_TOL",
    "egp_np", "agp_np", "agp_literal_np", "sck_np", "rnd_np",
    "sigma_upper_bound_np", "place_and_schedule",
    "egp_place_torch", "agp_place_torch",
    "egp_place_sparse_torch", "sigma_sparse_torch",
]

#: Shared feasibility slack for ``r_sm ≤ R̂`` checks, one constant for the
#: float64 host path and the float32 device path (1e-6 is representable at
#: float32 resolution around typical storage magnitudes), so a boundary-cost
#: model is accepted or rejected alike by :func:`agp_np` and
#: :func:`agp_place_torch`.
FEASIBILITY_TOL = 1e-6


def sigma_upper_bound_np(inst: PIESInstance,
                         Q: Optional[np.ndarray] = None) -> float:
    """Per-user relaxation upper bound σ̄ on the optimum of Eq. (1).

    Every user is served by its best eligible implementation that would
    fit its edge's *whole* storage budget on its own (the ILP with the
    shared budgets relaxed away), so ``σ̄ ≥ OPT ≥ σ(x)`` for any feasible
    ``x``.
    """
    if Q is None:
        Q = qos_matrix_np(inst)
    fits = inst.sm_r[None, :] <= (inst.R[inst.u_edge][:, None]
                                  + FEASIBILITY_TOL)  # [U, P]
    # Q is already zero for ineligible (user, impl) pairs
    return float(np.where(fits, Q, 0.0).max(axis=1).sum())


# ===========================================================================
# Algorithm 3: Efficient Greedy Placement (EGP), host oracle
# ===========================================================================

def egp_np(inst: PIESInstance, Q: Optional[np.ndarray] = None) -> np.ndarray:
    """Efficient Greedy Placement — Algorithm 3, line-by-line.

    Per edge cloud: seed the benefit map ``v[(s,m)] = Σ_{u∈U_e} Q(u,s_u,m)``
    (lines 3–6); repeatedly take the highest-benefit unconsidered model
    (line 11), place it if it fits (lines 12–14), re-score the *sibling*
    implementations of the same service against the newly placed one over
    the not-yet-satisfied users (lines 15–16), mark it considered (17) and
    absorb fully-satisfied users into ``B`` (18–19); stop when storage is
    exhausted, everyone is satisfied, or all candidates were considered
    (line 20).
    """
    if Q is None:
        Q = qos_matrix_np(inst)
    x = np.zeros((inst.E, inst.P), dtype=bool)

    for e in range(inst.E):
        users = inst.users_of_edge(e)
        if users.size == 0:
            continue
        req_services = np.unique(inst.u_service[users])
        keys = np.nonzero(np.isin(inst.sm_service, req_services))[0]
        if keys.size == 0:
            continue
        Qe = Q[users]  # [|U_e|, P]
        v = {int(p): float(Qe[:, p].sum()) for p in keys}

        considered: set = set()           # A
        satisfied = np.zeros(users.size, dtype=bool)  # B (mask over users)
        remaining = float(inst.R[e])      # R̂

        while True:
            cand = [p for p in v if p not in considered]
            if not cand:
                break
            p_star = max(cand, key=lambda p: (v[p], -p))
            placed = inst.sm_r[p_star] <= remaining + FEASIBILITY_TOL
            if placed:
                x[e, p_star] = True
                remaining -= float(inst.sm_r[p_star])
                # lines 15–16: re-score sibling implementations of s*
                s_star = inst.sm_service[p_star]
                unsat = ~satisfied
                for p in keys:
                    p = int(p)
                    if (inst.sm_service[p] == s_star and p != p_star
                            and p not in considered):
                        v[p] = float(
                            (Qe[unsat, p] - Qe[unsat, p_star]).sum()
                        )
                # lines 18–19: users fully satisfied by (s*, m*)
                satisfied |= Qe[:, p_star] >= 1.0 - 1e-9
            considered.add(p_star)
            if remaining <= FEASIBILITY_TOL or satisfied.all() or len(considered) == len(v):
                break
    return x


# ===========================================================================
# Algorithm 2: Approximate Greedy Placement (AGP), host
# ===========================================================================

def agp_np(inst: PIESInstance, Q: Optional[np.ndarray] = None) -> np.ndarray:
    """Approximate Greedy Placement — Algorithm 2 with exact marginals.

    Identical picks to the literal pseudocode (argmax of σ(P ∪ {(e,(s,m))})
    over feasible candidates) but computes each marginal in closed form:
    adding model ``p`` at edge ``e`` improves only users in ``U_e`` whose
    current best QoS is below ``Q[u, p]``.
    """
    if Q is None:
        Q = qos_matrix_np(inst)
    x = np.zeros((inst.E, inst.P), dtype=bool)
    best = np.zeros(inst.U)  # σ_u under current placement

    for e in range(inst.E):
        users = inst.users_of_edge(e)
        remaining = float(inst.R[e])
        placed = np.zeros(inst.P, dtype=bool)
        while True:
            feasible = (~placed) & (inst.sm_r <= remaining + FEASIBILITY_TOL)
            if not feasible.any():
                break
            if users.size:
                gains = np.maximum(Q[users] - best[users, None],
                                   0.0).sum(axis=0)
            else:
                gains = np.zeros(inst.P)
            gains = np.where(feasible, gains, -np.inf)
            p_star = int(np.argmax(gains))
            x[e, p_star] = True
            placed[p_star] = True
            remaining -= float(inst.sm_r[p_star])
            if users.size:
                best[users] = np.maximum(best[users], Q[users, p_star])
    return x


def agp_literal_np(inst: PIESInstance,
                   Q: Optional[np.ndarray] = None) -> np.ndarray:
    """Algorithm 2 exactly as printed: every candidate evaluated by running
    optimal scheduling on σ(P ∪ {(e,(s,m))}) from scratch. O(U·P²) per pick
    — the runtime the paper's Fig. 3b shows."""
    if Q is None:
        Q = qos_matrix_np(inst)
    x = np.zeros((inst.E, inst.P), dtype=bool)
    for e in range(inst.E):
        remaining = float(inst.R[e])
        placed = np.zeros(inst.P, dtype=bool)
        while True:
            feasible = np.nonzero((~placed) & (inst.sm_r <= remaining
                                               + FEASIBILITY_TOL))[0]
            if feasible.size == 0:
                break
            best_val, best_p = -np.inf, -1
            for p in feasible:
                x[e, p] = True
                val = sigma_np(inst, x, Q)  # full optimal scheduling
                x[e, p] = False
                if val > best_val:
                    best_val, best_p = val, int(p)
            x[e, best_p] = True
            placed[best_p] = True
            remaining -= float(inst.sm_r[best_p])
    return x


# ===========================================================================
# Baselines: SCK (knapsack DP) and RND, host
# ===========================================================================

def sck_np(inst: PIESInstance, Q: Optional[np.ndarray] = None,
           resolution: int = 1) -> np.ndarray:
    """0/1-knapsack adaptation (the paper's "SCK" baseline).

    Per edge cloud: items are the individual service models, weights their
    storage costs, values their *standalone* total QoS ``Σ_{u∈U_e} Q(u, s_u,
    m)`` (ignoring that implementations of one service overlap, which is
    why SCK underperforms). Solved with the standard DP; scheduling is then
    OMS (Alg. 1), as in the paper.
    """
    if Q is None:
        Q = qos_matrix_np(inst)
    x = np.zeros((inst.E, inst.P), dtype=bool)
    weights_all = np.round(inst.sm_r * resolution).astype(np.int64)

    for e in range(inst.E):
        users = inst.users_of_edge(e)
        if users.size == 0:
            continue
        values_all = Q[users].sum(axis=0)
        items = np.nonzero(values_all > 0.0)[0]
        if items.size == 0:
            continue
        cap = int(np.floor(inst.R[e] * resolution))
        dp = np.zeros(cap + 1)
        choice = np.zeros((items.size, cap + 1), dtype=bool)
        for i, p in enumerate(items):
            w, val = int(weights_all[p]), float(values_all[p])
            if w > cap:
                continue
            cand = dp[: cap - w + 1] + val
            upd = cand > dp[w:]
            choice[i, w:] = upd
            dp[w:] = np.where(upd, cand, dp[w:])
        # backtrack
        c = cap
        for i in range(items.size - 1, -1, -1):
            if choice[i, c]:
                p = items[i]
                x[e, p] = True
                c -= int(weights_all[p])
    return x


def rnd_np(inst: PIESInstance, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Random placement + random eligible scheduling baseline.

    Returns ``(x, y)``: unlike the greedy algorithms, RND also randomizes
    the schedule (uniform over placed implementations of the requested
    service; −1 if none). The same seed gives the reference's draws.
    """
    rng = np.random.default_rng(seed)
    x = np.zeros((inst.E, inst.P), dtype=bool)
    for e in range(inst.E):
        remaining = float(inst.R[e])
        for p in rng.permutation(inst.P):
            if inst.sm_r[p] <= remaining + FEASIBILITY_TOL:
                x[e, p] = True
                remaining -= float(inst.sm_r[p])
    elig = eligibility_np(inst) & x[inst.u_edge]
    y = np.full(inst.U, -1, dtype=np.int64)
    for u in range(inst.U):
        opts = np.nonzero(elig[u])[0]
        if opts.size:
            y[u] = int(rng.choice(opts))
    return x, y


def place_and_schedule(inst: PIESInstance, algo: str = "egp", seed: int = 0,
                       Q: Optional[np.ndarray] = None):
    """Host entry point: returns ``(x, y, objective_value)``."""
    if Q is None:
        Q = qos_matrix_np(inst)
    if algo == "egp":
        x = egp_np(inst, Q)
    elif algo == "agp":
        x = agp_np(inst, Q)
    elif algo == "agp_literal":
        x = agp_literal_np(inst, Q)
    elif algo == "sck":
        x = sck_np(inst, Q)
    elif algo == "rnd":
        x, y = rnd_np(inst, seed)
        from .scheduling import schedule_value_np
        return x, y, schedule_value_np(inst, y, Q)
    elif algo == "opt":
        from .opt import opt_np
        x = opt_np(inst, Q)
    else:
        raise ValueError(f"unknown algorithm {algo!r}")
    y, value = oms_np(inst, x, Q)
    return x, y, value


# ===========================================================================
# Algorithms 2 and 3 over the dense QoS matrix, all edges in lock-step
# (device)
# ===========================================================================

def _edge_rows(u_row: torch.Tensor, n_rows: int
               ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """The users sorted by edge row, and Σ of per-user rows into their edge
    in a fixed order.

    A user belongs to one edge, so the reference's per-edge sum over every
    user of a copy masked to that edge (``Q * umask``) is the sum over the
    edge's own users: the other users add exact zeros. Sorting the users
    stably by edge once makes each edge's users one contiguous run, in
    ascending user order, and every per-edge sum a segmented sum over
    those runs (no atomics, the same order in every run). Returns ``order``
    (the sort permutation) and ``edge_sum``, which takes a ``[U, P]``
    tensor already in sorted order and gives ``[n_rows, P]``.
    """
    rows = u_row.long()
    order = torch.sort(rows, stable=True).indices
    lengths = torch.bincount(rows, minlength=n_rows)

    def edge_sum(w: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(w, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    return order, edge_sum


def _egp_lockstep(Q: torch.Tensor, u_row: torch.Tensor,
                  sm_service: torch.Tensor, sm_r: torch.Tensor,
                  R: torch.Tensor, relevant: torch.Tensor, max_iters: int,
                  use_kernel: Optional[bool]) -> torch.Tensor:
    """Algorithm 3 for ``n`` edge rows at once, the reference's
    ``_egp_one_edge`` step for step.

    ``Q [U, P]`` float32, eligibility-masked; ``u_row [U]`` each user's
    edge row; ``sm_service``, ``sm_r`` and ``relevant`` ``[n, P]`` (a row's
    own models: rows of one instance share them, rows of a batch do not);
    ``R [n]``. Returns ``x [n, P]`` bool.
    """
    from repro_torch.kernels.qos_matrix.ops import greedy_argmax

    n, P = relevant.shape
    dev = Q.device
    order, edge_sum = _edge_rows(u_row, n)
    Qs = Q[order]                                       # users by edge row
    rows = u_row.long()[order]
    r_ar = torch.arange(n, device=dev)
    p_ar = torch.arange(P, device=dev)
    sm_r = sm_r.to(torch.float32)

    v = edge_sum(Qs)              # lines 3–6: v[(s,m)] = Σ_{u∈U_e} Q(u,s_u,m)
    x = torch.zeros((n, P), dtype=torch.bool, device=dev)
    considered = torch.zeros((n, P), dtype=torch.bool, device=dev)
    satisfied = torch.zeros(Qs.shape[0], dtype=torch.bool, device=dev)
    remaining = R.to(torch.float32).clone()
    done = torch.zeros(n, dtype=torch.bool, device=dev)

    it = 0
    while it < max_iters and not bool(done.all()):
        cand = relevant & ~considered
        any_cand = cand.any(dim=1)
        # line 11: the first maximum of where(cand, v, -1e30), jnp.argmax's
        _, idx = greedy_argmax(v, cand, use_kernel=use_kernel)
        p_star = idx.clamp_min(0).long()
        r_star = sm_r.gather(1, p_star[:, None])[:, 0]
        fits = r_star <= remaining + FEASIBILITY_TOL
        place = fits & any_cand & ~done                 # lines 12–14
        x[r_ar, p_star] = x[r_ar, p_star] | place
        remaining = remaining - torch.where(place, r_star, 0.0)
        place_u = place[rows]
        q_star = Qs.gather(1, p_star[rows][:, None])[:, 0]   # Q(u, s_u, m*)
        if bool(place.any()):
            # lines 15–16: v[p] = Σ_unsat (Q[u,p] − Q[u,p*]) for siblings
            unsat = place_u & ~satisfied
            diff = edge_sum(torch.where(unsat[:, None],
                                        Qs - q_star[:, None], 0.0))
            s_star = sm_service.gather(1, p_star[:, None])
            sib = (sm_service == s_star) & ~considered                 & (p_ar[None, :] != p_star[:, None]) & relevant
            v = torch.where(place[:, None] & sib, diff, v)
            # lines 18–19: users fully satisfied by (s*, m*)
            satisfied = satisfied | (place_u & (q_star >= 1.0 - 1e-6))
        considered[r_ar, p_star] = considered[r_ar, p_star] | any_cand  # 17
        n_unsat = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, rows, (~satisfied).long())
        all_cons = (considered | ~relevant).all(dim=1)
        # line 20 — the reference's stop conditions and tolerances
        done = done | ~any_cand | (remaining <= 1e-6) | (n_unsat == 0) \
            | all_cons
        it += 1
    return x


def _agp_lockstep(Q: torch.Tensor, u_row: torch.Tensor, sm_r: torch.Tensor,
                  R: torch.Tensor, max_iters: int,
                  use_kernel: Optional[bool]) -> torch.Tensor:
    """Algorithm 2 (exact marginals) for ``n`` edge rows at once, the
    reference's ``_agp_one_edge`` step for step. Arguments as
    :func:`_egp_lockstep`'s; returns ``x [n, P]`` bool."""
    from repro_torch.kernels.qos_matrix.ops import greedy_argmax

    n, P = sm_r.shape
    dev = Q.device
    order, edge_sum = _edge_rows(u_row, n)
    Qs = Q[order]
    rows = u_row.long()[order]
    r_ar = torch.arange(n, device=dev)
    sm_r = sm_r.to(torch.float32)

    x = torch.zeros((n, P), dtype=torch.bool, device=dev)
    best = torch.zeros(Qs.shape[0], dtype=torch.float32, device=dev)
    remaining = R.to(torch.float32).clone()
    done = torch.zeros(n, dtype=torch.bool, device=dev)

    it = 0
    while it < max_iters and not bool(done.all()):
        feasible = ~x & (sm_r <= (remaining + FEASIBILITY_TOL)[:, None])
        any_feasible = feasible.any(dim=1)
        gains = edge_sum(torch.clamp_min(Qs - best[:, None], 0.0))
        # gains are >= 0, so the first maximum over the feasible columns is
        # the reference's argmax of where(feasible, gains, -inf)
        _, idx = greedy_argmax(gains, feasible, use_kernel=use_kernel)
        p_star = idx.clamp_min(0).long()
        do = any_feasible & ~done
        x[r_ar, p_star] = x[r_ar, p_star] | do
        remaining = remaining - torch.where(
            do, sm_r.gather(1, p_star[:, None])[:, 0], 0.0)
        q_star = Qs.gather(1, p_star[rows][:, None])[:, 0]
        best = torch.where(do[rows], torch.maximum(best, q_star), best)
        done = done | ~any_feasible
        it += 1
    return x


def egp_place_torch(Q: torch.Tensor, elig: torch.Tensor, u_edge: torch.Tensor,
                    u_service: torch.Tensor, sm_service: torch.Tensor,
                    sm_r: torch.Tensor, R: torch.Tensor, n_services: int, *,
                    max_iters: int = 512,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """EGP (Algorithm 3) over a dense ``Q [U, P]``, all edges in
    lock-step: ``x [E, P]`` bool, the decisions of the reference's
    ``egp_place_jax``. The per-edge argmax runs through the
    ``greedy_argmax`` dispatcher (the CUDA kernel for CUDA tensors unless
    ``use_kernel=False``)."""
    E, P = int(R.shape[0]), int(Q.shape[1])
    Qm = torch.where(elig, Q, 0.0).to(torch.float32)
    # relevant[e, p] ⇔ some user covered by e requests service of p
    req = torch.zeros((E, n_services), dtype=torch.bool, device=Q.device)
    req[u_edge.long(), u_service.long()] = True
    relevant = req[:, sm_service.long()]
    return _egp_lockstep(Qm, u_edge, sm_service.long().expand(E, P),
                         sm_r.expand(E, P), R, relevant, max_iters,
                         use_kernel)


def agp_place_torch(Q: torch.Tensor, elig: torch.Tensor, u_edge: torch.Tensor,
                    sm_r: torch.Tensor, R: torch.Tensor, *,
                    max_iters: int = 256,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """AGP (Algorithm 2, exact marginals) over a dense ``Q [U, P]``, all
    edges in lock-step: ``x [E, P]`` bool, the decisions of the
    reference's ``agp_place_jax``."""
    E, P = int(R.shape[0]), int(Q.shape[1])
    Qm = torch.where(elig, Q, 0.0).to(torch.float32)
    return _agp_lockstep(Qm, u_edge, sm_r.expand(E, P), R, max_iters,
                         use_kernel)


# ===========================================================================
# Algorithm 3 over sparse candidates, all edges in lock-step (device)
# ===========================================================================

def _pair_scatter(erow: torch.Tensor, col: torch.Tensor, E: int, P: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Σ over ``(user, candidate)`` pairs into the ``[E, P]`` model grid, in
    a fixed order.

    A scatter-add with float atomics sums in an order that changes from
    run to run, and the last-bit differences flip near-tie greedy picks.
    The pair keys ``(e_u, col)`` never change within a tick, so they are
    sorted once (stably: each cell keeps its pairs in row-major order) and
    every scatter is a segmented sum over the sorted values. On the CPU
    that sum is sequential, the same order as the reference's
    ``.at[].add``; on CUDA it is a fixed-order segmented reduction, the
    same in every run. Column ``P`` absorbs the padded slots.
    """
    key = (erow[:, None] * (P + 1) + col).reshape(-1)
    order = torch.sort(key, stable=True).indices
    lengths = torch.bincount(key, minlength=E * (P + 1))

    def scatter(w: torch.Tensor) -> torch.Tensor:
        sums = torch.segment_reduce(w.reshape(-1)[order], "sum",
                                    lengths=lengths, unsafe=True)
        return sums.view(E, P + 1)[:, :P].contiguous()

    return scatter


def egp_place_sparse_torch(cand_idx: torch.Tensor, cand_q: torch.Tensor,
                           u_edge: torch.Tensor, sm_service: torch.Tensor,
                           sm_r: torch.Tensor, R: torch.Tensor, *,
                           max_iters: int = 512,
                           use_kernel: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, int]:
    """Algorithm 3 over a top-k sparse candidate set, all edges in lock-step.

    Takes the ``(cand_idx, cand_q) [U, k]`` pairs of
    :func:`repro_torch.core.candidates.topk_candidates_torch`. Each
    iteration advances every edge by one greedy pick (edges that finished
    are masked by ``done``) with the same picks, tie-breaks, stop rules and
    tolerances as the reference's lock-step ``while_loop``; with ``k ≥ M``
    the decisions are those of :func:`egp_np`. The per-edge argmax runs
    through the ``greedy_argmax`` dispatcher (the CUDA kernel for CUDA
    tensors unless ``use_kernel=False``).

    The loop is a Python loop with two host syncs per iteration (the stop
    test and the "anything placed" test that skips the re-score).

    Returns ``(x [E, P] bool, iterations)``; each iteration launches the
    argmax once.
    """
    from repro_torch.kernels.qos_matrix.ops import greedy_argmax

    U, K = cand_q.shape
    P = int(sm_service.shape[0])
    E = int(R.shape[0])
    dev = cand_q.device

    valid = cand_idx >= 0
    col = torch.where(valid, cand_idx, P).long()       # sentinel column P
    qpair = torch.where(valid, cand_q, 0.0).to(torch.float32)
    erow = u_edge.long()
    sm_service = sm_service.long()
    sm_r = sm_r.to(torch.float32)
    e_ar = torch.arange(E, device=dev)
    p_ar = torch.arange(P, device=dev)
    scatter_ep = _pair_scatter(erow, col, E, P)

    relevant = scatter_ep(valid.to(torch.float32)) > 0.0    # [E, P]
    v = scatter_ep(qpair)         # lines 3–6: v[(s,m)] = Σ_{u∈U_e} Q(u,s_u,m)
    x = torch.zeros((E, P), dtype=torch.bool, device=dev)
    considered = torch.zeros((E, P), dtype=torch.bool, device=dev)
    satisfied = torch.zeros(U, dtype=torch.bool, device=dev)
    remaining = R.to(torch.float32).clone()
    done = torch.zeros(E, dtype=torch.bool, device=dev)

    it = 0
    while it < max_iters and not bool(done.all()):
        cand = relevant & ~considered
        any_cand = cand.any(dim=1)                      # [E]
        _, idx = greedy_argmax(v, cand, use_kernel=use_kernel)   # line 11
        p_star = idx.clamp_min(0).long()
        fits = sm_r[p_star] <= remaining + FEASIBILITY_TOL
        place = fits & any_cand & ~done                 # lines 12–14
        x[e_ar, p_star] = x[e_ar, p_star] | place
        remaining = remaining - torch.where(place, sm_r[p_star], 0.0)

        pstar_u = p_star[erow]                          # [U] p* of u's edge
        place_u = place[erow]
        # Q(u, s_u, m*) per user — 0 unless p* is one of u's candidates
        qstar_u = torch.where(col == pstar_u[:, None], qpair, 0.0).sum(dim=1)

        if bool(place.any()):
            # lines 15–16: v[p] = Σ_unsat (Q[u,p] − Q[u,p*]) for siblings
            unsat_u = place_u & ~satisfied
            w = torch.where(unsat_u[:, None] & valid,
                            qpair - qstar_u[:, None], 0.0)
            diff = scatter_ep(w)
            sib = (sm_service[None, :] == sm_service[p_star][:, None]) \
                & ~considered & (p_ar[None, :] != p_star[:, None]) & relevant
            v = torch.where(place[:, None] & sib, diff, v)
            # lines 18–19: users fully satisfied by (s*, m*)
            satisfied = satisfied | (place_u & (qstar_u >= 1.0 - 1e-6))
        considered[e_ar, p_star] = considered[e_ar, p_star] | any_cand  # 17
        n_unsat = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
            0, erow, (~satisfied).long())
        all_sat = n_unsat == 0
        all_cons = (considered | ~relevant).all(dim=1)
        # line 20 — the reference's stop conditions and tolerances
        done = done | ~any_cand | (remaining <= 1e-6) | all_sat | all_cons
        it += 1
    return x, it


def sigma_sparse_torch(cand_idx: torch.Tensor, cand_q: torch.Tensor,
                       u_edge: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """σ (Eq. 9 with OMS folded in) over candidate pairs, a float32 0-d
    tensor: each user gets its best *placed* candidate at its own edge."""
    valid = cand_idx >= 0
    safe = cand_idx.clamp_min(0).long()
    placed = x[u_edge.long()[:, None], safe] & valid
    return torch.where(placed, cand_q, 0.0).amax(dim=1).sum()
