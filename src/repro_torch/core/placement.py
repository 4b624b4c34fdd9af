"""Placement (§V of the paper): Efficient Greedy Placement (Algorithm 3).

* :func:`egp_np` — the host oracle, Algorithm 3 line by line (float64).
* :func:`egp_place_sparse_torch` — the same decisions driven from a top-k
  ``(user, candidate)`` pair set, every edge advanced in lock-step, on the
  device; the per-edge argmax of each iteration is the ``greedy_argmax``
  kernel. State is O(U·k + E·P), which is what makes a 10⁶-user tick fit.
* :func:`sigma_sparse_torch` — σ (Eq. 9, OMS folded in) over the pairs.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .instance import PIESInstance
from .qos import qos_matrix_np

__all__ = [
    "FEASIBILITY_TOL",
    "egp_np",
    "egp_place_sparse_torch",
    "sigma_sparse_torch",
]

#: Shared feasibility slack for ``r_sm ≤ R̂`` checks, one constant for the
#: float64 host path and the float32 device path (1e-6 is representable at
#: float32 resolution around typical storage magnitudes).
FEASIBILITY_TOL = 1e-6


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
