"""Top-k sparse candidate sets for placement at scale.

User ``u`` can only be served by the implementations of its requested
service ``s_u`` — at most ``M = max_impls`` of them (10 in the paper's
§VI-B setup) — so the placement path works on ``(user, candidate)`` pairs
``[U, k]`` instead of the dense ``[U, P]`` QoS matrix:

* :func:`impl_table_np` — the ``[S, M]`` service → implementation table;
* :func:`topk_candidates_np` (host oracle) and
  :func:`topk_candidates_torch` (device) — the ``k`` highest-QoS eligible
  implementations per user; ``k = M`` keeps every one and makes the sparse
  path exact;
* :func:`sigma_sparse_np` — σ over the candidate pairs, in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .instance import PIESInstance, TorchInstance
from .qos import qos_matrix_np

__all__ = [
    "CandidateSet",
    "impl_table_np",
    "max_impls_of",
    "topk_candidates_np",
    "topk_candidates_torch",
    "sigma_sparse_np",
]


@dataclasses.dataclass
class CandidateSet:
    """Sparse ``(user, candidate)`` pair representation of eligibility.

    ``cand_idx[u, c]`` is a model index into the instance's flattened
    ``(s, m)`` table, −1 for padding (user ``u`` has fewer than ``k``
    eligible implementations); ``cand_q[u, c]`` is the corresponding QoS
    (Eq. 1), 0 for padding. ``exact`` records whether the set kept every
    eligible implementation (``k ≥ M``), in which case sparse placement
    and scheduling reproduce the dense path's decisions.
    """

    cand_idx: np.ndarray  # [U, k] int64, −1 padded
    cand_q: np.ndarray    # [U, k] float64, 0 padded
    k: int
    exact: bool

    @property
    def U(self) -> int:
        return int(self.cand_idx.shape[0])


def max_impls_of(inst: PIESInstance) -> int:
    """``M`` — the largest implementation count over services."""
    if inst.P == 0:
        return 0
    return int(np.bincount(inst.sm_service, minlength=inst.S).max())


def impl_table_np(sm_service: np.ndarray,
                  n_services: Optional[int] = None) -> np.ndarray:
    """``[S, M]`` int64 table of model indices per service, −1 padded.

    Row ``s`` lists the flattened model indices implementing service ``s``
    in ascending index order — the gather target that turns per-user
    candidate enumeration into ``table[u_service]``.
    """
    sm_service = np.asarray(sm_service)
    P = sm_service.shape[0]
    S = int(n_services if n_services is not None
            else (sm_service.max() + 1 if P else 0))
    counts = np.bincount(sm_service, minlength=S)
    M = int(counts.max()) if P else 0
    table = np.full((S, M), -1, dtype=np.int64)
    order = np.argsort(sm_service, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(P) - np.repeat(starts, counts)
    table[sm_service[order], pos] = order
    return table


def topk_candidates_np(inst: PIESInstance, k: Optional[int] = None,
                       Q: Optional[np.ndarray] = None) -> CandidateSet:
    """NumPy reference top-k candidate selection (by QoS, ties → smaller
    model index, matching ``lax.top_k``'s first-occurrence order)."""
    if Q is None:
        Q = qos_matrix_np(inst)
    table = impl_table_np(inst.sm_service, inst.S)
    M = table.shape[1]
    k_eff = M if k is None else min(int(k), M)
    cand = table[inst.u_service]                       # [U, M]
    valid = cand >= 0
    q = np.where(valid,
                 Q[np.arange(inst.U)[:, None], np.clip(cand, 0, None)],
                 -1.0)
    order = np.argsort(-q, axis=1, kind="stable")[:, :k_eff]
    idx = np.take_along_axis(cand, order, axis=1)
    vals = np.take_along_axis(q, order, axis=1)
    kept = vals >= 0.0                                  # drop −1 pad rows
    return CandidateSet(cand_idx=np.where(kept, idx, -1),
                        cand_q=np.where(kept, vals, 0.0),
                        k=k_eff, exact=k_eff >= M)


def topk_candidates_torch(ti: TorchInstance,
                          table: Union[np.ndarray, torch.Tensor],
                          k: Optional[int] = None, *,
                          use_kernel: Optional[bool] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates on ``ti``'s device from an :func:`impl_table_np`
    table: ``(cand_idx [U, k] int32, cand_q [U, k] f32)``.

    The build goes through the
    :func:`repro_torch.kernels.qos_matrix.ops.topk_candidates` dispatcher:
    one kernel launch on a card, the plain version elsewhere; no ``[U, P]``
    matrix is built. At ``k = M`` the table order is kept, as the
    reference does; for ``k < M`` the selection is stable, so the lower
    index comes first among equal QoS, which is ``lax.top_k``'s order
    (``torch.topk`` promises no order among ties). A caller that builds
    more than once uploads the table once and passes the int32 tensor on
    ``ti``'s device, which is used as it is.
    """
    from repro_torch.kernels.qos_matrix.ops import topk_candidates

    table = torch.as_tensor(table, dtype=torch.int32, device=ti.device)
    return topk_candidates(ti.u_service, ti.u_alpha, ti.u_delta,
                           ti.u_share_k, ti.u_share_w, table, ti.sm_acc,
                           ti.sm_k, ti.sm_w, k, delta_max=ti.delta_max,
                           use_kernel=use_kernel)


def sigma_sparse_np(inst: PIESInstance, x: np.ndarray,
                    cand: CandidateSet) -> float:
    """σ (Eq. 9) evaluated over the candidate pairs only.

    Exact when ``cand.exact`` (every eligible implementation present); a
    lower bound otherwise (a placed implementation outside the top-k is
    invisible to the sparse schedule).
    """
    valid = cand.cand_idx >= 0
    placed = np.zeros_like(valid)
    rows = np.broadcast_to(inst.u_edge[:, None], cand.cand_idx.shape)
    placed[valid] = x[rows[valid], cand.cand_idx[valid]]
    best = np.where(placed, cand.cand_q, 0.0).max(axis=1, initial=0.0)
    return float(best.sum())
