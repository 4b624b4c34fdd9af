"""Model scheduling: OMS (Algorithm 1) and the set-objective σ (Eq. 9/10).

Theorem 2: given a placement ``x``, the optimal schedule assigns each user
the placed implementation of its requested service with maximal QoS — a
per-user argmax. Host NumPy oracles and their torch twins; both take the
first maximum on ties and mark a dropped request with −1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .instance import PIESInstance
from .qos import eligibility_np, qos_matrix_np

__all__ = [
    "oms_np",
    "sigma_np",
    "sigma_user_np",
    "schedule_value_np",
    "oms_torch",
    "sigma_torch",
]


def oms_np(
    inst: PIESInstance,
    x: np.ndarray,
    Q: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, float]:
    """Optimal Model Scheduling (Algorithm 1).

    Returns ``(y, value)`` — ``y`` [U] int with the scheduled model index
    per user (−1 ⇒ request dropped to the central cloud), and the
    objective value Eq. (7) under this schedule.
    """
    if Q is None:
        Q = qos_matrix_np(inst)
    elig = eligibility_np(inst) & x[inst.u_edge]  # [U, P]
    masked = np.where(elig, Q, -1.0)
    y = masked.argmax(axis=1)
    served = masked[np.arange(inst.U), y] >= 0.0
    value = float(np.where(served, Q[np.arange(inst.U), y], 0.0).sum())
    y = np.where(served, y, -1)
    return y, value


def sigma_user_np(inst: PIESInstance, x: np.ndarray,
                  Q: Optional[np.ndarray] = None) -> np.ndarray:
    """Eq. (10): per-user optimal QoS σ_u(P) under placement ``x``."""
    if Q is None:
        Q = qos_matrix_np(inst)
    elig = eligibility_np(inst) & x[inst.u_edge]
    return np.where(elig, Q, 0.0).max(axis=1, initial=0.0)


def sigma_np(inst: PIESInstance, x: np.ndarray,
             Q: Optional[np.ndarray] = None) -> float:
    """Eq. (9): σ(P) = Σ_u σ_u(P) — objective value under optimal OMS."""
    return float(sigma_user_np(inst, x, Q).sum())


def schedule_value_np(inst: PIESInstance, y: np.ndarray,
                      Q: Optional[np.ndarray] = None) -> float:
    """Objective Eq. (7) of an explicit (possibly suboptimal) schedule."""
    if Q is None:
        Q = qos_matrix_np(inst)
    served = y >= 0
    return float(np.where(served, Q[np.arange(inst.U), np.maximum(y, 0)],
                          0.0).sum())


# ===========================================================================
# torch twins
# ===========================================================================

def oms_torch(Q: torch.Tensor, elig: torch.Tensor, u_edge: torch.Tensor,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OMS over a dense ``Q``/``elig`` [U, P] and a placement ``x`` [E, P]
    bool. Returns ``(y, per_user_qos)`` with ``y = −1`` for dropped
    requests; ``torch.argmax`` keeps the first maximum, as ``jnp.argmax``.
    """
    ok = elig & x[u_edge.long()]
    masked = torch.where(ok, Q, -1.0)
    y = torch.argmax(masked, dim=1)
    best = torch.gather(masked, 1, y[:, None])[:, 0]
    served = best >= 0.0
    qos = torch.where(served, torch.gather(Q, 1, y[:, None])[:, 0], 0.0)
    return torch.where(served, y, -1), qos


def sigma_torch(Q: torch.Tensor, elig: torch.Tensor, u_edge: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Eq. (9) as a 0-d tensor."""
    ok = elig & x[u_edge.long()]
    return torch.where(ok, Q, 0.0).amax(dim=1).sum()
