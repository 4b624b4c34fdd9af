"""Quality-of-Service model (Eqs. 1–6 of the paper), vectorized.

``Q ∈ [0,1]^{U×P}`` with ``Q[u, p] = Q(u, s_p, m_p)`` per Eq. (1): zero
when user ``u`` did not request the service of model ``p``, otherwise the
mean of the accuracy-satisfaction term (Eq. 2) and the delay-satisfaction
term (Eq. 3), where the delay ``D`` (Eq. 4) is transmission (Eq. 5) +
computation (Eq. 6) under even sharing of the covering edge's capacities.

* :func:`qos_matrix_np` — host NumPy, float64 (the oracle);
* :func:`qos_matrix_torch` — float32 torch over a :class:`TorchInstance`,
  the plain version of the CUDA kernel in
  :mod:`repro_torch.kernels.qos_matrix`.
"""
from __future__ import annotations

import numpy as np
import torch

from .instance import PIESInstance, TorchInstance

__all__ = [
    "accuracy_satisfaction_elem_np",
    "accuracy_satisfaction_np",
    "delay_np",
    "delay_satisfaction_elem_np",
    "delay_satisfaction_np",
    "qos_matrix_np",
    "eligibility_np",
    "qos_matrix_torch",
    "eligibility_torch",
]


# ===========================================================================
# NumPy reference
# ===========================================================================

def accuracy_satisfaction_elem_np(A, alpha) -> np.ndarray:
    """Eq. (2) with broadcasting left to the caller."""
    diff = np.asarray(alpha, np.float64) - np.asarray(A, np.float64)
    return np.where(diff <= 0.0, 1.0, np.maximum(0.0, 1.0 - diff))


def accuracy_satisfaction_np(A: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Eq. (2): ``â_sm(u)`` — broadcasts ``A`` [P] against ``alpha`` [U]."""
    return accuracy_satisfaction_elem_np(A[None, :], alpha[:, None])


def delay_np(inst: PIESInstance) -> np.ndarray:
    """Eq. (4)–(6): expected delay ``D_sm(u)`` as a [U, P] matrix."""
    counts = inst.covered_counts()
    share_k = counts[inst.u_edge] / inst.K[inst.u_edge]  # |U_e|/K_e
    share_w = counts[inst.u_edge] / inst.W[inst.u_edge]  # |U_e|/W_e
    return (
        inst.sm_k[None, :] * share_k[:, None]
        + inst.sm_w[None, :] * share_w[:, None]
    )


def delay_satisfaction_elem_np(D, delta, delta_max: float) -> np.ndarray:
    """Eq. (3) with broadcasting left to the caller."""
    over = np.asarray(D, np.float64) - np.asarray(delta, np.float64)
    return np.where(over <= 0.0, 1.0,
                    np.maximum(0.0, 1.0 - over / float(delta_max)))


def delay_satisfaction_np(D: np.ndarray, delta: np.ndarray,
                          delta_max: float) -> np.ndarray:
    """Eq. (3): ``d̂_sm(u)`` from the delay matrix [U, P]."""
    return delay_satisfaction_elem_np(D, delta[:, None], delta_max)


def eligibility_np(inst: PIESInstance) -> np.ndarray:
    """[U, P] bool — model ``p`` implements user ``u``'s requested service."""
    return inst.u_service[:, None] == inst.sm_service[None, :]


def qos_matrix_np(inst: PIESInstance) -> np.ndarray:
    """Eq. (1): the dense QoS matrix ``Q`` [U, P], float64."""
    a_hat = accuracy_satisfaction_np(inst.sm_acc, inst.u_alpha)
    d_hat = delay_satisfaction_np(delay_np(inst), inst.u_delta, inst.delta_max)
    return 0.5 * (a_hat + d_hat) * eligibility_np(inst)


# ===========================================================================
# torch twins
# ===========================================================================

def qos_matrix_torch(ti: TorchInstance) -> torch.Tensor:
    """float32 twin of :func:`qos_matrix_np` over a :class:`TorchInstance`
    (the plain version the ``qos_matrix`` CUDA kernel is held against)."""
    from repro_torch.kernels.qos_matrix.ref import qos_matrix_ref

    return qos_matrix_ref(
        ti.u_alpha, ti.u_delta, ti.u_share_k, ti.u_share_w, ti.u_service,
        ti.sm_acc, ti.sm_k, ti.sm_w, ti.sm_service, delta_max=ti.delta_max)


def eligibility_torch(ti: TorchInstance) -> torch.Tensor:
    """[U, P] bool twin of :func:`eligibility_np`."""
    return ti.u_service[:, None] == ti.sm_service[None, :]
