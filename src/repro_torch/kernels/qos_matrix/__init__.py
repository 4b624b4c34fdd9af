"""QoS-matrix, segmented-QoS and greedy-argmax kernels (B1–B3)."""
from .ops import (LAUNCHES, check_service_ids, greedy_argmax,
                  greedy_argmax_cuda, qos_candidates,
                  qos_candidates_cuda, qos_candidates_from_instance,
                  qos_matrix, qos_matrix_cuda, qos_matrix_from_instance,
                  reset_launch_counts)
from .ref import greedy_argmax_ref, qos_candidates_ref, qos_matrix_ref

__all__ = [
    "LAUNCHES", "reset_launch_counts", "check_service_ids",
    "qos_matrix", "qos_candidates", "greedy_argmax",
    "qos_matrix_cuda", "qos_candidates_cuda", "greedy_argmax_cuda",
    "qos_matrix_from_instance", "qos_candidates_from_instance",
    "qos_matrix_ref", "qos_candidates_ref", "greedy_argmax_ref",
]
