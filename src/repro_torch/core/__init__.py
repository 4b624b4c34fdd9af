"""repro_torch.core — the PIES problem on the host (NumPy oracles) and on
the device (torch twins of the JAX reference's jnp functions)."""
from .instance import (
    REALWORLD_CATALOG,
    PIESInstance,
    TorchInstance,
    draw_edge_capacities,
    draw_service_catalog,
    realworld_instance,
    synthetic_instance,
    tiny_instance,
)
from .qos import (
    eligibility_np,
    eligibility_torch,
    qos_matrix_np,
    qos_matrix_torch,
)
from .scheduling import (oms_np, oms_torch, schedule_value_np, sigma_np,
                         sigma_torch, sigma_user_np)
from .candidates import (
    CandidateSet,
    impl_table_np,
    max_impls_of,
    sigma_sparse_np,
    topk_candidates_np,
    topk_candidates_torch,
)
from .placement import (
    FEASIBILITY_TOL,
    agp_literal_np,
    agp_np,
    agp_place_torch,
    egp_np,
    egp_place_sparse_torch,
    egp_place_torch,
    place_and_schedule,
    rnd_np,
    sck_np,
    sigma_sparse_torch,
    sigma_upper_bound_np,
)
from .opt import brute_force_np, opt_edge_np, opt_np
from .dynamic import DynamicPlacer, evaluate_horizon

__all__ = [
    "PIESInstance", "TorchInstance", "synthetic_instance",
    "realworld_instance", "tiny_instance", "REALWORLD_CATALOG",
    "draw_edge_capacities", "draw_service_catalog",
    "qos_matrix_np", "qos_matrix_torch", "eligibility_np",
    "eligibility_torch",
    "oms_np", "oms_torch", "sigma_np", "sigma_torch", "sigma_user_np",
    "schedule_value_np",
    "CandidateSet", "impl_table_np", "max_impls_of", "topk_candidates_np",
    "topk_candidates_torch", "sigma_sparse_np",
    "FEASIBILITY_TOL", "egp_np", "agp_np", "agp_literal_np", "sck_np",
    "rnd_np", "sigma_upper_bound_np", "place_and_schedule",
    "egp_place_torch", "agp_place_torch", "egp_place_sparse_torch",
    "sigma_sparse_torch",
    "opt_np", "opt_edge_np", "brute_force_np",
    "DynamicPlacer", "evaluate_horizon",
]
