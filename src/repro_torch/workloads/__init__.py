"""repro_torch.workloads — workload generators, scenarios, batched
evaluation.

Deterministic ``(seed, tick)``-seekable arrival processes and population
dynamics (NumPy on the host, byte-identical to :mod:`repro.workloads`)
compose into a registry of named scenarios (``steady``, ``diurnal``,
``flash_crowd``, ``mobility_churn``, ``edge_failure`` and three trace
replays), each yielding a sequence of
:class:`~repro_torch.core.instance.PIESInstance`\\ s; the batched engine
pads instance stacks to fixed shapes and evaluates them on the device
(the ``qos_matrix`` and ``greedy_argmax`` kernels on CUDA).
"""
from .arrivals import (
    ArrivalProcess,
    PoissonArrivals,
    MMPPArrivals,
    DiurnalArrivals,
    TraceArrivals,
)
from .population import (
    hash_uniform,
    ZipfPopularity,
    ChurnModel,
    MarkovMobility,
)
from .scenarios import (
    Scenario,
    register_scenario,
    get_scenario,
    list_scenarios,
    horizon,
)
from .batched import (
    PaddedBatch,
    BucketedBatch,
    pad_instances,
    bucket_envelope,
    bucket_indices,
    bucket_instances,
    single_evaluator,
    evaluate_batch,
    evaluate_sparse,
    evaluate_host,
    sweep,
)

__all__ = [
    "ArrivalProcess", "PoissonArrivals", "MMPPArrivals", "DiurnalArrivals",
    "TraceArrivals",
    "hash_uniform", "ZipfPopularity", "ChurnModel", "MarkovMobility",
    "Scenario", "register_scenario", "get_scenario", "list_scenarios",
    "horizon",
    "PaddedBatch", "BucketedBatch", "pad_instances", "bucket_envelope",
    "bucket_indices", "bucket_instances", "single_evaluator",
    "evaluate_batch", "evaluate_sparse", "evaluate_host", "sweep",
]
