"""repro_torch.analysis — the per-rank cost of a traced step
(:mod:`~repro_torch.analysis.step_cost`), the counterpart of the
reference's HLO cost walker."""
from .step_cost import COLLECTIVES, StepCost, tensors_of, trace_step

__all__ = ["COLLECTIVES", "StepCost", "tensors_of", "trace_step"]
