"""repro_torch.workloads — instance evaluation on the device."""
from .batched import evaluate_host, evaluate_sparse

__all__ = ["evaluate_sparse", "evaluate_host"]
