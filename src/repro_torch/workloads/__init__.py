"""repro_torch.workloads — instance evaluation on the device."""
from .batched import (BucketedBatch, PaddedBatch, bucket_envelope,
                      bucket_indices, bucket_instances, evaluate_batch,
                      evaluate_host, evaluate_sparse, pad_instances,
                      single_evaluator)

__all__ = ["PaddedBatch", "BucketedBatch", "pad_instances",
           "bucket_envelope", "bucket_indices", "bucket_instances",
           "single_evaluator", "evaluate_batch", "evaluate_sparse",
           "evaluate_host"]
