"""GQA decode attention (B7): CUDA kernel, plain version, dispatcher."""
from .ops import (HEAD_DIMS, LAUNCHES, MAX_SPLITS, decode_attention,
                  decode_splits, gqa_decode_cuda, reset_launch_counts)
from .ref import decode_valid_mask, gqa_decode_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "MAX_SPLITS", "decode_attention",
           "decode_splits", "decode_valid_mask", "gqa_decode_cuda",
           "gqa_decode_ref", "reset_launch_counts"]
