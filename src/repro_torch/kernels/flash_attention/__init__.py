"""Flash-attention forward (B4): CUDA kernel, plain version, dispatcher."""
from .ops import (HEAD_DIMS, LAUNCHES, attention, flash_attention_cuda,
                  reset_launch_counts)
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "attention", "attention_ref",
           "flash_attention_cuda", "reset_launch_counts"]
