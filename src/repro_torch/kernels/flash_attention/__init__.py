"""Flash attention: the forward (B4) and backward (B5 dQ, B6 dK/dV) CUDA
kernels, their plain versions, the dispatchers and the autograd Function."""
from .ops import (HEAD_DIMS, LAUNCHES, FlashAttention, attention,
                  flash_attention_bwd, flash_attention_bwd_cuda,
                  flash_attention_cuda, flash_attention_dkv_cuda,
                  flash_attention_dq_cuda, make_trainable_attention,
                  reset_launch_counts)
from .ref import attention_ref, flash_attention_bwd_ref

__all__ = ["FlashAttention", "HEAD_DIMS", "LAUNCHES", "attention",
           "attention_ref", "flash_attention_bwd", "flash_attention_bwd_cuda",
           "flash_attention_bwd_ref", "flash_attention_cuda",
           "flash_attention_dkv_cuda", "flash_attention_dq_cuda",
           "make_trainable_attention", "reset_launch_counts"]
