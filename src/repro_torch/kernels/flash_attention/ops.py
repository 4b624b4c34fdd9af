"""Dispatcher over the flash-attention forward (B4): the CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors, the plain PyTorch version
(:mod:`.ref`) for tensors on the CPU.

``use_kernel=None`` follows the tensors' device, ``False`` runs the plain
version wherever the tensors are, ``True`` insists on the kernel and raises
for CPU tensors. :func:`flash_attention_cuda` checks device, dtype, shape,
alignment and contiguity, allocates its outputs with ``torch.empty``,
launches on the current stream, raises on a CUDA error and adds one to
``LAUNCHES["flash_attention"]``. It never falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import check_cuda_tensor, launch

from .ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "attention", "flash_attention_cuda",
           "reset_launch_counts"]

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_attention": 0}
#: Head widths the kernel is compiled for.
HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """B4 kernel. q ``[B, Sq, Hq, hd]``, k/v ``[B, Skv, Hkv, hd]``, all
    contiguous, one dtype (float32 or bfloat16), ``hd`` in
    :data:`HEAD_DIMS`, ``Hq % Hkv == 0``. Returns ``(out [B, Sq, Hq, hd]``
    in q's dtype``, lse [B, Hq, Sq] float32)``."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not one of "
                        f"{_DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads do not group "
                         f"over {Hkv} KV heads")
    ptrs = [check_cuda_tensor("q", q, q.dtype, (B, Sq, Hq, hd), dev, 16),
            check_cuda_tensor("k", k, q.dtype, (B, Skv, Hkv, hd), dev, 16),
            check_cuda_tensor("v", v, q.dtype, (B, Skv, Hkv, hd), dev, 16)]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    if q.numel():
        launch("flash_attention_launch", *ptrs, out.data_ptr(),
               lse.data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
               int(q.dtype == torch.bfloat16), int(causal), int(window),
               float(softcap), device=dev)
        LAUNCHES["flash_attention"] += 1
    return out, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """GQA attention of a prefill: positions contiguous from 0, causal and
    sliding-window masks, tanh softcap. Returns ``[B, Sq, Hq, hd]``."""
    if not (q.is_cuda if use_kernel is None else use_kernel):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                softcap=softcap)[0]
