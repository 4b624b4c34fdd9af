"""Dispatchers over the flash-attention forward (B4,
``csrc/flash_attention.cu``) and backward (B5 dQ and B6 dK/dV,
``csrc/flash_attention_bwd.cu``): the CUDA kernels for CUDA tensors, the
plain PyTorch versions (:mod:`.ref`) for tensors on the CPU.

``use_kernel=None`` follows the tensors' device, ``False`` runs the plain
versions wherever the tensors are, ``True`` insists on the kernels and
raises for CPU tensors. Each ``*_cuda`` wrapper checks device, dtype,
shape, alignment and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream, raises on a CUDA error
and adds one to its ``LAUNCHES`` entry. None falls back to a plain version.

A kernel's output has no autograd history, so under grad :func:`attention`
goes through :class:`FlashAttention`, whose forward is B4 with its lse and
whose backward is B5/B6 (the reference's ``make_trainable_attention``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import check_cuda_tensor, launch

from .ref import attention_ref, flash_attention_bwd_ref

__all__ = ["FlashAttention", "HEAD_DIMS", "LAUNCHES", "attention",
           "flash_attention_bwd", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "flash_attention_dkv_cuda",
           "flash_attention_dq_cuda", "make_trainable_attention",
           "reset_launch_counts"]

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_attention": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}
#: Head widths the kernel is compiled for.
HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_shapes(what: str, q: torch.Tensor, k: torch.Tensor) -> None:
    """Raise unless q/k have a dtype, head dim and grouping the kernels are
    compiled for."""
    hd, Hq, Hkv = q.shape[-1], q.shape[2], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} is not one of {_DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{what}: {Hq} query heads do not group over "
                         f"{Hkv} KV heads")


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
    _check_shapes("flash_attention", q, k)
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


def _bwd_pointers(what: str, q, k, v, do, lse, dsum) -> list:
    """Check the backward's inputs; their data pointers in launch order."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev, f32 = q.device, torch.float32
    _check_shapes(what, q, k)
    return [check_cuda_tensor("q", q, q.dtype, (B, Sq, Hq, hd), dev, 16),
            check_cuda_tensor("k", k, q.dtype, (B, Skv, Hkv, hd), dev, 16),
            check_cuda_tensor("v", v, q.dtype, (B, Skv, Hkv, hd), dev, 16),
            check_cuda_tensor("do", do, q.dtype, (B, Sq, Hq, hd), dev, 16),
            check_cuda_tensor("lse", lse, f32, (B, Hq, Sq), dev),
            check_cuda_tensor("dsum", dsum, f32, (B, Hq, Sq), dev)]


def _bwd_sizes(q, k, causal: bool, window: int) -> list:
    B, Sq, Hq, hd = q.shape
    return [B, Sq, k.shape[1], Hq, k.shape[2], hd,
            int(q.dtype == torch.bfloat16), int(causal), int(window)]


def flash_attention_dq_cuda(q, k, v, do, lse, dsum, *, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """B5 kernel: dQ ``[B, Sq, Hq, hd]`` in q's dtype. q/do ``[B, Sq, Hq,
    hd]``, k/v ``[B, Skv, Hkv, hd]`` (contiguous, one dtype), the forward's
    lse and ``dsum = rowsum(dO∘O)``, both ``[B, Hq, Sq]`` float32."""
    ptrs = _bwd_pointers("flash_attention_dq", q, k, v, do, lse, dsum)
    dq = torch.empty_like(q)
    if q.numel() and k.numel():
        launch("flash_attention_dq_launch", *ptrs, dq.data_ptr(),
               *_bwd_sizes(q, k, causal, window), device=q.device)
        LAUNCHES["flash_attention_dq"] += 1
    else:
        dq.zero_()
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, dsum, *, causal: bool = True,
                             window: int = 0):
    """B6 kernel: ``(dK, dV)``, each ``[B, Skv, Hkv, hd]`` in k's dtype,
    the G query heads of a group summed in the kernel. Inputs as
    :func:`flash_attention_dq_cuda`."""
    ptrs = _bwd_pointers("flash_attention_dkv", q, k, v, do, lse, dsum)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() and k.numel():
        launch("flash_attention_dkv_launch", *ptrs, dk.data_ptr(),
               dv.data_ptr(), *_bwd_sizes(q, k, causal, window),
               device=q.device)
        LAUNCHES["flash_attention_dkv"] += 1
    else:
        dk.zero_()
        dv.zero_()
    return dk, dv


def _dsum(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO∘O)`` in float32 as ``[B, Hq, Sq]`` (computed outside
    the kernels, as the reference computes it in jnp)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0):
    """B5 then B6 from the forward's ``o`` and ``lse`` and the upstream
    gradient ``do``. Returns ``(dq, dk, dv)``."""
    dsum = _dsum(o, do)
    kw = dict(causal=causal, window=window)
    dq = flash_attention_dq_cuda(q, k, v, do, lse, dsum, **kw)
    dk, dv = flash_attention_dkv_cuda(q, k, v, do, lse, dsum, **kw)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, use_kernel: Optional[bool] = None):
    """The backward's dispatcher: B5/B6 for CUDA tensors, the plain
    version for CPU tensors (``use_kernel`` as for :func:`attention`).
    Returns ``(dq, dk, dv)``."""
    if not (q.is_cuda if use_kernel is None else use_kernel):
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    return flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o.contiguous(),
                                    do.contiguous(), lse.contiguous(),
                                    causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention without a softcap: the forward is B4 with
    its lse and saves ``(q, k, v, o, lse)``; the backward is B5/B6 (the
    plain versions on the CPU or with ``use_kernel=False``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                use_kernel: Optional[bool]):
        if q.is_cuda if use_kernel is None else use_kernel:
            o, lse = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal=causal,
                                          window=window)
        else:
            o, lse = attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, use_kernel = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window, use_kernel=use_kernel)
        return dq, dk, dv, None, None, None


def make_trainable_attention(*, causal: bool = True, window: int = 0):
    """``attn(q, k, v)`` through :class:`FlashAttention`, kernels on CUDA
    tensors (the reference's ``make_trainable_attention``; like it, no
    softcap)."""
    def attn(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, None)
    return attn


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """GQA attention of a prefill: positions contiguous from 0, causal and
    sliding-window masks, tanh softcap. Returns ``[B, Sq, Hq, hd]``.

    Under grad (grad enabled and an input that requires it) it goes
    through :class:`FlashAttention`, and a softcap raises: its derivative
    is not ported, as in the reference's trainable attention."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if softcap:
            raise NotImplementedError(
                "attention: no backward for a softcap (the reference's "
                "trainable attention is softcap-free; ROADMAP A12)")
        return FlashAttention.apply(q, k, v, causal, window, use_kernel)
    if not (q.is_cuda if use_kernel is None else use_kernel):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                softcap=softcap)[0]
