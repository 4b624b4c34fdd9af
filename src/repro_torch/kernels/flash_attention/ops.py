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
On fake tensors (the dry run's) a wrapper allocates its outputs and
records its kernel's :class:`~repro_torch.kernels._build.KernelCost`
(:func:`flash_attention_cost`, :func:`flash_attention_bwd_cost`: the
work over the visible (query, key) pairs, the masked blocks it skips not
counted) instead of launching; it counts no launch.

A kernel's output has no autograd history, so under grad :func:`attention`
goes through :class:`FlashAttention`, whose forward is B4 with its lse and
whose backward is B5/B6, a softcap's derivative included (the reference
differentiates its model attention ``flash_attention_jnp`` with JAX).
:class:`AttentionStash` keeps a forward's output and lse across a
rematerialised layer's backward (``remat_policy="save_attn"``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels._build import (KernelCost, check_cuda_tensor,
                                        is_fake, launch, on_card,
                                        record)

from .ref import attention_ref, flash_attention_bwd_ref

__all__ = ["AttentionStash", "BWD_HEAD_DIMS", "FlashAttention", "HEAD_DIMS",
           "LAUNCHES", "attention", "flash_attention_bwd",
           "flash_attention_bwd_cost", "flash_attention_bwd_cuda",
           "flash_attention_cost", "flash_attention_cuda",
           "flash_attention_dkv_cuda", "flash_attention_dq_cuda",
           "make_trainable_attention", "reset_launch_counts",
           "visible_pairs"]

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_attention": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}
#: Head widths the forward kernel (B4) is compiled for.
HEAD_DIMS = (16, 32, 64, 80, 128)
#: Head widths the backward kernels (B5, B6) are compiled for.
BWD_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a prefill attends (positions from 0, the causal
    and sliding-window masks): the work its data needs."""
    q = np.arange(Sq)
    hi = np.minimum(Skv, q + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                         hd: int, itemsize: int, causal: bool = True,
                         window: int = 0) -> KernelCost:
    """B4's work: q, k and v read once, the output (``itemsize`` bytes an
    element) and the float32 lse written once; two products of 2·hd
    operations per visible pair and query head."""
    return KernelCost(
        flops=4 * hd * B * Hq * visible_pairs(Sq, Skv, causal, window),
        bytes=itemsize * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd)
        + 4 * B * Hq * Sq)


def flash_attention_bwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                             hd: int, itemsize: int, causal: bool = True,
                             window: int = 0) -> Dict[str, KernelCost]:
    """B5's and B6's work, by kernel: each input read once, each output
    written once (lse and dsum float32); 2·hd operations per visible
    (query, key) pair and product, three products for dQ (S, dP, dS·k),
    four for dK/dV (S, dP, Pᵀ·dO, dSᵀ·q)."""
    pairs = B * Hq * visible_pairs(Sq, Skv, causal, window)
    q_side, kv_side, rows = B * Sq * Hq * hd, B * Skv * Hkv * hd, B * Hq * Sq
    return {"flash_attention_dq": KernelCost(
                6 * hd * pairs,
                itemsize * (3 * q_side + 2 * kv_side) + 8 * rows),
            "flash_attention_dkv": KernelCost(
                8 * hd * pairs,
                itemsize * (2 * q_side + 4 * kv_side) + 8 * rows)}


def _check_shapes(what: str, q: torch.Tensor, k: torch.Tensor,
                  head_dims=HEAD_DIMS) -> None:
    """Raise unless q/k have a dtype, head dim (one of ``head_dims``) and
    grouping the kernel is compiled for."""
    hd, Hq, Hkv = q.shape[-1], q.shape[2], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} is not one of {_DTYPES}")
    if hd not in head_dims:
        raise ValueError(f"{what}: head dim {hd} is not one of "
                         f"{head_dims}")
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
    if q.numel() and is_fake(q):
        record("flash_attention", flash_attention_cost(
            B, Sq, Skv, Hq, Hkv, hd, q.element_size(), causal, window))
    elif q.numel():
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
    _check_shapes(what, q, k, BWD_HEAD_DIMS)
    return [check_cuda_tensor("q", q, q.dtype, (B, Sq, Hq, hd), dev, 16),
            check_cuda_tensor("k", k, q.dtype, (B, Skv, Hkv, hd), dev, 16),
            check_cuda_tensor("v", v, q.dtype, (B, Skv, Hkv, hd), dev, 16),
            check_cuda_tensor("do", do, q.dtype, (B, Sq, Hq, hd), dev, 16),
            check_cuda_tensor("lse", lse, f32, (B, Hq, Sq), dev),
            check_cuda_tensor("dsum", dsum, f32, (B, Hq, Sq), dev)]


def _bwd_cost(q, k, causal: bool, window: int) -> Dict[str, KernelCost]:
    B, Sq, Hq, hd = q.shape
    return flash_attention_bwd_cost(B, Sq, k.shape[1], Hq, k.shape[2], hd,
                                    q.element_size(), causal, window)


def _bwd_sizes(q, k, causal: bool, window: int, softcap: float) -> list:
    B, Sq, Hq, hd = q.shape
    return [B, Sq, k.shape[1], Hq, k.shape[2], hd,
            int(q.dtype == torch.bfloat16), int(causal), int(window),
            float(softcap)]


def flash_attention_dq_cuda(q, k, v, do, lse, dsum, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0
                            ) -> torch.Tensor:
    """B5 kernel: dQ ``[B, Sq, Hq, hd]`` in q's dtype. q/do ``[B, Sq, Hq,
    hd]``, k/v ``[B, Skv, Hkv, hd]`` (contiguous, one dtype), the forward's
    lse and ``dsum = rowsum(dO∘O)``, both ``[B, Hq, Sq]`` float32; the
    forward's ``softcap`` (0: none)."""
    ptrs = _bwd_pointers("flash_attention_dq", q, k, v, do, lse, dsum)
    dq = torch.empty_like(q)
    if q.numel() and k.numel() and is_fake(q):
        record("flash_attention_dq", _bwd_cost(q, k, causal, window)[
            "flash_attention_dq"])
    elif q.numel() and k.numel():
        launch("flash_attention_dq_launch", *ptrs, dq.data_ptr(),
               *_bwd_sizes(q, k, causal, window, softcap), device=q.device)
        LAUNCHES["flash_attention_dq"] += 1
    else:
        dq.zero_()
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, dsum, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """B6 kernel: ``(dK, dV)``, each ``[B, Skv, Hkv, hd]`` in k's dtype,
    the G query heads of a group summed in the kernel. Inputs as
    :func:`flash_attention_dq_cuda`."""
    ptrs = _bwd_pointers("flash_attention_dkv", q, k, v, do, lse, dsum)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() and k.numel() and is_fake(q):
        record("flash_attention_dkv", _bwd_cost(q, k, causal, window)[
            "flash_attention_dkv"])
    elif q.numel() and k.numel():
        launch("flash_attention_dkv_launch", *ptrs, dk.data_ptr(),
               dv.data_ptr(), *_bwd_sizes(q, k, causal, window, softcap),
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
                             window: int = 0, softcap: float = 0.0):
    """B5 then B6 from the forward's ``o`` and ``lse`` and the upstream
    gradient ``do``. Returns ``(dq, dk, dv)``."""
    dsum = _dsum(o, do)
    kw = dict(causal=causal, window=window, softcap=softcap)
    dq = flash_attention_dq_cuda(q, k, v, do, lse, dsum, **kw)
    dk, dv = flash_attention_dkv_cuda(q, k, v, do, lse, dsum, **kw)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        use_kernel: Optional[bool] = None):
    """The backward's dispatcher: B5/B6 for CUDA tensors, the plain
    version for CPU tensors (``use_kernel`` as for :func:`attention`).
    Returns ``(dq, dk, dv)``."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if not (on_card(q) if use_kernel is None else use_kernel):
        return flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    return flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o.contiguous(),
                                    do.contiguous(), lse.contiguous(), **kw)


class AttentionStash:
    """What ``remat_policy="save_attn"`` keeps of one rematerialised layer:
    its :class:`FlashAttention` forward's output and lse (``kept``).

    The layer's first run records them; its recompute in the backward
    takes them back instead of running the forward again, so B4 runs once
    per attention layer per step and everything else in the layer is
    recomputed. One stash serves one attention call of one layer's run.
    The reference saves the same tensor, named ``attn_out``, with
    ``save_only_these_names``; torch's selective checkpoint policies see
    only aten operations, and B4 is a ctypes launch."""

    def __init__(self):
        self.kept = None


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward is B4 with its lse (or, with
    a sealed :class:`AttentionStash`, the output and lse it recorded) and
    saves ``(q, k, v, o, lse)``; the backward is B5/B6 with the softcap's
    derivative (the plain versions on the CPU or with
    ``use_kernel=False``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float,
                use_kernel: Optional[bool],
                stash: Optional[AttentionStash] = None):
        if stash is not None and stash.kept is not None:
            o, lse = stash.kept
            o = o.view_as(o)        # this graph's output, not the record
        elif on_card(q) if use_kernel is None else use_kernel:
            o, lse = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal=causal,
                                          window=window, softcap=softcap)
        else:
            o, lse = attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
        if stash is not None and stash.kept is None:
            stash.kept = (o.detach(), lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, softcap, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap, use_kernel = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window, softcap=softcap,
                                         use_kernel=use_kernel)
        return dq, dk, dv, None, None, None, None, None


def make_trainable_attention(*, causal: bool = True, window: int = 0):
    """``attn(q, k, v)`` through :class:`FlashAttention`, kernels on CUDA
    tensors (the reference's ``make_trainable_attention``; like it, no
    softcap)."""
    def attn(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, 0.0, None)
    return attn


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              use_kernel: Optional[bool] = None,
              stash: Optional[AttentionStash] = None) -> torch.Tensor:
    """GQA attention of a prefill: positions contiguous from 0, causal and
    sliding-window masks, tanh softcap. Returns ``[B, Sq, Hq, hd]``.

    Under grad (grad enabled and an input that requires it) it goes
    through :class:`FlashAttention`, recording into or replaying from
    ``stash`` where one is given."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    use_kernel, stash)
    if not (on_card(q) if use_kernel is None else use_kernel):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                softcap=softcap)[0]
