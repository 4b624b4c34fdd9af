"""Dispatcher over GQA decode attention (B7): the CUDA kernel
(``csrc/gqa_decode.cu``) for CUDA tensors, the plain PyTorch version
(:mod:`.ref`) for tensors on the CPU.

``use_kernel=None`` follows the tensors' device, ``False`` runs the plain
version wherever the tensors are, ``True`` insists on the kernel and raises
for CPU tensors. :func:`gqa_decode_cuda` checks device, dtype, shape,
alignment and contiguity, allocates its output with ``torch.empty``,
picks the kernel's split count with :func:`decode_splits`, launches on the
current stream, raises on a CUDA error and adds one to
``LAUNCHES["gqa_decode"]``. It never falls back to the plain version.

Both take a block of a longer cache (``slot0``, ``sc_total``: a rank's
slots when the cache's sequence is split over a mesh) and can return the
float32 logsumexp beside the output (``return_lse``), which
:func:`~.ref.combine_blocks` reads to merge the blocks.

On fake tensors (the dry run's) :func:`gqa_decode_cuda` allocates its
outputs and records the kernel's :func:`gqa_decode_cost` instead of
launching (no launch counted). ``kv_len`` lives on the device and a fake
one holds no values, so the record takes every row's as the whole
cache's length: a full cache, as the dry run decodes at its last slot.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels._build import (KernelCost, check_cuda_tensor,
                                        is_fake, launch, on_card,
                                        record)

from .ref import gqa_decode_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "MAX_SPLITS", "decode_attention",
           "decode_slots", "decode_splits", "gqa_decode_cost",
           "gqa_decode_cuda", "reset_launch_counts"]

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"gqa_decode": 0}
#: Head widths the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 80, 128)
#: The most blocks over which the kernel splits one (KV head, row): the
#: portable thread block cluster size.
MAX_SPLITS = 8
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    LAUNCHES["gqa_decode"] = 0


def decode_splits(B: int, Hkv: int, Sc: int, sm_count: int) -> int:
    """S, the blocks of one cluster over which the kernel splits each (KV
    head, row)'s valid cache range: about two blocks an SM over the
    ``B * Hkv`` pairs, at most :data:`MAX_SPLITS`, and no more than one
    split per 64 cache slots. It reads host sizes only, never ``kv_len``,
    which lives on the device, so it never waits on the card."""
    return max(1, min(MAX_SPLITS, -(-Sc // 64),
                      -(-2 * sm_count // max(1, B * Hkv))))


def decode_slots(kv_len: Sequence[int], Sc: int, *, window: int = 0,
                 ring: bool = False, slot0: int = 0,
                 sc_total: Optional[int] = None) -> int:
    """Valid cache slots of the block ``slot0 .. slot0 + Sc - 1`` summed
    over the rows of ``kv_len`` (host ints), by
    :func:`~.ref.decode_valid_mask`'s rule: the slots the kernel reads."""
    total = Sc if sc_total is None else int(sc_total)
    out = 0
    for n in kv_len:
        if ring:
            lo, hi = 0, total if n > total else min(n, total)
        else:
            hi = min(n, total)
            lo = max(0, n - window) if window else 0
        out += max(0, min(hi, slot0 + Sc) - max(lo, slot0))
    return out


def gqa_decode_cost(B: int, Hkv: int, G: int, hd: int, itemsize: int,
                    slots: int, return_lse: bool = False) -> KernelCost:
    """B7's work over ``slots`` valid cache slots (:func:`decode_slots`):
    q read and the output written (``itemsize`` bytes an element), K and V
    of the valid slots read, kv_len read (and the float32 lse written);
    two products of 2·hd operations per slot and query head."""
    return KernelCost(
        flops=4 * hd * G * Hkv * slots,
        bytes=itemsize * (2 * B * Hkv * G * hd + 2 * slots * Hkv * hd)
        + 4 * B + (4 * B * Hkv * G if return_lse else 0))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gqa_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                    window: int = 0, ring: bool = False,
                    softcap: float = 0.0, slot0: int = 0,
                    sc_total: Optional[int] = None,
                    return_lse: bool = False):
    """B7 kernel. q ``[B, Hq, hd]``, k/v_cache ``[B, Sc, Hkv, hd]`` (one
    dtype, float32 or bfloat16; slots ``slot0 ..`` of a ``sc_total``-slot
    cache, by default the whole one), kv_len ``[B]`` int32, all contiguous
    on one CUDA device, ``hd`` in :data:`HEAD_DIMS`. Returns ``[B, Hq,
    hd]`` in q's dtype, and with ``return_lse`` the float32 ``[B, Hq]``
    logsumexp too."""
    B, Hq, hd = q.shape
    Sc, Hkv = k_cache.shape[1], k_cache.shape[2]
    total = Sc if sc_total is None else int(sc_total)
    if slot0 < 0 or total < slot0 + Sc:
        raise ValueError(f"gqa_decode: slots {slot0}..{slot0 + Sc - 1} are "
                         f"not a block of a {total}-slot cache")
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"gqa_decode: dtype {q.dtype} is not one of "
                        f"{_DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"gqa_decode: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"gqa_decode: {Hq} query heads do not group over "
                         f"{Hkv} KV heads")
    ptrs = [check_cuda_tensor("q", q, q.dtype, (B, Hq, hd), dev),
            check_cuda_tensor("k_cache", k_cache, q.dtype, (B, Sc, Hkv, hd),
                              dev, 16),
            check_cuda_tensor("v_cache", v_cache, q.dtype, (B, Sc, Hkv, hd),
                              dev, 16),
            check_cuda_tensor("kv_len", kv_len, torch.int32, (B,), dev)]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if q.numel() and is_fake(q):
        slots = decode_slots([total] * B, Sc, window=window, ring=ring,
                             slot0=slot0, sc_total=total)
        record("gqa_decode", gqa_decode_cost(B, Hkv, Hq // Hkv, hd,
                                             q.element_size(), slots,
                                             return_lse))
    elif q.numel():
        splits = decode_splits(B, Hkv, Sc, _sm_count(dev.index))
        launch("gqa_decode_launch", *ptrs, out.data_ptr(),
               0 if lse is None else lse.data_ptr(), B, Sc, Hkv, Hq // Hkv,
               hd, int(q.dtype == torch.bfloat16), int(window), int(ring),
               splits, int(slot0), total, float(softcap), device=dev)
        LAUNCHES["gqa_decode"] += 1
    return (out, lse) if return_lse else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: int = 0, ring: bool = False,
                     softcap: float = 0.0,
                     use_kernel: Optional[bool] = None, slot0: int = 0,
                     sc_total: Optional[int] = None,
                     return_lse: bool = False):
    """One query token per row against a KV cache (or its block of slots
    ``slot0 ..`` of a ``sc_total``-slot cache): ``kv_len`` valid slots per
    row, sliding window, ring buffer, softcap. Returns ``[B, Hq, hd]``,
    and with ``return_lse`` the float32 ``[B, Hq]`` logsumexp too."""
    kw = dict(window=window, ring=ring, softcap=softcap, slot0=slot0,
              sc_total=sc_total, return_lse=return_lse)
    if not (on_card(q) if use_kernel is None else use_kernel):
        return gqa_decode_ref(q, k_cache, v_cache, kv_len, **kw)
    return gqa_decode_cuda(q.contiguous(), k_cache.contiguous(),
                           v_cache.contiguous(),
                           kv_len.to(torch.int32).contiguous(), **kw)
