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
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels._build import check_cuda_tensor, launch

from .ref import gqa_decode_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "MAX_SPLITS", "decode_attention",
           "decode_splits", "gqa_decode_cuda", "reset_launch_counts"]

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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gqa_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                    window: int = 0, ring: bool = False,
                    softcap: float = 0.0) -> torch.Tensor:
    """B7 kernel. q ``[B, Hq, hd]``, k/v_cache ``[B, Sc, Hkv, hd]`` (one
    dtype, float32 or bfloat16), kv_len ``[B]`` int32, all contiguous on
    one CUDA device, ``hd`` in :data:`HEAD_DIMS`. Returns ``[B, Hq, hd]``
    in q's dtype."""
    B, Hq, hd = q.shape
    Sc, Hkv = k_cache.shape[1], k_cache.shape[2]
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
    if q.numel():
        splits = decode_splits(B, Hkv, Sc, _sm_count(dev.index))
        launch("gqa_decode_launch", *ptrs, out.data_ptr(), B, Sc, Hkv,
               Hq // Hkv, hd, int(q.dtype == torch.bfloat16), int(window),
               int(ring), splits, float(softcap), device=dev)
        LAUNCHES["gqa_decode"] += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: int = 0, ring: bool = False,
                     softcap: float = 0.0,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """One query token per row against a KV cache: ``kv_len`` valid slots
    per row, sliding window, ring buffer, softcap. Returns
    ``[B, Hq, hd]``."""
    if not (q.is_cuda if use_kernel is None else use_kernel):
        return gqa_decode_ref(q, k_cache, v_cache, kv_len, window=window,
                              ring=ring, softcap=softcap)
    return gqa_decode_cuda(q.contiguous(), k_cache.contiguous(),
                           v_cache.contiguous(),
                           kv_len.to(torch.int32).contiguous(),
                           window=window, ring=ring, softcap=softcap)
