"""Plain PyTorch version of GQA decode attention (B7).

One query token per row against a ``[B, Sc, Hkv, hd]`` cache, full softmax
in float32. The validity mask is the model layer's: slot ``idx`` is valid
when ``idx < Sc`` and ``idx < kv_len`` (ring mode: or once ``kv_len > Sc``,
every slot), and, outside ring mode, ``idx > kv_len - 1 - window`` for a
sliding window. A row with no valid slot gives zeros.
"""
from __future__ import annotations

import math

import torch

__all__ = ["decode_valid_mask", "gqa_decode_ref"]

NEG = -1e30
SAFE = -1e20


def decode_valid_mask(kv_len: torch.Tensor, Sc: int, *, window: int = 0,
                      ring: bool = False) -> torch.Tensor:
    """``[B, Sc]`` bool: which cache slots row b attends."""
    idx = torch.arange(Sc, device=kv_len.device)[None, :]
    n = kv_len.to(torch.int64)[:, None]
    if ring:
        return (idx < n) | (n > Sc)
    ok = idx < n
    if window:
        ok &= idx > n - 1 - window
    return ok


def gqa_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                   window: int = 0, ring: bool = False,
                   softcap: float = 0.0) -> torch.Tensor:
    """q: ``[B, Hq, hd]``; k/v_cache: ``[B, Sc, Hkv, hd]``; kv_len: ``[B]``
    integer. Returns ``[B, Hq, hd]`` in q's dtype."""
    B, Hq, hd = q.shape
    Sc, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = decode_valid_mask(kv_len, Sc, window=window, ring=ring)
    s = torch.where(ok[:, None, None, :], s,
                    torch.full((), NEG, device=q.device))
    m = s.amax(-1, keepdim=True).clamp_min(SAFE)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, Hq, hd).to(q.dtype)
